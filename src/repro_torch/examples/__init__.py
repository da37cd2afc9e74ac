"""The reference's four ``examples/`` scripts as the port's quickstarts:
``quickstart`` (colouring through ``api.color``, the service, the sharded
engine), ``serve_lm`` (continuous batching), ``train_lm`` (the LM training
loop) and ``color_then_train_gnn`` (a colouring used as a scatter schedule,
a GatedGCN trained on the mesh).  Each runs as ``python -m
repro_torch.examples.<name>`` on the card (``--device cpu`` for the plain
path) and has ``main(argv) -> dict`` of the values it prints."""
