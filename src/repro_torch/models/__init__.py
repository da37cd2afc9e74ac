"""The model stack of the port: the LM that serves and trains
(``transformer.py`` on the building blocks of ``layers.py``: dense GQA,
MLA (``mla.py``) and MoE (``moe.py``) layers), the GNNs that train
(``gnn.py``: GAT, MeshGraphNet, GatedGCN and its halo form), NequIP
(``equivariant.py``) and DCN-v2 (``recsys.py``): every model module of the
reference."""
