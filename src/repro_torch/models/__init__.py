"""The model stack of the port: the dense GQA transformer that serving runs
(``transformer.py`` on the building blocks of ``layers.py``) and the GNNs
that train (``gnn.py``: GAT, MeshGraphNet, GatedGCN and its halo form).
The reference's other models (MLA, MoE, equivariant, recsys) are not
ported yet (ROADMAP queue A.5)."""
