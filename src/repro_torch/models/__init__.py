"""The model stack of the port: the dense GQA transformer that serves and
trains (``transformer.py`` on the building blocks of ``layers.py``), the
GNNs that train (``gnn.py``: GAT, MeshGraphNet, GatedGCN and its halo
form), NequIP (``equivariant.py``) and DCN-v2 (``recsys.py``).  The
reference's MLA and MoE layers are not ported yet (ROADMAP queue A.5.4)."""
