"""The model stack of the port: the dense GQA transformer that serving runs
(``transformer.py`` on the building blocks of ``layers.py``).  The
reference's other models (MLA, MoE, GNNs, equivariant, recsys) are not
ported yet (ROADMAP queue A.5)."""
