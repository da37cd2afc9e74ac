"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2.
[arXiv:2010.03409]  Edge features are synthesized (d_edge_in=4) for shapes
without native edge attributes."""
from repro_torch.configs.common import ArchDef
from repro_torch.models.gnn import MGNConfig


def make_full(d_in: int = 1433, n_classes: int = 7):
    return MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2, d_in=d_in,
                     d_edge_in=4, d_out=n_classes)


def make_smoke():
    return MGNConfig(n_layers=2, d_hidden=16, mlp_layers=2, d_in=8,
                     d_edge_in=4, d_out=3)


ARCH = ArchDef(name="meshgraphnet", family="gnn", make_full=make_full,
               make_smoke=make_smoke,
               notes="encode-process-decode mesh GNN with edge state",
               extras={"model": "mgn"})
