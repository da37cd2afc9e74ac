"""gatedgcn [gnn] n_layers=16 d_hidden=70 aggregator=gated.
[arXiv:2003.00982; paper]"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.gnn import GatedGCNConfig


def make_full(d_in: int = 1433, n_classes: int = 7):
    return GatedGCNConfig(n_layers=16, d_hidden=70, d_in=d_in,
                          d_out=n_classes)


def make_smoke():
    return GatedGCNConfig(n_layers=2, d_hidden=8, d_in=16, d_out=3)


ARCH = ArchDef(name="gatedgcn", family="gnn", make_full=make_full,
               make_smoke=make_smoke, notes="edge-gated graph convolution",
               extras={"model": "gatedgcn"})
