"""gat-cora [gnn] n_layers=2 d_hidden=8 n_heads=8 aggregator=attn.
[arXiv:1710.10903; paper]  Feature/class dims come from each shape."""
from repro_torch.configs.common import ArchDef
from repro_torch.models.gnn import GATConfig


def make_full(d_in: int = 1433, n_classes: int = 7):
    return GATConfig(n_layers=2, d_hidden=8, n_heads=8, d_in=d_in,
                     n_classes=n_classes)


def make_smoke():
    return GATConfig(n_layers=2, d_hidden=4, n_heads=2, d_in=16, n_classes=3)


ARCH = ArchDef(name="gat-cora", family="gnn", make_full=make_full,
               make_smoke=make_smoke, notes="graph attention (SDDMM+softmax)",
               extras={"model": "gat"})
