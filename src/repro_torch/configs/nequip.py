"""nequip [gnn] n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5
equivariance=E(3)-tensor-product.  [arXiv:2101.03164; paper]

Non-molecular shapes (cora-like / ogb) feed node features as l=0 scalars via
``d_scalar_in``; positions are synthesized (DESIGN.md §6)."""
from repro_torch.configs.common import ArchDef
from repro_torch.models.equivariant import NequIPConfig


def make_full(d_in: int = 0, n_classes: int = 0):
    return NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8,
                        cutoff=5.0, n_species=16, d_scalar_in=d_in)


def make_smoke():
    return NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4, cutoff=5.0,
                        n_species=4)


ARCH = ArchDef(name="nequip", family="gnn", make_full=make_full,
               make_smoke=make_smoke,
               notes="E(3)-equivariant tensor-product potential",
               extras={"model": "nequip"})
