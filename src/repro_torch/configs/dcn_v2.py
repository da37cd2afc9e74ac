"""dcn-v2 [recsys] n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross.  [arXiv:2008.13535; paper]

Embedding tables default to 1M rows per field (criteo-class); the lookup is
the hot path.  On a mesh the tables are row-sharded over the model axis,
as in the reference (``models/recsys_mesh.py``)."""
from repro_torch.configs.common import ArchDef
from repro_torch.models.recsys import DCNv2Config


def make_full():
    return DCNv2Config(n_dense=13, n_sparse=26, embed_dim=16,
                       vocab_sizes=tuple([1_000_000] * 26),
                       n_cross_layers=3, mlp_dims=(1024, 1024, 512),
                       cross_rank=0, max_hots=1)


def make_smoke():
    return DCNv2Config(n_dense=13, n_sparse=6, embed_dim=8,
                       vocab_sizes=tuple([1000] * 6),
                       n_cross_layers=2, mlp_dims=(32, 16), max_hots=2)


ARCH = ArchDef(name="dcn-v2", family="recsys", make_full=make_full,
               make_smoke=make_smoke,
               notes="deep&cross v2 CTR ranker with EmbeddingBag substrate")
