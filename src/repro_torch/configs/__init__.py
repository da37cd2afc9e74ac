"""Architecture registry: ``--arch <id>`` -> ArchDef (all ten of the
reference's)."""
from repro_torch.configs import (dcn_v2, gat_cora, gatedgcn, meshgraphnet,
                                minicpm3_4b, nequip, phi35_moe, qwen2_moe,
                                qwen3_1_7b, qwen3_32b)
from repro_torch.configs.common import (ArchDef, FAMILY_SHAPES, GNN_SHAPES,
                                        LM_SHAPES, RECSYS_SHAPES, shapes_for)

ARCHS = {m.ARCH.name: m.ARCH for m in (
    qwen3_1_7b, minicpm3_4b, qwen3_32b, phi35_moe, qwen2_moe,
    gat_cora, meshgraphnet, gatedgcn, nequip, dcn_v2)}


def get(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every assigned (arch, shape) pair — 40 cells, in the reference's
    order."""
    return [(a.name, s) for a in ARCHS.values()
            for s in shapes_for(a.family)]
