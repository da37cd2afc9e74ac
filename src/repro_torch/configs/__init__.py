"""Architecture registry: ``--arch <id>`` -> ArchDef.

Only the ported architectures are here.  The reference's others raise
``KeyError`` naming the ROADMAP item that ports them: there is no silent
stand-in."""
from repro_torch.configs import qwen3_1_7b
from repro_torch.configs.common import (ArchDef, FAMILY_SHAPES, GNN_SHAPES,
                                        LM_SHAPES, RECSYS_SHAPES, shapes_for)

ARCHS = {m.ARCH.name: m.ARCH for m in (qwen3_1_7b,)}

# the reference's architectures that the port does not have yet
NOT_PORTED = ("minicpm3-4b", "qwen3-32b", "phi3.5-moe-42b-a6.6b",
              "qwen2-moe-a2.7b", "gat-cora", "meshgraphnet", "gatedgcn",
              "nequip", "dcn-v2")


def get(name: str) -> ArchDef:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP queue "
                       f"A.5); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
