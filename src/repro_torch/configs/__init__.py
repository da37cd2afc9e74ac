"""Architecture registry: ``--arch <id>`` -> ArchDef.

Only the ported architectures are here.  The reference's others raise
``KeyError`` naming the ROADMAP item that ports them: there is no silent
stand-in."""
from repro_torch.configs import (dcn_v2, gat_cora, gatedgcn, meshgraphnet,
                                nequip, qwen3_1_7b, qwen3_32b)
from repro_torch.configs.common import (ArchDef, FAMILY_SHAPES, GNN_SHAPES,
                                        LM_SHAPES, RECSYS_SHAPES, shapes_for)

ARCHS = {m.ARCH.name: m.ARCH for m in (qwen3_1_7b, qwen3_32b, gat_cora,
                                       meshgraphnet, gatedgcn, nequip,
                                       dcn_v2)}

# the reference's architectures that the port does not have yet, with the
# ROADMAP item that ports each
NOT_PORTED = {
    "minicpm3-4b": "ROADMAP queue A.5.4: MoE and MLA with their configs",
    "phi3.5-moe-42b-a6.6b": "ROADMAP queue A.5.4: MoE and MLA with "
                            "their configs",
    "qwen2-moe-a2.7b": "ROADMAP queue A.5.4: MoE and MLA with their configs",
}


def get(name: str) -> ArchDef:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet ({NOT_PORTED[name]}"
                       f"); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
