"""qwen2-moe-a2.7b [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts are padded to 64, as in the reference (padding experts are
masked out of routing — they receive no tokens and no probability mass).
"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_full():
    moe = MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4,
                    d_ff_shared=5632, n_experts_padded=64)
    return TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1408, vocab=151936,
        attn_type="gqa", qk_norm=False, moe=moe)


def make_smoke():
    moe = MoEConfig(n_experts=6, top_k=2, d_ff_expert=32, n_shared=2,
                    d_ff_shared=64, n_experts_padded=8,
                    capacity_factor=8.0)   # no drops: decode vs forward
    return TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab=512,
        attn_type="gqa", moe=moe, dtype="float32", remat=False,
        chunk_q=64, chunk_k=64)


ARCH = ArchDef(name="qwen2-moe-a2.7b", family="lm", make_full=make_full,
               make_smoke=make_smoke,
               notes="60-routed(top-4)+4-shared-expert MoE LM")
