"""qwen3-1.7b [dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.transformer import TransformerConfig


def make_full():
    return TransformerConfig(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, head_dim=128, d_ff=6144, vocab=151936,
        attn_type="gqa", qk_norm=True, rope_theta=1_000_000.0)


def make_smoke():
    return TransformerConfig(
        name="qwen3-1.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        attn_type="gqa", qk_norm=True, dtype="float32", remat=False,
        chunk_q=64, chunk_k=64)


ARCH = ArchDef(name="qwen3-1.7b", family="lm", make_full=make_full,
               make_smoke=make_smoke, notes="GQA + qk_norm dense LM")
