"""qwen3-32b [dense] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.transformer import TransformerConfig


def make_full():
    return TransformerConfig(
        name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64,
        n_kv_heads=8, head_dim=80, d_ff=25600, vocab=151936,
        attn_type="gqa", qk_norm=True, rope_theta=1_000_000.0)


def make_smoke():
    return TransformerConfig(
        name="qwen3-32b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
        attn_type="gqa", qk_norm=True, dtype="float32", remat=False,
        chunk_q=64, chunk_k=64)


ARCH = ArchDef(name="qwen3-32b", family="lm", make_full=make_full,
               make_smoke=make_smoke, notes="large dense GQA + qk_norm LM")
