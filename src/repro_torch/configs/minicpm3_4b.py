"""minicpm3-4b [dense] 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.mla import MLAConfig
from repro_torch.models.transformer import TransformerConfig


def make_full():
    mla = MLAConfig(d_model=2560, n_heads=40, q_lora_rank=768,
                    kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
                    v_head_dim=64, rope_theta=10_000.0)
    return TransformerConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, head_dim=64, d_ff=6400, vocab=73448,
        attn_type="mla", mla=mla)


def make_smoke():
    mla = MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
    return TransformerConfig(
        name="minicpm3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=8, d_ff=128, vocab=512,
        attn_type="mla", mla=mla, dtype="float32", remat=False,
        chunk_q=64, chunk_k=64)


ARCH = ArchDef(name="minicpm3-4b", family="lm", make_full=make_full,
               make_smoke=make_smoke,
               notes="MLA (latent-compressed KV) dense LM")
