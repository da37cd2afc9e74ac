"""phi3.5-moe-42b-a6.6b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.common import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_full():
    moe = MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400)
    return TransformerConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=6400, vocab=32064,
        attn_type="gqa", qk_norm=False, moe=moe)


def make_smoke():
    # capacity 8x: the smoke tests compare decode with the full forward, so
    # no token may drop (GShard's drops depend on the batch's composition)
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                    capacity_factor=8.0)
    return TransformerConfig(
        name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=512,
        attn_type="gqa", moe=moe, dtype="float32", remat=False,
        chunk_q=64, chunk_k=64)


ARCH = ArchDef(name="phi3.5-moe-42b-a6.6b", family="lm", make_full=make_full,
               make_smoke=make_smoke, notes="16-expert top-2 MoE LM")
