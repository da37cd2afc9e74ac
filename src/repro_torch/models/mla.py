"""Multi-head Latent Attention (MLA, DeepSeek-V2 / MiniCPM3).

Port of ``src/repro/models/mla.py``.  Queries and keys / values are
low-rank compressed; the decode cache keeps only the ``kv_lora_rank +
qk_rope_dim`` latent a token.  Decode uses the absorbed form (the query
projected into latent space, attention over the compressed cache, in plain
torch on every device, as the reference's jnp); prefill and training
materialise per-head K / V of head dim ``qk_nope_dim + qk_rope_dim`` and
pad V up to it, so one attention call serves both.  That call is, as in
``layers.gqa_attend``, ``chunked_attention`` (with ``flash_bwd``) on the
training route and ``prefill_attention`` (the attention kernel on CUDA
tensors) when serving.

The reference's types are kept step by step: decode scores in float32,
``p`` cast to the cache's type before the value product, ``o_c`` cast to
``x``'s type before ``w_uv``, the scale ``1/sqrt(dn + dr)`` taken in
float32.  ``prewritten`` is the reference's write-then-attend decode.
``seq_axis`` (its sequence-sharded decode) raises: MLA under a mesh is not
ported yet (ROADMAP A.7.3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.layers import (MASKED, _init_dense, rmsnorm,
                                       rmsnorm_init, rope)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64
    rope_theta: float = 10000.0


def mla_init(generator, cfg: MLAConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    g = dict(generator=generator, dtype=dtype, device=device)
    return {"w_dq": _init_dense(d_in=d, d_out=r_q, **g),
            "q_norm": rmsnorm_init(r_q, device),
            "w_uq": _init_dense(d_in=r_q, d_out=H * (dn + dr), **g),
            "w_dkv": _init_dense(d_in=d, d_out=r_kv, **g),
            "kv_norm": rmsnorm_init(r_kv, device),
            "w_uk": _init_dense(d_in=r_kv, d_out=H * dn, **g),
            "w_uv": _init_dense(d_in=r_kv, d_out=H * dv, **g),
            "w_kr": _init_dense(d_in=d, d_out=dr, **g),
            "w_o": _init_dense(d_in=H * dv, d_out=d, **g)}


def mla_latents(params, cfg: MLAConfig, x, positions):
    """The latents a token caches: (c_kv (B, L, r), k_rope (B, L, dr))."""
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"])
    k_r = rope(x @ params["w_kr"], positions, cfg.rope_theta)
    return c_kv, k_r


def _queries(params, cfg: MLAConfig, x, positions):
    """(q_nope (B, H, L, dn), q_rope (B, H, L, dr)), roped at (B, H, L, dr)
    with positions (B, 1, L)."""
    B, L, _ = x.shape
    H, dn = cfg.n_heads, cfg.qk_nope_dim
    c_q = rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (c_q @ params["w_uq"]).reshape(B, L, H, dn + cfg.qk_rope_dim)
    q_n, q_r = q[..., :dn], q[..., dn:]
    q_r = rope(q_r.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    return q_n.transpose(1, 2), q_r


def mla_attend_prefill(params, cfg: MLAConfig, x, positions, *, causal=True,
                       chunk_q=1024, chunk_k=1024, training: bool = False,
                       flash_bwd: bool = False):
    """The materialised path of training and prefill.  Returns (out (B, L,
    d), (c_kv, k_rope)).  With ``training``, ``chunked_attention(...,
    flash_bwd=flash_bwd)`` on every device; else ``prefill_attention``,
    the attention kernel on CUDA tensors (both looked up in ``layers`` at
    call time, as ``gqa_attend``'s are)."""
    B, L, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_n, q_r = _queries(params, cfg, x, positions)
    c_kv, k_r = mla_latents(params, cfg, x, positions)
    k_n = (c_kv @ params["w_uk"]).reshape(B, L, H, dn).transpose(1, 2)
    v = (c_kv @ params["w_uv"]).reshape(B, L, H, dv).transpose(1, 2)
    # nope + rope a head, the shared k_rope broadcast over the heads
    q = torch.cat([q_n, q_r], dim=-1)
    k = torch.cat([k_n, k_r[:, None].expand(B, H, L, dr)], dim=-1)
    # v padded to the q / k head dim so that one call serves (sliced after)
    vp = torch.nn.functional.pad(v, (0, dn + dr - dv))
    if training:
        o = layers.chunked_attention(q, k, vp, causal=causal,
                                     chunk_q=chunk_q, chunk_k=chunk_k,
                                     flash_bwd=flash_bwd)
    else:
        o = layers.prefill_attention(q, k, vp, causal=causal,
                                     chunk_q=chunk_q, chunk_k=chunk_k)
    o = o[..., :dv].transpose(1, 2).reshape(B, L, H * dv)
    return o @ params["w_o"], (c_kv, k_r)


def mla_attend_decode(params, cfg: MLAConfig, x, positions, cache, length,
                      prewritten: bool = False, seq_axis=None):
    """Absorbed decode: x (B, 1, d) against the latent cache (c_kv (B, S,
    r), k_rope (B, S, dr)); ``length`` (B,) valid entries.  Returns (out
    (B, 1, d), (c_new (B, 1, r), kr_new (B, 1, dr))).

    ``prewritten``: the caller already wrote this step's latents into the
    cache (write-then-attend; ``length`` counts them), so nothing is
    appended and the new latents come back as (None, None).  ``seq_axis``
    (a sequence-sharded cache) raises: MLA under a mesh is ROADMAP A.7.3."""
    if seq_axis is not None:
        raise NotImplementedError(
            f"mla_attend_decode(seq_axis={seq_axis!r}): MLA under a mesh is "
            f"not ported yet (ROADMAP A.7.3)")
    B = x.shape[0]
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    c_cache, kr_cache = cache
    S = c_cache.shape[1]
    q_n, q_r = _queries(params, cfg, x, positions)   # (B,H,1,dn), (B,H,1,dr)
    # W_uk absorbed into the query: q_c[h] = q_n[h] @ W_uk[h]^T, latent space
    w_uk = params["w_uk"].reshape(r, H, dn)
    q_c = torch.einsum("bhd,rhd->bhr", q_n[:, :, 0], w_uk)   # (B, H, r)
    if prewritten:
        c_new = kr_new = None
        c_all, kr_all, S_eff = c_cache, kr_cache, S
    else:
        # this step's latent, appended virtually: the token sees itself
        # without a cache write first
        c_new, kr_new = mla_latents(params, cfg, x, positions)
        c_all = torch.cat([c_cache, c_new.to(c_cache.dtype)], dim=1)
        kr_all = torch.cat([kr_cache, kr_new.to(kr_cache.dtype)], dim=1)
        S_eff = S + 1
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))
    s = (torch.einsum("bhr,bsr->bhs", q_c.float(), c_all.float())
         + torch.einsum("bhd,bsd->bhs", q_r[:, :, 0].float(),
                        kr_all.float())) * scale
    idx = torch.arange(S_eff, device=x.device)[None, None, :]
    mask = idx < length[:, None, None]
    if not prewritten:
        mask = mask | (idx == S)
    p = torch.softmax(torch.where(mask, s, MASKED), dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p.to(c_all.dtype).float(),
                       c_all.float())                         # (B, H, r)
    w_uv = params["w_uv"].reshape(r, H, dv)
    o = torch.einsum("bhr,rhd->bhd", o_c.to(x.dtype), w_uv)
    return o.reshape(B, 1, H * dv) @ params["w_o"], (c_new, kr_new)
