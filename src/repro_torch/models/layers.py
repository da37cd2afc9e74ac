"""Transformer building blocks of the serving path: RMSNorm, RoPE (on the
fly), GQA attention with optional qk-norm, the plain blockwise-softmax
attention, single-token decode attention, SwiGLU, embedding.

Port of ``src/repro/models/layers.py`` (the parts serving needs; the custom-
VJP flash backward and ``cross_entropy`` are training and not ported).
Params are nested dicts of tensors — or ``ParamTree`` modules, which index
the same way — in the reference's layout: a dense weight is ``(d_in,
d_out)`` and applied as ``x @ w``.  Init functions take a
``torch.Generator``.

On a CUDA tensor, the prefill attention of ``gqa_attend`` is the
hand-written kernel through ``kernels.ops.attention``; on a CPU tensor it is
``chunked_attention``, the reference's plain function.  Decode attention is
plain torch on every device, as in the reference (outside any Pallas
kernel), and B5 has no per-row cache-length mask.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

MASKED = -1e30          # the reference's hidden score


def _init_dense(generator, d_in, d_out, dtype=torch.float32, device=None):
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / np.sqrt(d_in))).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm_init(d, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * params["scale"]).to(dt)


# --------------------------------------------------------------------------
# RoPE, computed on the fly from position ids
# --------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (..., L, D) with D even; positions: (..., L) int."""
    D = x.shape[-1]
    half = D // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].float() * freqs              # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      chunk_q: int = 1024, chunk_k: int = 1024):
    """Blockwise-softmax attention in plain torch: the reference's function,
    tile for tile (running max / sum, scores and P.V in float32, p cast to
    v's type before P.V, hidden scores -1e30).

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D).  q_offset: absolute position
    of q[..., 0] minus that of k[..., 0] (decode: Lk - Lq).  The reference
    pads a ragged last tile with masked rows / keys; here the tile is cut
    short, which gives the same values.  (The reference's ``repeat_kv`` and
    ``flash_bwd`` pick a sharding layout and a training backward; the values
    do not depend on them, and the port has neither.)
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(D)
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    cq, ck = min(chunk_q, Lq), min(chunk_k, Lk)
    out = torch.empty((B, Hq, Lq, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, Lq, cq):
        qb = q[:, :, q0:q0 + cq].float()
        rows = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:3], MASKED, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Lk, ck):
            kb, vb = k[:, :, k0:k0 + ck], v[:, :, k0:k0 + ck]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb.float()) * scale
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                ok = cols[None, :] <= rows[:, None] + q_offset
                s = torch.where(ok, s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out[:, :, q0:q0 + cq] = acc / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


def decode_attention(q, k, v, length=None):
    """Single-token decode: q (B, Hq, 1, D) vs cache k, v (B, Hkv, S, D).

    Plain softmax over the cache, scores and P.V in float32.  ``length``
    (B,) hides cache slots >= length except the last one (the appended
    current token).  GQA is computed in the grouped form (B, Hkv, G, ...),
    the same values as the reference's repeated K / V.  The reference's
    ``seq_axis`` (a mesh schedule) and ``extra_slot=False`` (its
    write-then-attend decode) are not ported.
    """
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if length is not None:
        idx = torch.arange(S, device=q.device)[None, None, None, :]
        ln = length[:, None, None, None]
        s = torch.where((idx < ln) | (idx == S - 1), s, MASKED)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)


def prefill_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_k: int):
    """Attention of the Lq queries at the end of Lk keys (causal offset
    Lk - Lq): on CUDA tensors the hand-written kernel (``ops.attention``,
    which launches it or raises; it reads the (B, L, H, D)-ordered views of
    the projections as they are), on CPU tensors ``chunked_attention``."""
    if q.device.type == "cuda":
        return ops.attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal,
                             q_offset=k.shape[2] - q.shape[2],
                             chunk_q=chunk_q, chunk_k=chunk_k)


# --------------------------------------------------------------------------
# GQA attention layer (qwen3 style) with optional qk-norm
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0


def gqa_init(generator, cfg: AttnConfig, dtype=torch.bfloat16, device=None):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = dict(generator=generator, dtype=dtype, device=device)
    p = {"wq": _init_dense(d_in=d, d_out=H * Dh, **g),
         "wk": _init_dense(d_in=d, d_out=Hkv * Dh, **g),
         "wv": _init_dense(d_in=d, d_out=Hkv * Dh, **g),
         "wo": _init_dense(d_in=H * Dh, d_out=d, **g)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, device)
        p["k_norm"] = rmsnorm_init(Dh, device)
    return p


def gqa_project_qkv(params, cfg: AttnConfig, x, positions):
    """x: (B, L, d) -> q (B, H, L, Dh), k / v (B, Hkv, L, Dh), roped."""
    B, L, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, L, H, Dh)
    k = (x @ params["wk"]).reshape(B, L, Hkv, Dh)
    v = (x @ params["wv"]).reshape(B, L, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def gqa_attend(params, cfg: AttnConfig, x, positions, *, causal=True,
               kv_cache=None, cache_length=None, chunk_q=1024, chunk_k=1024):
    """Returns (out (B, L, d), new_kv) — new_kv is (k, v) to append.

    kv_cache: fixed-capacity (k, v) of shape (B, Hkv, S, Dh); cache_length
    (B,) marks valid entries.  The current step's k / v are appended
    virtually (concat) so the token attends to itself without a prior cache
    write.  Without a cache (prefill) the attention is ``prefill_attention``:
    the kernel on CUDA tensors.
    """
    B, L, _ = x.shape
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    if kv_cache is not None:
        ck, cv = kv_cache
        S = ck.shape[2]
        k_full = torch.cat([ck, k], dim=2)
        v_full = torch.cat([cv, v], dim=2)
        if L == 1:
            eff_len = (cache_length if cache_length is not None
                       else torch.full((B,), S, dtype=torch.int32,
                                       device=x.device))
            o = decode_attention(q, k_full, v_full, length=eff_len)
        else:
            o = prefill_attention(q, k_full, v_full, causal=causal,
                                  chunk_q=chunk_q, chunk_k=chunk_k)
    else:
        o = prefill_attention(q, k, v, causal=causal, chunk_q=chunk_q,
                              chunk_k=chunk_k)
    o = o.transpose(1, 2).reshape(B, L, cfg.n_heads * cfg.head_dim)
    return o @ params["wo"], (k, v)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def swiglu_init(generator, d_model, d_ff, dtype=torch.bfloat16, device=None):
    g = dict(generator=generator, dtype=dtype, device=device)
    return {"w_gate": _init_dense(d_in=d_model, d_out=d_ff, **g),
            "w_up": _init_dense(d_in=d_model, d_out=d_ff, **g),
            "w_down": _init_dense(d_in=d_ff, d_out=d_model, **g)}


def swiglu(params, x):
    return (torch.nn.functional.silu(x @ params["w_gate"])
            * (x @ params["w_up"])) @ params["w_down"]


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------

def embedding_init(generator, vocab, d_model, dtype=torch.bfloat16,
                   device=None):
    t = torch.randn((vocab, d_model), generator=generator,
                    dtype=torch.float32, device=device)
    return {"table": (t * 0.02).to(dtype)}


def embed(params, tokens):
    return params["table"][tokens.long()]


def unembed(params, x):
    """Tied unembedding: (B, L, d) @ (d, vocab)."""
    return x @ params["table"].T.to(x.dtype)
