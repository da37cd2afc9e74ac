"""Transformer building blocks: RMSNorm, RoPE (on the fly), GQA attention
with optional qk-norm, the plain blockwise-softmax attention with its
custom-backward form (``flash_bwd``), single-token decode attention,
SwiGLU, embedding and cross entropy.

Port of ``src/repro/models/layers.py``.  Params are nested dicts of
tensors — or ``ParamTree`` modules, which index the same way — in the
reference's layout: a dense weight is ``(d_in, d_out)`` and applied as
``x @ w``.  Init functions take a ``torch.Generator``.

Two attention routes.  Training (``gqa_attend(..., training=True)``, the
route ``transformer.forward`` takes) is ``chunked_attention`` on every
device, plain torch with autograd, or with ``flash_bwd`` the FA-2 two-pass
backward of ``FlashAttention``: the reference trains in jnp and has no
backward kernel.  Serving (prefill) is the hand-written forward kernel
through ``kernels.ops.attention`` on a CUDA tensor and ``chunked_attention``
on a CPU tensor; the kernel refuses inputs that require grad under grad
mode, so a gradient is never cut silently.  Decode attention is plain torch
on every device, as in the reference (outside any Pallas kernel), and B5
has no per-row cache-length mask.  On a mesh (``models/spmd.py``) decode
attention over a sequence-sharded cache is the flash-decoding schedule:
``decode_partial`` a shard, one gather, ``merge_partials``.
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
    # torch.full, not torch.tensor: a host value copied to a CUDA device
    # synchronizes the stream
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = positions[..., None].float() * freqs              # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def _visible(q0: int, rows: int, k0: int, causal: bool, q_offset) -> bool:
    """Whether any of query rows q0 .. q0 + rows - 1 sees key k0 (a tile
    that no row sees adds p = 0 with alpha = 1: skipping it changes no
    bit, since key 0 is visible to every row and the running max is finite
    from the first tile on)."""
    return not causal or k0 <= q0 + rows - 1 + q_offset


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      chunk_q: int = 1024, chunk_k: int = 1024,
                      flash_bwd: bool = False):
    """Blockwise-softmax attention in plain torch: the reference's function,
    tile for tile (running max / sum, scores and P.V in float32, p cast to
    v's type before P.V, hidden scores -1e30).

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D).  q_offset: absolute position
    of q[..., 0] minus that of k[..., 0] (decode: Lk - Lq).  K / V are
    repeated to Hq heads first, as the reference's default ``repeat_kv``.
    With ``flash_bwd`` and tiles that divide Lq and Lk (the reference's
    condition) the custom-backward ``FlashAttention`` computes it: it saves
    only (q, k, v, out, lse) and recomputes the tiles in its backward.
    Otherwise autograd runs through the tiles.  The reference pads a ragged
    last tile with masked rows / keys; here the tile is cut short, which
    gives the same values.  Tiles above the causal diagonal are skipped
    (``_visible``).
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(D)
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    cq, ck = min(chunk_q, Lq), min(chunk_k, Lk)
    if flash_bwd and Lq % cq == 0 and Lk % ck == 0:
        return FlashAttention.apply(q, k, v, causal, int(q_offset), cq, ck)
    return _fa_fwd_chunked(q, k, v, causal, q_offset, cq, ck, scale)[0]


# --------------------------------------------------------------------------
# chunked attention with the flash backward (the reference's custom VJP)
#
# Autograd through the tiles saves every tile's probabilities: O(L^2)
# residuals a layer.  ``FlashAttention`` saves (q, k, v, out, lse), O(L),
# and recomputes the tiles in its backward (FlashAttention-2 schedule):
# pass 1 accumulates dQ over the kv blocks of each q block, pass 2 dK / dV
# over the q blocks of each kv block.  Plain torch, as the reference's jnp.
# --------------------------------------------------------------------------

def _scores(qb, kb, q0: int, k0: int, causal: bool, q_offset: int, scale):
    """One tile's scaled float32 scores, hidden ones -1e30."""
    s = torch.einsum("bhqd,bhkd->bhqk", qb.float(), kb.float()) * scale
    if causal:
        rows = torch.arange(q0, q0 + qb.shape[2], device=qb.device)
        cols = torch.arange(k0, k0 + kb.shape[2], device=qb.device)
        s = torch.where(cols[None, :] <= rows[:, None] + q_offset, s, MASKED)
    return s


def _fa_fwd_chunked(q, k, v, causal: bool, q_offset: int, cq: int, ck: int,
                    scale):
    """Forward tiles returning (out in q's type, lse float32 (B, H, Lq));
    all heads = Hq.  A ragged last tile is cut short."""
    Lq, Lk = q.shape[2], k.shape[2]
    outs, lses = [], []
    for q0 in range(0, Lq, cq):
        # one float32 copy a query block: under autograd its gradient then
        # sums over the key tiles in float32 and is rounded to q's type once
        qb = q[:, :, q0:q0 + cq].float()
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:3], MASKED, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Lk, ck):
            if not _visible(q0, qb.shape[2], k0, causal, q_offset):
                break
            kb, vb = k[:, :, k0:k0 + ck], v[:, :, k0:k0 + ck]
            s = _scores(qb, kb, q0, k0, causal, q_offset, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        l = l.clamp(min=1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


class FlashAttention(torch.autograd.Function):
    """``chunked_attention`` with the FA-2 backward (the reference's
    ``_make_flash_attention(causal, q_offset, cq, ck)``): q, k, v of Hq
    heads each, tiles that divide.  Saves only (q, k, v, out, lse).  Its
    backward follows the reference: ``Drow = sum(do * out)`` in float32,
    ``p = exp(s - lse)``, ``ds = p * (do . v - Drow)``; dQ accumulates
    ``ds' . k`` over the kv blocks, dK ``ds' . q`` and dV ``p' . do`` over
    the q blocks (``'``: cast to the other operand's type), all in float32;
    the scale multiplies dQ and dK after accumulation; each result is cast
    to its input's type."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, cq: int,
                ck: int):
        scale = 1.0 / np.sqrt(q.shape[-1])
        out, lse = _fa_fwd_chunked(q, k, v, causal, q_offset, cq, ck, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, cq, ck, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, cq, ck, scale = ctx.args
        Lq, Lk = q.shape[2], k.shape[2]
        drow = (do.float() * out.float()).sum(-1)

        def tile(q0, k0):
            qb, kb = q[:, :, q0:q0 + cq], k[:, :, k0:k0 + ck]
            p = torch.exp(_scores(qb, kb, q0, k0, causal, q_offset, scale)
                          - lse[:, :, q0:q0 + cq, None])
            dob = do[:, :, q0:q0 + cq]
            dp = torch.einsum("bhqd,bhkd->bhqk", dob.float(),
                              v[:, :, k0:k0 + ck].float())
            return p, dp - drow[:, :, q0:q0 + cq, None], qb, kb, dob

        # pass 1: dQ, over the kv blocks of each q block
        dqs = []
        for q0 in range(0, Lq, cq):
            dq = torch.zeros(q[:, :, q0:q0 + cq].shape, dtype=torch.float32,
                             device=q.device)
            for k0 in range(0, Lk, ck):
                if not _visible(q0, cq, k0, causal, q_offset):
                    break
                p, dpd, _, kb, _ = tile(q0, k0)
                ds = p * dpd
                dq = dq + torch.einsum("bhqk,bhkd->bhqd",
                                       ds.to(kb.dtype).float(), kb.float())
            dqs.append(dq * scale)
        # pass 2: dK and dV, over the q blocks of each kv block
        dks, dvs = [], []
        for k0 in range(0, Lk, ck):
            dk = torch.zeros(k[:, :, k0:k0 + ck].shape, dtype=torch.float32,
                             device=k.device)
            dv = torch.zeros_like(dk)
            for q0 in range(0, Lq, cq):
                if not _visible(q0, cq, k0, causal, q_offset):
                    continue
                p, dpd, qb, _, dob = tile(q0, k0)
                dv = dv + torch.einsum("bhqk,bhqd->bhkd",
                                       p.to(dob.dtype).float(), dob.float())
                ds = p * dpd
                dk = dk + torch.einsum("bhqk,bhqd->bhkd",
                                       ds.to(qb.dtype).float(), qb.float())
            dks.append(dk * scale)
            dvs.append(dv)
        return (torch.cat(dqs, dim=2).to(q.dtype),
                torch.cat(dks, dim=2).to(k.dtype),
                torch.cat(dvs, dim=2).to(v.dtype), None, None, None, None)


def decode_attention(q, k, v, length=None, seq_axis=None,
                     extra_slot: bool = True):
    """Single-token decode: q (B, Hq, 1, D) vs cache k, v (B, Hkv, S, D).

    Plain softmax over the cache, scores and P.V in float32.  ``length``
    (B,) hides cache slots >= length; with ``extra_slot`` the last slot
    (the appended current token) stays visible, without it (the
    write-then-attend decode, whose ``length`` already counts the step's
    own slot) it is hidden like the rest.  GQA is computed in the grouped
    form (B, Hkv, G, ...), the same values as the reference's repeated
    K / V.

    ``seq_axis`` names the mesh axes a sequence-sharded cache is split over
    (the flash-decoding schedule): q, k, v and length are then
    ``core.mesh.Sharded`` values, one block a mesh position, q and length
    the same across a group of ``seq_axis`` and k / v that group's
    consecutive sequence blocks.  Each shard computes its block's running
    max, sum and P.V in float32 (``decode_partial``); one gather over the
    axis merges them by log-sum-exp (``merge_partials``).  Returns a
    ``Sharded`` output, the same across each group.
    """
    if seq_axis is not None:
        return _decode_attention_sharded(q, k, v, length, seq_axis,
                                         extra_slot)
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if length is not None:
        s = torch.where(_visible_slots(length, 0, S, S, extra_slot), s,
                        MASKED)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)


def _visible_slots(length, start: int, n: int, S: int, extra_slot: bool):
    """(B, 1, 1, n) mask of cache slots start .. start + n - 1 of S that a
    decode step sees."""
    idx = torch.arange(start, start + n, device=length.device)[
        None, None, None, :]
    mask = idx < length[:, None, None, None]
    return (mask | (idx == S - 1)) if extra_slot else mask


def decode_partial(q, k, v, length, start: int, S: int, extra_slot: bool):
    """One sequence block's share of ``decode_attention``: q (B, Hq, 1, D)
    against k / v (B, Hkv, n, D), the cache slots start .. start + n - 1
    of S.  Returns (B, Hkv, G, D + 2) float32: the block's max score, its
    sum of exp(s - max), and its P.V (p cast to v's type first, as the
    plain version casts its probabilities)."""
    B, Hq, _, D = q.shape
    Hkv, n = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * (1.0 / np.sqrt(D))
    if length is not None:
        s = torch.where(_visible_slots(length, start, n, S, extra_slot), s,
                        MASKED)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return torch.cat([m[..., None], p.sum(-1)[..., None], acc], dim=-1)


def merge_partials(parts, dtype):
    """Blocks' ``decode_partial``s stacked on axis 0 -> the attention
    output (B, Hq, 1, D) in ``dtype``: a log-sum-exp merge in float32 (a
    block whose slots are all hidden has weight exp(-1e30 - max) = 0)."""
    m, l, acc = parts[..., 0], parts[..., 1], parts[..., 2:]
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    o = (w[..., None] * acc).sum(0) / (w * l).sum(0)[..., None]
    B, Hkv, G, D = o.shape
    return o.reshape(B, Hkv * G, 1, D).to(dtype)


def _decode_attention_sharded(q, k, v, length, seq_axis, extra_slot):
    from repro_torch.core.mesh import Sharded, all_gather_groups
    mesh = k.mesh
    n_blocks = len(mesh.groups(seq_axis)[0])
    parts = []
    for pos in range(mesh.size):
        kb = k.blocks[pos]
        n = kb.shape[2]
        parts.append(decode_partial(
            q.blocks[pos], kb, v.blocks[pos],
            None if length is None else length.blocks[pos],
            mesh.group_index(pos, seq_axis) * n, n * n_blocks, extra_slot))
    return Sharded(mesh, tuple(
        merge_partials(g, q.blocks[pos].dtype) for pos, g in
        enumerate(all_gather_groups(mesh, seq_axis, parts))))


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
    return gqa_heads(params, cfg, x @ params["wq"], x @ params["wk"],
                     x @ params["wv"], positions)


def gqa_heads(params, cfg: AttnConfig, q, k, v, positions):
    """The projections' outputs q (B, L, Hq·Dh), k / v (B, L, Hkv·Dh) — all
    heads, or a shard's whole heads — as roped (B, H, L, Dh) heads, q and k
    qk-normed first when the config says so."""
    B, L, _ = q.shape
    Dh = cfg.head_dim
    q = q.reshape(B, L, -1, Dh)
    k = k.reshape(B, L, -1, Dh)
    v = v.reshape(B, L, -1, Dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def gqa_attend(params, cfg: AttnConfig, x, positions, *, causal=True,
               kv_cache=None, cache_length=None, chunk_q=1024, chunk_k=1024,
               training: bool = False, flash_bwd: bool = False):
    """Returns (out (B, L, d), new_kv) — new_kv is (k, v) to append.

    kv_cache: fixed-capacity (k, v) of shape (B, Hkv, S, Dh); cache_length
    (B,) marks valid entries.  The current step's k / v are appended
    virtually (concat) so the token attends to itself without a prior cache
    write.  Without a cache the attention is, with ``training``,
    ``chunked_attention(..., flash_bwd=flash_bwd)`` on every device (the
    route gradients go through), else ``prefill_attention``: the kernel on
    CUDA tensors.
    """
    B, L, _ = x.shape
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    if training:
        if kv_cache is not None:
            raise ValueError("the training route has no KV cache")
        o = chunked_attention(q, k, v, causal=causal, chunk_q=chunk_q,
                              chunk_k=chunk_k, flash_bwd=flash_bwd)
    elif kv_cache is not None:
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


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token NLL over the labels that are not ``ignore_id``: float32
    logits, ``logsumexp``, the label's logit gathered at ``labels`` clipped
    at 0, the sum divided by max(count, 1) (the reference's function)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.long().clamp(min=0)[..., None]
    ll = torch.take_along_dim(logits, idx, dim=-1)[..., 0]
    mask = labels != ignore_id
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1)
