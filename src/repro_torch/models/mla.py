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

``seq_axis`` is the reference's sequence-sharded decode: the latent cache
is held as ``core.mesh.Sharded`` blocks.  Each shard scores its block
(``decode_scores``); one gather of the blocks' max and sum of exponentials
(``score_stats``) gives every shard the softmax's global max and sum by
log-sum-exp (``merge_stats``); each shard then takes its block's share of
``o_c`` with the probabilities normalised first and cast to the cache's
type, as the reference casts them (``decode_values``), and one ``psum``
adds the shares, before ``w_uv`` and ``w_o``.  Normalising before the
cast keeps the reference's rounding: casting each block's unnormalised
``exp(s - block max)`` instead (the flash-decoding form) rounds other
values, and on ``minicpm3-4b``'s 62 bfloat16 layers that alone moved the
logits by 0.24-0.34 on an H100 (``PERF.md`` §5).  The sharded LM
(``models/spmd.py``) uses the same pieces on column-split weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
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
    c_q = rmsnorm(params["q_norm"], x @ params["w_dq"])
    return head_queries(cfg, c_q, params["w_uq"], positions)


def head_queries(cfg: MLAConfig, c_q, w_uq, positions):
    """The queries of the heads whose columns ``w_uq`` (r_q, h·(dn + dr))
    holds, from the normed latent ``c_q`` (B, L, r_q): (q_nope (B, h, L,
    dn), q_rope (B, h, L, dr))."""
    B, L, _ = c_q.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (c_q @ w_uq).reshape(B, L, -1, dn + dr)
    q_n, q_r = q[..., :dn], q[..., dn:]
    q_r = rope(q_r.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    return q_n.transpose(1, 2), q_r


def head_qkv(cfg: MLAConfig, q_n, q_r, c_kv, k_r, w_uk, w_uv):
    """The materialised attention inputs of the heads whose columns ``w_uk``
    / ``w_uv`` hold: q, k (B, h, L, dn + dr), the shared ``k_r`` broadcast
    over the heads, and v zero-padded to dn + dr, so that one attention
    call serves (its output sliced to dv after)."""
    B, L, _ = c_kv.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_n = (c_kv @ w_uk).reshape(B, L, -1, dn).transpose(1, 2)
    v = (c_kv @ w_uv).reshape(B, L, -1, dv).transpose(1, 2)
    H = k_n.shape[1]
    q = torch.cat([q_n, q_r], dim=-1)
    k = torch.cat([k_n, k_r[:, None].expand(B, H, L, dr)], dim=-1)
    return q, k, torch.nn.functional.pad(v, (0, dn + dr - dv))


def mla_attend_prefill(params, cfg: MLAConfig, x, positions, *, causal=True,
                       chunk_q=1024, chunk_k=1024, training: bool = False,
                       flash_bwd: bool = False):
    """The materialised path of training and prefill.  Returns (out (B, L,
    d), (c_kv, k_rope)).  With ``training``, ``chunked_attention(...,
    flash_bwd=flash_bwd)`` on every device; else ``prefill_attention``,
    the attention kernel on CUDA tensors (both looked up in ``layers`` at
    call time, as ``gqa_attend``'s are)."""
    B, L, _ = x.shape
    H, dv = cfg.n_heads, cfg.v_head_dim
    q_n, q_r = _queries(params, cfg, x, positions)
    c_kv, k_r = mla_latents(params, cfg, x, positions)
    q, k, vp = head_qkv(cfg, q_n, q_r, c_kv, k_r, params["w_uk"],
                        params["w_uv"])
    if training:
        o = layers.chunked_attention(q, k, vp, causal=causal,
                                     chunk_q=chunk_q, chunk_k=chunk_k,
                                     flash_bwd=flash_bwd)
    else:
        o = layers.prefill_attention(q, k, vp, causal=causal,
                                     chunk_q=chunk_q, chunk_k=chunk_k)
    o = o[..., :dv].transpose(1, 2).reshape(B, L, H * dv)
    return o @ params["w_o"], (c_kv, k_r)


def absorbed_query(cfg: MLAConfig, q_n, q_r, w_uk):
    """The decode query in latent space for the heads whose columns ``w_uk``
    (r, h·dn) holds: (q_c (B, h, r), q_r (B, h, dr)), from ``head_queries``'
    one-token output: ``q_c[h] = q_n[h] @ W_uk[h]ᵀ`` in the queries' type."""
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_dim
    w = w_uk.reshape(r, -1, dn)
    return torch.einsum("bhd,rhd->bhr", q_n[:, :, 0], w), q_r[:, :, 0]


def _scale(cfg: MLAConfig) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(cfg.qk_nope_dim
                                                       + cfg.qk_rope_dim)))


def decode_scores(cfg: MLAConfig, q_c, q_r, c, kr, length, start: int):
    """One sequence block's float32 scores: q_c (B, H, r) / q_r (B, H, dr)
    against the latents c (B, n, r) / kr (B, n, dr) of cache slots start ..
    start + n - 1, those at or past ``length`` (B,) hidden (None: every slot
    seen).  (B, H, n)."""
    n = c.shape[1]
    s = (torch.einsum("bhr,bsr->bhs", q_c.float(), c.float())
         + torch.einsum("bhd,bsd->bhs", q_r.float(), kr.float())) * \
        _scale(cfg)
    if length is not None:
        idx = torch.arange(start, start + n, device=c.device)[None, None, :]
        s = torch.where(idx < length[:, None, None], s, MASKED)
    return s


def score_stats(s):
    """A block's (B, H, 2): its max score and its sum of exp(s - max)."""
    m = s.amax(dim=-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1)], -1)


def merge_stats(stats) -> tuple:
    """Blocks' ``score_stats`` stacked on axis 0 -> the softmax's global max
    and sum (B, H), by log-sum-exp (a block whose slots are all hidden has
    weight exp(-1e30 - max) = 0)."""
    m = stats[..., 0]
    top = m.amax(dim=0)
    return top, (stats[..., 1] * torch.exp(m - top)).sum(0)


def decode_values(s, top, total, c):
    """A block's share of ``o_c`` (B, H, r) float32: the softmax's
    probabilities of its slots, normalised by the global max and sum and
    cast to the cache's type as the reference casts them, times its
    latents."""
    p = torch.exp(s - top[..., None]) / total[..., None]
    return torch.einsum("bhs,bsr->bhr", p.to(c.dtype).float(), c.float())


def sharded_o_c(cfg: MLAConfig, mesh, seq_axis, queries: list,
                blocks: list, lengths: list, starts: list,
                new=None) -> list:
    """Per mesh position ``o_c`` (B, H, r) float32 of the absorbed decode
    over sequence blocks: ``queries[pos]`` its (q_c, q_r) of every head,
    ``blocks[pos]`` its latents (c, kr) of slots ``starts[pos]`` on, with
    ``lengths[pos]`` (B,) visible.  One gather of the blocks'
    ``score_stats`` over ``seq_axis`` gives the softmax's global max and
    sum, each block's probabilities are normalised and cast as the
    reference casts them, and one ``psum`` adds the blocks' shares.
    ``new[pos]``: the step's own latents (c, kr) in the cache's type, one
    more block counted once, or None (write-then-attend)."""
    from repro_torch.core.mesh import all_gather_groups, psum
    scores = [decode_scores(cfg, *q, *b, n, s0)
              for q, b, n, s0 in zip(queries, blocks, lengths, starts)]
    own = None if new is None else [decode_scores(cfg, *q, *nw, None, 0)
                                    for q, nw in zip(queries, new)]
    tops = []
    for pos, g in enumerate(all_gather_groups(
            mesh, seq_axis, [score_stats(s) for s in scores])):
        if own is not None:
            g = torch.cat([g, score_stats(own[pos])[None]])
        tops.append(merge_stats(g))
    o_c = psum(mesh, seq_axis, [decode_values(s, *t, b[0])
                                for s, t, b in zip(scores, tops, blocks)])
    if own is not None:
        o_c = [o + decode_values(s, *t, nw[0])
               for o, s, t, nw in zip(o_c, own, tops, new)]
    return o_c


def absorbed_output(cfg: MLAConfig, o_c, w_uv):
    """``o_c`` (B, h, r) through the heads' columns of ``w_uv`` (r, h·dv):
    (B, 1, h·dv), before ``w_o``."""
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    o = torch.einsum("bhr,rhd->bhd", o_c, w_uv.reshape(r, -1, dv))
    return o.reshape(o.shape[0], 1, -1)


def mla_attend_decode(params, cfg: MLAConfig, x, positions, cache, length,
                      prewritten: bool = False, seq_axis=None):
    """Absorbed decode: x (B, 1, d) against the latent cache (c_kv (B, S,
    r), k_rope (B, S, dr)); ``length`` (B,) valid entries.  Returns (out
    (B, 1, d), (c_new (B, 1, r), kr_new (B, 1, dr))).

    ``prewritten``: the caller already wrote this step's latents into the
    cache (write-then-attend; ``length`` counts them), so nothing is
    appended and the new latents come back as (None, None).

    ``seq_axis`` names the mesh axes a sequence-sharded cache is split
    over: ``cache`` is then a pair of ``core.mesh.Sharded`` values (one
    block of consecutive slots a mesh position, a group of ``seq_axis``
    holding the whole sequence in group order), and ``x``, ``positions``
    and ``length`` tensors or ``Sharded`` values the same across a group.
    Each position computes its block's partial, one gather over the axis
    merges them (without ``prewritten`` the step's own latent is one more
    block), and the result is a ``Sharded`` out, the same across each
    group; the new latents come back as ``Sharded`` values."""
    if seq_axis is not None:
        return _attend_decode_sharded(params, cfg, x, positions, cache,
                                      length, prewritten, seq_axis)
    c_cache, kr_cache = cache
    S = c_cache.shape[1]
    q_c, q_r = absorbed_query(cfg, *_queries(params, cfg, x, positions),
                              params["w_uk"])
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
    s = decode_scores(cfg, q_c, q_r, c_all, kr_all, None, 0)
    idx = torch.arange(S_eff, device=x.device)[None, None, :]
    mask = idx < length[:, None, None]
    if not prewritten:
        mask = mask | (idx == S)
    p = torch.softmax(torch.where(mask, s, MASKED), dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p.to(c_all.dtype).float(),
                       c_all.float())                         # (B, H, r)
    return (absorbed_output(cfg, o_c.to(x.dtype), params["w_uv"])
            @ params["w_o"], (c_new, kr_new))


def _attend_decode_sharded(params, cfg: MLAConfig, x, positions, cache,
                           length, prewritten: bool, seq_axis):
    from repro_torch.core.mesh import Sharded
    c_sh, kr_sh = cache
    mesh = c_sh.mesh

    def block(v, pos):
        return (v.blocks[pos] if isinstance(v, Sharded)
                else v.to(mesh.devices[pos]))

    ps, queries, new, starts = [], [], [], []
    for pos in range(mesh.size):
        c, kr = c_sh.blocks[pos], kr_sh.blocks[pos]
        p = T.tree_map(lambda t: t.to(c.device), params)
        xb, pb = block(x, pos), block(positions, pos)
        queries.append(absorbed_query(cfg, *_queries(p, cfg, xb, pb),
                                      p["w_uk"]))
        starts.append(mesh.group_index(pos, seq_axis) * c.shape[1])
        c_new, kr_new = mla_latents(p, cfg, xb, pb)
        new.append((c_new.to(c.dtype), kr_new.to(kr.dtype)))
        ps.append(p)
    o_c = sharded_o_c(cfg, mesh, seq_axis, queries,
                      list(zip(c_sh.blocks, kr_sh.blocks)),
                      [block(length, pos) for pos in range(mesh.size)],
                      starts, None if prewritten else new)
    outs = [absorbed_output(cfg, o.to(block(x, pos).dtype), ps[pos]["w_uv"])
            @ ps[pos]["w_o"] for pos, o in enumerate(o_c)]
    if prewritten:
        return Sharded(mesh, tuple(outs)), (None, None)
    return Sharded(mesh, tuple(outs)), (
        Sharded(mesh, tuple(c for c, _ in new)),
        Sharded(mesh, tuple(k for _, k in new)))
