"""Mixture-of-Experts FFN: top-k router, capacity-based scatter dispatch and
optional shared experts (Qwen-MoE style).

Port of ``src/repro/models/moe.py``.  Tokens are ranked within their chosen
expert by a cumsum over the token-major ``(T·k, E)`` assignment one-hot,
scattered into an ``(E, cap, d)`` buffer, run through a batched per-expert
SwiGLU and gathered back; a (token, choice) past its expert's capacity is
dropped (contributes zero), GShard's rule.  ``moe_route`` is the routing
alone (``moe_apply`` calls it through the module, so a caller can watch
it).

What keeps it equal to the reference, and deterministic on the card:

* top-k is a stable descending sort of the probabilities, first ``k``:
  among equal probabilities the lower expert comes first, as in
  ``jax.lax.top_k`` (``torch.topk`` promises no order, and the capacity
  rank depends on it);
* ``cap = max(1, int(capacity_factor * T * k / n_experts))``, Python float
  arithmetic on the real expert count; padding experts get -1e30 logits;
* the dispatch is an accumulating ``index_put``: kept (expert, slot) pairs
  are unique, and a dropped pair adds an exact zero at (0, 0), so the
  result does not depend on the order of the adds;
* the combine gather is ``scatter.gather``, whose backward is the sorted
  accumulating scatter on the card (the same bits every run);
* the aux loss reads only real experts and only the first choice.

``ep_axes`` is the reference's expert-parallel sharding: experts over its
first axis, the dispatch buffer's capacity slots over its second.  On one
device it changes no value (the reference's is a sharding constraint); on
a mesh the sharded route (``models/spmd.py::moe_apply_sharded``) runs
``("model", "data")``, the one layout the reference's cells set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import MASKED, _init_dense, swiglu
from repro_torch.models.scatter import gather


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts, always on (Qwen2-MoE)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    n_experts_padded: Optional[int] = None   # the reference pads for sharding
    ep_axes: Optional[tuple] = None          # e.g. ("model", "data")

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts


def moe_init(generator, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    """The reference's leaves: ``router`` float32 ``(d, E_pad)``,
    ``w_gate`` / ``w_up`` ``(E_pad, d, F)``, ``w_down`` ``(E_pad, F, d)``,
    and with shared experts ``shared`` (a SwiGLU of ``d_ff_shared``, or
    ``d_ff_expert * n_shared``).  Dense N(0, 1/d_in), from ``generator``."""
    E, Fd = cfg.e_pad, cfg.d_ff_expert

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=generator,
                        dtype=torch.float32, device=device)
        return (w * (1.0 / d_in ** 0.5)).to(dtype)

    g = dict(generator=generator, device=device)
    p = {"router": _init_dense(d_in=d_model, d_out=E, dtype=torch.float32,
                               **g),
         "w_gate": experts(d_model, Fd), "w_up": experts(d_model, Fd),
         "w_down": experts(Fd, d_model)}
    if cfg.n_shared:
        d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
        p["shared"] = {
            "w_gate": _init_dense(d_in=d_model, d_out=d_sh, dtype=dtype, **g),
            "w_up": _init_dense(d_in=d_model, d_out=d_sh, dtype=dtype, **g),
            "w_down": _init_dense(d_in=d_sh, d_out=d_model, dtype=dtype,
                                  **g)}
    return p


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` (int64) by a scatter: ``F.one_hot`` reads the
    indices' range back to the host on a CUDA tensor, a sync a call."""
    out = torch.zeros(idx.shape + (n,), dtype=torch.int64, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def capacity(cfg: MoEConfig, T: int) -> int:
    """Slots an expert: the reference's Python float arithmetic."""
    return max(1, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))


def top_k(params, cfg: MoEConfig, x):
    """x (T, d) -> (probs (T, E_pad) float32, gate (T, k) float32 summing to
    1 a token, eidx (T, k) int64)."""
    E, k = cfg.e_pad, cfg.top_k
    logits = x.float() @ params["router"]
    if E > cfg.n_experts:       # padding experts take no tokens, no mass
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], MASKED, logits)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, the lower index first among ties
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = srt[:, :k], order[:, :k]
    return probs, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), eidx


def rank(eidx, E: int):
    """(pos (T, k) int64: each (token, choice) pair's exclusive rank within
    its expert, token-major; counts (E,) int64: the pairs an expert got)."""
    T, k = eidx.shape
    flat = _one_hot(eidx.reshape(T * k), E)                  # (T·k, E)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(T, k)
    return pos, flat.sum(0)


def moe_route(params, cfg: MoEConfig, x):
    """x (T, d) -> (probs (T, E_pad) float32, gate (T, k) float32 summing to
    1 a token, eidx (T, k) int64, pos (T, k) int64 (the pair's rank within
    its expert, token-major), keep (T, k) bool, cap)."""
    probs, gate, eidx = top_k(params, cfg, x)
    pos = rank(eidx, cfg.e_pad)[0]
    cap = capacity(cfg, x.shape[0])
    return probs, gate, eidx, pos, pos < cap, cap


def moe_apply(params, cfg: MoEConfig, x):
    """x: (T, d) -> (out (T, d), aux_loss scalar float32)."""
    T, d = x.shape
    E, k = cfg.e_pad, cfg.top_k
    probs, gate, eidx, pos, keep, cap = moe_route(params, cfg, x)
    e_safe = torch.where(keep, eidx, 0).reshape(-1)
    p_safe = torch.where(keep, pos, 0).reshape(-1)
    xk = (x[:, None, :] * keep[..., None].to(x.dtype)).reshape(T * k, d)
    buf = x.new_zeros((E, cap, d)).index_put((e_safe, p_safe), xk,
                                             accumulate=True)
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    y = torch.bmm(h, params["w_down"])                       # (E, cap, d)
    out_k = gather(y.reshape(E * cap, d),
                   e_safe * cap + p_safe).reshape(T, k, d)
    out = (out_k * (gate * keep)[..., None].to(out_k.dtype)).sum(dim=1)
    if cfg.n_shared:
        out = out + swiglu(params["shared"], x)
    return out, switch_aux(cfg, router_sums(cfg, probs, eidx), T)


def router_sums(cfg: MoEConfig, probs, eidx):
    """(2, n_experts) float32: the routing probabilities and the
    first-choice counts of the real experts, summed over the tokens."""
    n = cfg.n_experts
    return torch.stack([probs[:, :n].sum(0),
                        _one_hot(eidx[:, 0], cfg.e_pad)[:, :n].float().sum(0)])


def switch_aux(cfg: MoEConfig, sums, T: int):
    """The switch aux loss (float32 scalar) from ``router_sums`` over T
    tokens: the mean probability times the mean first-choice share, summed
    over the experts."""
    return cfg.router_aux_weight * cfg.n_experts * (
        (sums[0] / T) * (sums[1] / T)).sum()
