"""Hand-rolled AdamW with a cosine schedule, global-norm clipping, and int8
error-feedback gradient compression (the port of the reference's
``training/optimizer.py``).

Parameters are a tree (``repro_torch.tree``): a ``ParamTree`` or nested
dicts and lists of tensors.  ``adamw_update`` runs under ``torch.no_grad``
and writes the new values **into the parameter tensors** (the reference
returns new arrays and donates the old ones; here the autograd leaves stay
the same objects from step to step).  It returns ``(params, state,
metrics)`` as the reference does; the moments are new tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch import tree as T
from repro_torch.core import mesh as M


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, as a float32 tensor on
    the step's device (a Python int step: on the CPU)."""
    step = (step.to(torch.float32) if torch.is_tensor(step)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params) -> dict:
    """fp32 moments shaped like the parameters, and an int32 step."""
    flat = T.leaves(params)
    zeros = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    return {"mu": zeros,
            "nu": T.tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step; returns ``(params, new_state, metrics)``.  ``params``
    is the same tree, its tensors overwritten with the new values."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * update)
        return mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state["mu"]),
        T.leaves(state["nu"]), strict=True)]
    new_state = {"mu": T.unflatten(state["mu"], [o[0] for o in out]),
                 "nu": T.unflatten(state["nu"], [o[1] for o in out]),
                 "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# int8 error-feedback gradient compression (cross-pod reduction trick)
# --------------------------------------------------------------------------

def compress_int8(g, err):
    """Quantize g+err to int8 with a per-tensor scale; returns
    (q, scale, new_err).  Error feedback keeps the scheme unbiased over
    steps (the residual is re-added next step)."""
    x = g.to(torch.float32) + err
    scale = torch.clamp(torch.abs(x).max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress_int8(q, scale):
    return q.to(torch.float32) * scale


def init_error_state(params):
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def compressed_psum(grads: Sequence, err_state: Sequence, mesh: M.Mesh,
                    axis: str = "data"):
    """Sum int8-quantized gradients over the shards of ``axis`` with error
    feedback (the reference's ``compressed_psum`` under ``shard_map``).

    ``grads[d]`` / ``err_state[d]`` are shard d's trees on its device.  Per
    leaf, one ``core.mesh.all_gather`` of the int8 payloads (summed in
    int32: at most 127 x D) and one of the scales (their max is the shared
    scale).  Returns (new grads, new error states), one tree a shard."""
    D = len(mesh.shard_devices(axis))
    if len(grads) != D or len(err_state) != D:
        raise ValueError(f"{len(grads)} gradient trees and {len(err_state)} "
                         f"error trees for {D} shards")
    flat_g = [T.leaves(g) for g in grads]
    flat_e = [T.leaves(e) for e in err_state]
    new_g = [[] for _ in range(D)]
    new_e = [[] for _ in range(D)]
    for i in range(len(flat_g[0])):
        comp = [compress_int8(flat_g[d][i], flat_e[d][i]) for d in range(D)]
        qs = M.all_gather([c[0] for c in comp])
        ss = M.all_gather([c[1] for c in comp])
        for d in range(D):
            tot = qs[d].to(torch.int32).sum(0)
            g = flat_g[d][i]
            new_g[d].append((tot.to(torch.float32) * ss[d].max()).to(g.dtype))
            new_e[d].append(comp[d][2])
    return ([T.unflatten(grads[d], new_g[d]) for d in range(D)],
            [T.unflatten(err_state[d], new_e[d]) for d in range(D)])
