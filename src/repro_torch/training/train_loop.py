"""Generic training loop (the port of the reference's
``training/train_loop.py``): a step with gradient accumulation, periodic
async checkpointing, deterministic restart.

Fault-tolerance contract (the reference's, DESIGN.md §4):
  * params / opt-state / data-stream state checkpoint every ``ckpt_every``
    steps via the async writer (atomic rename; LATEST only moves when the
    snapshot is complete).
  * restart = ``run()`` with the same config: it restores LATEST (into the
    caller's parameter tensors), restores the data stream counter, and
    continues bit for bit (the stream is counter-based; the step itself
    must be deterministic: ``models/gnn.py``'s scatters are, on the card
    too).
  * elasticity: checkpoints store full logical arrays; the restoring run
    places them on whatever mesh it was launched with
    (``training/elastic.py``).
  * stragglers: the launcher wraps steps in a watchdog
    (``launch/train.py``) and relaunches from LATEST on timeout; all
    mutation happens at the end of a committed step.

Where the reference ``jax.jit``s the step and ``lax.scan``s the
microbatches, the port runs eagerly: ``torch.autograd.grad`` for
``jax.value_and_grad`` and a Python loop over the microbatches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 200
    microbatches: int = 1            # gradient accumulation factor
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    keep_ckpts: int = 3


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """loss_fn(params, batch) -> scalar tensor.  Returns
    step(params, opt_state, batch) -> (params, opt_state, metrics).

    With microbatches > 1 every batch leaf's leading axis is split and the
    gradients are accumulated in fp32 over the microbatches in turn."""

    def value_and_grad(params, batch):
        loss = loss_fn(params, batch)
        # a parameter the loss does not use gets a zero gradient, as in JAX
        return loss, torch.autograd.grad(loss, T.leaves(params),
                                         allow_unused=True,
                                         materialize_grads=True)

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, flat = value_and_grad(params, batch)
        else:
            flat = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in T.leaves(params)]
            lsum = None
            for i in range(microbatches):
                mb = T.tree_map(lambda x: x.reshape(
                    (microbatches, x.shape[0] // microbatches)
                    + tuple(x.shape[1:]))[i], batch)
                loss_i, g = value_and_grad(params, mb)
                flat = [a + x.to(torch.float32) for a, x in zip(flat, g)]
                loss_i = loss_i.detach().to(torch.float32)
                lsum = loss_i if lsum is None else lsum + loss_i
            flat = [g / microbatches for g in flat]
            loss = lsum / microbatches
        grads = T.unflatten(params, flat)
        params, opt_state, m = adamw_update(opt_cfg, params, grads, opt_state)
        m["loss"] = loss.detach()
        return params, opt_state, m

    return step


def run(loss_fn, params, stream, opt_cfg: OptimizerConfig,
        loop_cfg: TrainLoopConfig, to_device: Optional[Callable] = None,
        on_metrics: Optional[Callable] = None):
    """Drive training to ``total_steps`` with restart-from-LATEST support.

    ``params``' tensors are trained in place (a restart first copies the
    checkpoint into them).  Returns (params, opt_state, history list of
    metric dicts)."""
    opt_state = init_opt_state(params)
    start = 0
    writer = None
    if loop_cfg.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts)
        restored = ckpt.restore(loop_cfg.ckpt_dir,
                                {"params": params, "opt": opt_state})
        if restored is not None:
            tree, step0, extra = restored
            with torch.no_grad():
                for p, v in zip(T.leaves(params), T.leaves(tree["params"]),
                                strict=True):
                    p.copy_(v)
            opt_state = tree["opt"]
            start = step0
            if "stream" in extra:
                stream.restore(extra["stream"])

    step_fn = make_train_step(loss_fn, opt_cfg, loop_cfg.microbatches)
    history = []
    t0 = time.perf_counter()
    for step in range(start, loop_cfg.total_steps):
        batch = next(stream)
        if to_device is not None:
            batch = to_device(batch)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % loop_cfg.log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["sec_per_step"] = (time.perf_counter() - t0) / max(
                step + 1 - start, 1)
            history.append(m)
            if on_metrics:
                on_metrics(m)
        if writer and (step + 1) % loop_cfg.ckpt_every == 0:
            writer.save(step + 1, {"params": params, "opt": opt_state},
                        extra={"stream": stream.state()})
    if writer:
        # the final state, unless the loop's last step just saved it (the
        # reference writes that snapshot a second time)
        if start >= loop_cfg.total_steps \
                or loop_cfg.total_steps % loop_cfg.ckpt_every:
            writer.save(loop_cfg.total_steps,
                        {"params": params, "opt": opt_state},
                        extra={"stream": stream.state()})
        writer.wait()
    return params, opt_state, history
