"""Cell builders: (architecture x input shape) on a mesh -> a runnable step
(the port's counterpart of the reference's ``launch/cells.py``).

A *cell* is one entry of the reference's (arch x shape) grid.  The
reference's ``Cell`` holds ``ShapeDtypeStruct``s and only lowers (nothing
is allocated); the port has no XLA to lower through, so its ``Cell`` holds
real tensors placed on the mesh (``launch.sharding.place``) and
``Cell.run()`` runs the step.  Ported step kinds, the LM's:

  lm.train      the full update step: loss -> gradients -> AdamW, weights
                and moments stored by ``lm_param_spec`` (FSDP x TP),
                ``microbatches`` static slices of the global batch
  lm.prefill    tokens (B, L) -> (last logits, caches placed by
                ``lm_cache_spec``), weights by ``lm_param_spec_tp``
  lm.decode     one token against a placed seq_len cache

MLA configs on a mesh (ROADMAP A.7.3), the GNN and recsys cells (A.7.4), and
a train cell on a mesh whose positions sit on different devices (B.19)
raise ``NotImplementedError``.  The full shapes are large (``train_4k`` is
256 x 4096 tokens, ``long_500k`` a 524,288-slot cache): ``batch=`` /
``seq_len=`` cut them, and a cut is written into the cell's
``static_notes``; ``overrides`` cut the depth (``n_layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.common import shapes_for
from repro_torch.core.mesh import Mesh
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import transformer as TF
from repro_torch.training import optimizer as OPTIM

# the reference's cell optimizer (``src/repro/launch/cells.py``'s ``OPT``)
OPT = OPTIM.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple             # placed tensors (``launch.sharding.Placed``)
    cfg: object = None
    static_notes: str = ""

    def run(self):
        """One step on the placed arguments.  Inference runs without grad;
        a train step runs with it, returns ``(params, opt_state, metrics)``
        and keeps them as the next step's arguments (the reference donates
        its)."""
        if self.kind == "train":
            out = self.step(*self.args)
            self.args = (out[0], out[1]) + tuple(self.args[2:])
            return out
        with torch.no_grad():
            return self.step(*self.args)


def _place(x, mesh: Mesh, rule) -> SH.Placed:
    """``x`` placed by ``rule`` (a rule function, a dict of specs or one
    spec for every leaf); a ``Placed`` already is kept as it is."""
    if isinstance(x, SH.Placed):
        return x
    if isinstance(rule, SH.P):
        spec = rule
        rule = lambda path, leaf: spec                  # noqa: E731
    return SH.place(x, mesh, rule)


def _lm_config(arch_def, mesh: Mesh, overrides: dict, smoke: bool):
    moe_ep = overrides.pop("moe_ep", False)
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    if moe_ep and cfg.moe is not None:          # EP: experts x capacity
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axes=("model", "data")))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.act_shard and not cfg.act_batch_axes:
        cfg = dataclasses.replace(cfg, act_batch_axes=batch_axes(mesh))
    if cfg.fsdp_inner:
        cfg = dataclasses.replace(cfg, model_axis_size=mesh.shape["model"])
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MLA under a mesh is not ported yet (ROADMAP A.7.3)")
    return cfg


def build_cell(arch: str, shape: str, mesh: Mesh,
               overrides: Optional[dict] = None, *,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               smoke: bool = False, params=None,
               inputs: Optional[dict] = None) -> Cell:
    """The cell of ``arch`` at ``shape`` on ``mesh``.

    ``overrides``: config fields to replace (``n_layers``, the perf knobs
    such as ``decode_write_then_attend`` / ``decode_seq_axis``,
    ``fsdp_inner``, ``act_shard``, ``remat``), plus ``moe_ep``
    (``ep_axes=("model", "data")``) and the train cell's ``microbatches``,
    as in the reference.  ``batch`` / ``seq_len`` cut the shape.
    ``params``: the weights (a ``TransformerParams`` of the config, placed
    here, or a ``Placed`` one in the cell's layout); by default random
    weights from ``torch.Generator`` seed 0 on the mesh's first device.  A
    train cell trains copies of them.  ``inputs``: tensors (or ``Placed``
    ones) in place of the defaults — train ``tokens`` / ``labels`` (B, L)
    and prefill ``tokens`` (default: seeded numpy draws), decode ``token``
    (B,), ``length`` (B,) (default: seeded draws, zeros) and ``cache`` (a
    ``make_empty_cache`` dict; default: zeros)."""
    arch_def = configs.get(arch)
    shp = dict(shapes_for(arch_def.family)[shape])
    if arch_def.family != "lm":
        raise NotImplementedError(
            f"{arch} ({arch_def.family}): the GNN and recsys cells are not "
            f"ported yet (ROADMAP A.7.4)")
    overrides = dict(overrides or {})
    microbatches = int(overrides.pop("microbatches", 1))
    if shp["kind"] == "train" and len(set(mesh.devices)) > 1:
        raise NotImplementedError(
            f"{arch} {shape}: training on a mesh whose positions sit on "
            f"different devices is not ported yet (ROADMAP B.19: a "
            f"replicated block's copies would need their gradients summed "
            f"across devices)")
    cfg = _lm_config(arch_def, mesh, overrides, smoke)
    notes = []
    B, L = shp["batch"], shp["seq_len"]
    if batch is not None and batch != B:
        notes.append(f"batch cut from {B} to {batch}")
        B = batch
    if seq_len is not None and seq_len != L:
        notes.append(f"seq_len cut from {L} to {seq_len}")
        L = seq_len
    full_layers = (arch_def.make_smoke() if smoke
                   else arch_def.make_full()).n_layers
    if cfg.n_layers != full_layers:
        notes.append(f"n_layers cut from {full_layers} to {cfg.n_layers}")
    dev = mesh.devices[0]
    inputs = dict(inputs or {})
    rng = np.random.default_rng(0)
    if params is None:
        params = TF.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, dev)
    if shp["kind"] == "train":
        return _train_cell(arch, shape, mesh, cfg, params, inputs, rng, B, L,
                           microbatches, "; ".join(notes))
    placed = _place(params, mesh, SH.lm_param_spec_tp)
    if shp["kind"] == "prefill":
        tokens = inputs.get("tokens")
        if tokens is None:
            tokens = torch.from_numpy(rng.integers(
                1, cfg.vocab, (B, L)).astype(np.int32)).to(dev)
        args = (placed, _place(tokens, mesh, SH.lm_batch_spec(mesh)))
        step = lambda p, t: TF.prefill(p, cfg, t)       # noqa: E731
        kind = "prefill"
    else:
        b_axes = batch_axes(mesh)
        bspec = SH.P(b_axes) if B >= int(np.prod(
            [mesh.shape[a] for a in b_axes])) else SH.P()
        token = inputs.get("token")
        if token is None:
            token = torch.from_numpy(rng.integers(
                1, cfg.vocab, (B,)).astype(np.int32)).to(dev)
        length = inputs.get("length")
        if length is None:
            length = torch.zeros((B,), dtype=torch.int32, device=dev)
        cache = inputs.get("cache")
        if cache is None:
            cache = TF.make_empty_cache(cfg, B, L, dev)
        args = (placed, _place(token, mesh, bspec),
                _place(cache, mesh, SH.lm_cache_spec(
                    mesh, cfg.attn_type, B, cfg.n_kv_heads)),
                _place(length, mesh, bspec))
        step = lambda p, t, c, n: TF.decode_step(p, cfg, t, c, n)  # noqa
        kind = "decode"
    return Cell(arch, shape, kind, step, args, cfg, "; ".join(notes))


def _init_opt_state_placed(placed) -> dict:
    """The moments of a placed tree: float32 zeros a distinct block, placed
    as the blocks are (``mu`` / ``nu`` are ``Placed`` trees of the same
    shapes, specs and sharing), and an int32 step on the first device."""
    zeros = OPTIM.init_opt_state([b for _, b in SH.distinct(placed)])
    return {"mu": SH.with_blocks(placed, zeros["mu"]),
            "nu": SH.with_blocks(placed, zeros["nu"]),
            "step": zeros["step"]}


def _adamw_update_placed(cfg: OPTIM.OptimizerConfig, placed, grads, state):
    """``OPTIM.adamw_update`` on a placed tree: ``grads`` holds one gradient
    a distinct block (``SH.distinct``'s order), and each block is one leaf:
    the global norm sums every distinct block once, the update runs block
    by block, written into the block, and a block's weight decay follows
    its ndim, which is its global leaf's.  Returns ``(placed, new_state,
    metrics)``; the moments stay in the blocks' layout.  Every block must
    be on one device (one global norm)."""
    blocks = [b for _, b in SH.distinct(placed)]
    flat = {"mu": [b for _, b in SH.distinct(state["mu"])],
            "nu": [b for _, b in SH.distinct(state["nu"])],
            "step": state["step"]}
    _, new, metrics = OPTIM.adamw_update(cfg, blocks, list(grads), flat)
    return placed, {"mu": SH.with_blocks(state["mu"], new["mu"]),
                    "nu": SH.with_blocks(state["nu"], new["nu"]),
                    "step": new["step"]}, metrics


def _train_cell(arch, shape, mesh: Mesh, cfg, params, inputs: dict, rng,
                B: int, L: int, microbatches: int, notes: str) -> Cell:
    """The reference's ``_lm_train_cell``: weights and moments stored by
    ``lm_param_spec``, the batch by ``lm_batch_spec``; a step takes the
    loss of each microbatch (rows ``[i·B/M, (i+1)·B/M)`` of the global
    batch, placed by ``lm_batch_spec``) on the storage tree — the sharded
    route moves it to the compute layout, and the gradient comes back to
    storage — sums the gradients in float32, divides by M, and ends with
    ``OPT``'s AdamW on the distinct blocks.  Metrics: ``loss`` (the mean of
    the microbatch losses), ``grad_norm``, ``lr``."""
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    dev = mesh.devices[0]
    bspec = SH.lm_batch_spec(mesh)
    batch = {}
    for key in ("tokens", "labels"):
        x = inputs.get(key)
        if x is None:
            x = torch.from_numpy(rng.integers(1, cfg.vocab, (B, L)).astype(
                np.int32)).to(dev)
        batch[key] = _place(x, mesh, bspec)
    placed = SH.trainable(_place(params, mesh, SH.lm_param_spec))
    leaves = [b for _, b in SH.distinct(placed)]

    def value_and_grad(p, b):
        loss = TF.train_step_loss(p, cfg, b)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)

    def step(p, opt_state, b):
        if microbatches == 1:
            loss, grads = value_and_grad(p, b)
        else:
            whole = {k: v.gather("") for k, v in b.items()}
            n = B // microbatches
            grads = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in leaves]
            loss = 0.0
            for i in range(microbatches):
                mb = {k: _place(v[i * n:(i + 1) * n], mesh, bspec)
                      for k, v in whole.items()}
                loss_i, g = value_and_grad(p, mb)
                grads = [a + x.float() for a, x in zip(grads, g)]
                loss = loss + loss_i.detach()
            grads = [g / microbatches for g in grads]
            loss = loss / microbatches
        p, opt_state, m = _adamw_update_placed(OPT, p, grads, opt_state)
        m["loss"] = loss.detach()
        return p, opt_state, m

    return Cell(arch, shape, "train", step,
                (placed, _init_opt_state_placed(placed), batch), cfg,
                notes)
