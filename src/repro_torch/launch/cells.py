"""Cell builders: (architecture x input shape) on a mesh -> a runnable step
(the port's counterpart of the reference's ``launch/cells.py``).

A *cell* is one entry of the reference's (arch x shape) grid.  The
reference's ``Cell`` holds ``ShapeDtypeStruct``s and only lowers (nothing
is allocated); the port has no XLA to lower through, so its ``Cell`` holds
real tensors placed on the mesh (``launch.sharding.place``) and
``Cell.run()`` runs the step.  Ported step kinds, the LM's serving ones:

  lm.prefill    tokens (B, L) -> (last logits, caches placed by
                ``lm_cache_spec``), weights by ``lm_param_spec_tp``
  lm.decode     one token against a placed seq_len cache

``lm.train`` (ROADMAP A.7.2), MLA configs on a mesh (A.7.3), and the GNN and
recsys cells (A.7.4) raise ``NotImplementedError``.  The full shapes are
large (``prefill_32k`` is 32 x 32768 tokens, ``long_500k`` a 524,288-slot
cache): ``batch=`` / ``seq_len=`` cut them, and a cut is written into the
cell's ``static_notes``; ``overrides`` cut the depth (``n_layers``).
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
        """One step on the placed arguments (inference: no grad)."""
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


def _lm_config(arch_def, mesh: Mesh, overrides: Optional[dict],
               smoke: bool):
    overrides = dict(overrides or {})
    overrides.pop("microbatches", None)         # a train-cell knob
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
    TF.check_supported(cfg)
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
    such as ``decode_write_then_attend`` / ``decode_seq_axis``), plus
    ``moe_ep`` (``ep_axes=("model", "data")``), as in the reference.
    ``batch`` / ``seq_len`` cut the shape.  ``params``: the weights (a
    ``TransformerParams`` of the config, placed here, or a ``Placed`` one);
    by default random weights from ``torch.Generator`` seed 0 on the
    mesh's first device.  ``inputs``: tensors (or ``Placed`` ones) in
    place of the defaults — prefill ``tokens`` (B, L) (default: seeded
    numpy draws), decode ``token`` (B,), ``length`` (B,) (default: seeded
    draws, zeros) and ``cache`` (a ``make_empty_cache`` dict; default:
    zeros)."""
    arch_def = configs.get(arch)
    shp = dict(shapes_for(arch_def.family)[shape])
    if arch_def.family != "lm":
        raise NotImplementedError(
            f"{arch} ({arch_def.family}): the GNN and recsys cells are not "
            f"ported yet (ROADMAP A.7.4)")
    if shp["kind"] == "train":
        raise NotImplementedError(
            f"{arch} {shape}: LM training on the mesh is not ported yet "
            f"(ROADMAP A.7.2)")
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
