"""Dispatch wrappers for the kernels.

``backend="auto"`` follows the tensors: a CUDA tensor launches the
hand-written CUDA kernel or raises (no build, load or launch failure ever
gives way to the plain version), a CPU tensor takes the plain PyTorch
version (``kernels/ref.py``) — the CPU tests run there.  ``backend="torch"``
asks for the plain version wherever the tensors lie; ``backend="cuda"`` asks
for the kernel and raises on a CPU tensor.

The dispatchers take ``impl`` ("bitset" | "dense"), forwarded to the plain
versions; the kernels are the packed-bitset expression by construction
(DESIGN.md §10) and ignore it — every (backend, impl) corner must agree
bit-for-bit.

The only route from a CUDA tensor under ``backend="auto"`` to the plain
version is the ``kernel.fallback`` fault site, armed explicitly through
``REPRO_FAULTS`` / ``faults.inject()`` and counted in
``kernels.fallback{kernel=,reason=forced}``.  Every dispatch decision is
counted in ``kernels.dispatch{kernel=,backend=}``.
"""
from __future__ import annotations

import torch

# the wrappers' modules, their names read at call time: the wrappers import
# core (through kernels.ref), whose engines import this module, so any of
# them may be the first module a program imports
from repro_torch.kernels import detect_recolor as _dr_mod
from repro_torch.kernels import ell_spmm as _spmm_mod
from repro_torch.kernels import firstfit as _ff_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import ref
from repro_torch.kernels import twohop as _twohop_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import faults

BACKENDS = ("auto", "torch", "cuda")


def _resolve(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"known: {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.device.type == "cuda" else "torch"
    if backend == "cuda" and t.device.type != "cuda":
        raise ValueError(
            f"backend='cuda' needs CUDA tensors (got a tensor on {t.device})")
    return backend


def _forced_fallback(kernel: str, b: str) -> str:
    """``kernel.fallback`` fault site (DESIGN.md §14.4): force the plain
    torch version — bit-identical output by the parity contract, so chaos
    runs exercise the fallback plumbing without changing results.  With
    faults off this is one module-global None check."""
    if b != "torch" and faults.fires("kernel.fallback", kernel=kernel):
        obs_metrics.counter("kernels.fallback", kernel=kernel,
                            reason="forced").inc()
        return "torch"
    return b


def _dispatched(kernel: str, backend: str) -> None:
    """Count every dispatch decision: ``kernels.dispatch{kernel=,backend=}``
    tells a perf report which path actually ran (DESIGN.md §12)."""
    obs_metrics.counter("kernels.dispatch", kernel=kernel,
                        backend=backend).inc()


def firstfit(ell, colors, C: int = 64, backend: str = "auto",
             impl: str = "bitset", forb0=None, **kw):
    b = _forced_fallback("firstfit", _resolve(backend, ell))
    _dispatched("firstfit", b)
    if b == "torch":
        return ref.firstfit_ref(ell, colors, C, impl=impl, forb0=forb0)
    return _ff_mod.firstfit(ell, colors, C, forb0, **kw)


def detect_recolor(ell, colors, pri, U_rows, row_start: int, C: int = 64,
                   backend: str = "auto", impl: str = "bitset", forb0=None,
                   extra_defect=None, force=None, valid=None, row_ids=None,
                   detect_only: bool = False, slot_rows: int = 0, **kw):
    """RSOC's fused pass over rows [row_start, row_start + R) (or the
    vertices ``row_ids``): (newc, recolored, ovf).  ``detect_only=True``
    (CAT's detect pass) returns the (R,) ``recolored`` flags alone;
    ``slot_rows > 0`` is the slot-stride form over stacked slots (the
    megabatched repair)."""
    b = _forced_fallback("detect_recolor", _resolve(backend, ell))
    _dispatched("detect_recolor", b)
    if b == "torch":
        if detect_only:
            _dr_mod.check_detect_only(forb0)
        slot_rows = _dr_mod.check_slot_rows(slot_rows, row_ids,
                                            colors.shape[0], detect_only)
        return ref.detect_recolor_ref(
            ell, colors, pri, row_start, U_rows, C, impl=impl, forb0=forb0,
            extra_defect=extra_defect, force=force, valid=valid,
            row_ids=row_ids, detect_only=detect_only, slot_rows=slot_rows)
    return _dr_mod.detect_recolor(ell, colors, pri, U_rows, row_start, C,
                                  forb0, extra_defect, force, valid,
                                  row_ids=row_ids, detect_only=detect_only,
                                  slot_rows=slot_rows, **kw)


def twohop(ell_rows, ell_all, colors, pri, U_rows, row_start: int,
           C: int = 64, backend: str = "auto", impl: str = "bitset",
           page_rows=None, force=None, valid=None, row_ids=None,
           detect: bool = True, **kw):
    """Fused two-hop (distance-2) detect-and-recolor for rows
    [row_start, row_start + R) or the vertices ``row_ids``.  The kernel
    reads the hop-2 table from device memory: there is no residency
    predicate and no shape fallback, and ``page_rows`` does not change the
    result."""
    b = _forced_fallback("twohop", _resolve(backend, ell_all))
    _dispatched("twohop", b)
    if b == "torch":
        return ref.twohop_ref(ell_rows, ell_all, colors, pri, row_start,
                              U_rows, C, impl=impl, force=force, valid=valid,
                              row_ids=row_ids, detect=detect)
    return _twohop_mod.twohop_detect_recolor(
        ell_rows, ell_all, colors, pri, U_rows, row_start, C, page_rows,
        force=force, valid=valid, row_ids=row_ids, detect=detect, **kw)


def ell_aggregate(ell, feats, op: str = "sum", backend: str = "auto", **kw):
    """GNN neighbour aggregation ``out[v] = op_j feats[ell[v, j]]``.  The
    kernel reads the features from device memory: there is no residency
    predicate and no shape fallback (the reference's VMEM budget and its
    ``reason=vmem`` fallback do not exist here)."""
    _spmm_mod.check_spmm(ell, feats, op)
    b = _forced_fallback("ell_aggregate", _resolve(backend, ell))
    _dispatched("ell_aggregate", b)
    if b == "torch":
        return ref.ell_spmm_ref(ell, feats, op)
    return _spmm_mod.ell_spmm(ell, feats, op, **kw)


def attention(q, k, v, *, causal: bool = True, backend: str = "auto"):
    """Forward attention (GQA, causal with offset Lk - Lq); ``causal`` with
    Lk < Lq raises on every backend."""
    _fa_mod.check_attention(q, k, v, causal)
    b = _forced_fallback("attention", _resolve(backend, q))
    _dispatched("attention", b)
    if b == "torch":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _fa_mod.flash_attention(q, k, v, causal=causal)
