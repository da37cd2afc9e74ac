"""Incremental recoloring for mutating graphs (DESIGN.md §7.2; the port of
the reference's ``dynamic/incremental.py``).

``recolor_incremental`` is the paper's fused detect-and-recolor pass turned
into a repair primitive: instead of seeding the defect set U with the whole
vertex set (round 0 of the from-scratch loop), it seeds U with the endpoints
of the edges changed by an update batch.  Properness of the previous coloring
guarantees every post-update conflict lies on an inserted edge, so the seed
set covers all defects; the frontier-compacted repair loop then pays only
O(|U| * W) bytes per round instead of O(n * W).

On a CUDA device ``dynamic_state`` colors the graph once on the kernels of
the static path — first fit (B1) for round 0, ``detect_recolor`` (B2) for
the repairs — and every ``recolor_incremental`` applies the batch's waves
(plain torch, ``dynamic/delta.py``) and repairs on B2 with ``row_ids``, one
launch per chunk of the compacted pass (``core/frontier.py``).

State is immutable: every update batch returns a *new*
``DynamicColoringState`` carrying the mutated device tensors, the repaired
colors, a bumped version, and repair statistics.  The previous state remains
valid (its tensors are never written: the batch works on copies), which
gives the service layer cheap snapshot/rollback semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import coloring as col
from repro_torch.core import frontier
from repro_torch.core.context import PassContext, resolve_impl
from repro_torch.dynamic import delta
from repro_torch.graphs.csr import CSRGraph, FILL
from repro_torch.resilience.errors import CapRetryExhausted

# the array fields of a state (device tensors); every other field is a
# Python scalar or, for perm / inv_perm, a host numpy array
TENSOR_FIELDS = ("ell", "ovf_src", "ovf_dst", "pri", "colors_dev")


@dataclasses.dataclass(frozen=True)
class DynamicColoringState:
    """Device-resident mutable-graph coloring state (relabeled space)."""

    ell: torch.Tensor        # (n_pad, W) neighbor slots, FILL = empty
    ovf_src: torch.Tensor    # (ovf_cap,) overflow COO, FILL = free slot
    ovf_dst: torch.Tensor
    pri: torch.Tensor        # (n_pad,) asymmetric tie-break priorities
    colors_dev: torch.Tensor  # (n_pad,) current proper coloring
    n: int
    n_pad: int
    C: int                   # color cap (doubles on overflow, persisted)
    n_chunks: int
    frontier_cap: int        # compacted-frontier capacity (rows)
    delta_cap: int           # update-slice width (fixed shape per slice)
    perm: np.ndarray         # old id -> new id
    inv_perm: np.ndarray     # new id -> old id
    forbidden_impl: str = "bitset"  # forbidden-set representation (§10)
    max_rounds: int = 1000          # repair-round bound, persisted
    version: int = 0
    last_rounds: int = 0
    last_conflicts: int = 0
    last_gather_passes: int = 0     # compacted passes of the last repair
    total_gather_passes: int = 0
    retries: int = 0                # cumulative color-cap doublings
    ovf_grows: int = 0              # cumulative overflow-buffer growths
    max_cap_retries: Optional[int] = None  # cap-doubling budget per repair
    max_ovf_growth: Optional[int] = None   # overflow-growth budget per batch
    last_degrade_rung: int = 0      # ladder rung that produced this state:
                                    # 0 incremental, 1 scratch, 2 oracle

    @property
    def device(self) -> torch.device:
        return self.ell.device

    @property
    def colors(self) -> np.ndarray:
        """Current coloring over original vertex ids."""
        return col._to_numpy(self.colors_dev)[self.perm[:self.n]]

    @property
    def n_colors(self) -> int:
        return col.n_colors_used(col._to_numpy(self.colors_dev)[:self.n])

    def summary(self) -> dict:
        return {"version": self.version, "colors": self.n_colors,
                "rounds": self.last_rounds,
                "conflicts": self.last_conflicts,
                "gather_passes": self.last_gather_passes,
                "total_gather_passes": self.total_gather_passes,
                "final_C": self.C, "retries": self.retries,
                "ovf_grows": self.ovf_grows,
                "degrade_rung": self.last_degrade_rung,
                "ovf_load": delta.overflow_load(self.ovf_src)}


def _resolve_device(device) -> torch.device:
    # api imports this module (to register its engine): a call-time import
    from repro_torch.api import _resolve_device as resolve
    return resolve(device)


def state_from_numpy(fields: dict, device) -> DynamicColoringState:
    """A ``DynamicColoringState`` on ``device`` from a state's fields given
    as numpy arrays and Python scalars (e.g. a reference state's, converted
    by the caller): the five tensor fields become int32 tensors, ``perm`` /
    ``inv_perm`` stay host arrays, every other field is taken as it is."""
    device = torch.device(device)
    kw = dict(fields)
    for name in TENSOR_FIELDS:
        a = np.array(kw[name], dtype=np.int32)          # a writable copy
        kw[name] = torch.from_numpy(a).to(device)
    kw["perm"] = np.asarray(kw["perm"])
    kw["inv_perm"] = np.asarray(kw["inv_perm"])
    return DynamicColoringState(**kw)


def _encode(prob, colors_pad, *, n_chunks, ell_slack, ovf_cap, delta_cap,
            frontier_frac):
    """The mutable encoding of a prepared problem: (ell with ``ell_slack``
    free slots a row, osrc, odst) on the problem's device, and the
    remaining ``DynamicColoringState`` fields."""
    device = prob.device
    ell = prob.ell
    if ell_slack > 0:
        pad = torch.full((ell.shape[0], ell_slack), int(FILL),
                         dtype=torch.int32, device=device)
        ell = torch.cat([ell, pad], dim=1)
    n_ovf = int(prob.ovf_src.shape[0])
    cap = int(ovf_cap) if ovf_cap is not None else max(64, 2 * n_ovf,
                                                       delta_cap // 2)
    cap = max(cap, n_ovf, 8)
    osrc = torch.full((cap,), int(FILL), dtype=torch.int32, device=device)
    odst = torch.full((cap,), int(FILL), dtype=torch.int32, device=device)
    osrc[:n_ovf] = prob.ovf_src
    odst[:n_ovf] = prob.ovf_dst
    return dict(
        ell=ell.contiguous(), ovf_src=osrc, ovf_dst=odst, pri=prob.pri,
        colors_dev=colors_pad, n=prob.n, n_pad=prob.n_pad,
        n_chunks=n_chunks,
        frontier_cap=frontier.frontier_cap(prob.n_pad, n_chunks,
                                           frontier_frac),
        delta_cap=int(delta_cap), perm=prob.perm,
        inv_perm=np.argsort(prob.perm))


def dynamic_state(g: CSRGraph, seed: int = 0, n_chunks: int = 16,
                  ell_cap: int = 512, C: Optional[int] = None,
                  ell_slack: int = 4, ovf_cap: Optional[int] = None,
                  delta_cap: int = 2048, frontier_frac: float = 0.125,
                  max_rounds: int = 1000,
                  forbidden_impl: Optional[str] = None,
                  max_cap_retries: Optional[int] = None,
                  max_ovf_growth: Optional[int] = None, *,
                  device=None) -> DynamicColoringState:
    """Encode ``g`` for mutation and color it from scratch once, on
    ``device`` (None: the CUDA device, raising where there is none).

    ``ell_slack`` free slots are appended to every row so typical inserts
    land in ELL; ``ovf_cap`` sizes the spill buffer (grows on demand).
    ``max_cap_retries`` / ``max_ovf_growth`` are persisted on the state and
    bound every subsequent repair (None: unbounded).
    """
    device = _resolve_device(device)
    impl = resolve_impl(forbidden_impl)
    with obs.phase("prepare"):
        prob = col.prepare(g, seed, n_chunks, ell_cap, C, device=device)
    (colors_n, r, trace, tot, _), final_C, retries = col._run_with_retry(
        col._prob_runner(col._rsoc_loop, prob, n_chunks, max_rounds, impl),
        prob.C, engine="incremental", max_retries=max_cap_retries)
    colors_pad = torch.full((prob.n_pad,), -1, dtype=torch.int32,
                            device=device)
    colors_pad[:prob.n] = colors_n
    return DynamicColoringState(
        **_encode(prob, colors_pad, n_chunks=n_chunks, ell_slack=ell_slack,
                  ovf_cap=ovf_cap, delta_cap=delta_cap,
                  frontier_frac=frontier_frac),
        C=final_C, forbidden_impl=impl, max_rounds=int(max_rounds),
        version=0, last_rounds=int(r), last_conflicts=int(tot),
        last_gather_passes=1 + int(r), total_gather_passes=1 + int(r),
        retries=retries, ovf_grows=0,
        max_cap_retries=max_cap_retries, max_ovf_growth=max_ovf_growth)


def _check_edges(edges, n: int, what: str, *, tenant: Optional[str] = None,
                 strict: bool = False) -> np.ndarray:
    """Validate a (k, 2) edge batch; returns a defensive int64 copy.

    ``strict`` (the service submit path) additionally rejects non-integer
    dtypes, malformed shapes, and self-loops on inserts, naming the tenant
    in every error so a bad batch is attributable before it is queued.
    """
    who = f"graph {tenant!r}: " if tenant is not None else ""
    if strict:
        raw = np.asarray(edges)
        if raw.size and not np.issubdtype(raw.dtype, np.integer):
            raise ValueError(
                f"{who}{what} must be integer vertex ids "
                f"(got dtype {raw.dtype})")
    # np.array (not asarray): always copy, so a caller reusing its batch
    # buffer cannot mutate edges after validation (service queues them)
    try:
        e = np.array(edges, dtype=np.int64).reshape(-1, 2)
    except (ValueError, TypeError) as exc:
        raise ValueError(
            f"{who}{what} must be a (k, 2) edge array: {exc}") from exc
    if len(e) and (e.min() < 0 or e.max() >= n):
        raise ValueError(f"{who}{what} contains vertex ids outside [0, {n})")
    if (strict and what == "inserts" and len(e)
            and bool((e[:, 0] == e[:, 1]).any())):
        bad = e[e[:, 0] == e[:, 1]][0]
        raise ValueError(
            f"{who}{what} contains self-loop ({int(bad[0])}, {int(bad[1])}); "
            f"self-loops are not colorable edges — filter them out")
    return e


def recolor_incremental(state: DynamicColoringState,
                        inserts=None, deletes=None,
                        max_rounds: Optional[int] = None
                        ) -> DynamicColoringState:
    """Apply an undirected edge update batch and repair the coloring, on
    the state's device.

    ``inserts`` / ``deletes`` are (k, 2) arrays of *original* vertex ids.
    Deletes are applied before inserts.  Returns a new state whose coloring
    is proper for the mutated graph; the input state is left untouched.
    ``max_rounds`` defaults to the bound persisted on the state.
    """
    if max_rounds is None:
        max_rounds = state.max_rounds
    ins = _check_edges(inserts if inserts is not None else [], state.n,
                       "inserts")
    dels = _check_edges(deletes if deletes is not None else [], state.n,
                        "deletes")
    if len(ins) == 0 and len(dels) == 0:
        return state

    # host -> relabeled space
    ins_r = state.perm[ins] if len(ins) else ins
    dels_r = state.perm[dels] if len(dels) else dels

    # traced (a tracer in scope), the batch's waves are an "apply" phase
    # beside the repair's "solve": the phase waits for its device work
    with obs.phase("apply"):
        ell, osrc, odst, U, grows = delta.apply_updates(
            state.ell, state.ovf_src, state.ovf_dst, ins_r, dels_r,
            state.delta_cap, max_grows=state.max_ovf_growth)
        if obs.current_tracer() is not None:
            col._block_until_ready((U,))

    # repair: frontier-compacted fused RSOC seeded from touched endpoints
    def run(C):
        ctx = PassContext(n=state.n, n_pad=state.n_pad, C=C,
                          n_chunks=state.n_chunks,
                          forbidden_impl=state.forbidden_impl)
        return frontier._repair_compact_loop(
            ell, osrc, odst, state.pri, state.colors_dev, U, ctx,
            state.frontier_cap, max_rounds)

    (colors2, r, trace, tot, _), C, retries = col._run_with_retry(
        run, state.C, engine="incremental", max_retries=state.max_cap_retries)
    passes = int(r)
    return dataclasses.replace(
        state, ell=ell, ovf_src=osrc, ovf_dst=odst, colors_dev=colors2,
        C=C, version=state.version + 1, last_rounds=int(r),
        last_conflicts=int(tot), last_gather_passes=passes,
        total_gather_passes=state.total_gather_passes + passes,
        retries=state.retries + retries, ovf_grows=state.ovf_grows + grows,
        last_degrade_rung=0)


# --------------------------------------------------------------------------
# registry adapter: mode="incremental" through the repro_torch.api front door
# --------------------------------------------------------------------------

@registry.register_engine("rsoc", distance=1, mode="incremental",
                          replaces="dynamic_state")
def _incremental_engine(g: CSRGraph, spec, *, device="cpu"
                        ) -> col.ColoringResult:
    """Encode ``g`` for mutation and color it from scratch once; the
    device-resident ``DynamicColoringState`` rides the result's ``state``
    field so callers (``ColoringService.add_graph``) can keep applying
    ``recolor_incremental`` update batches to it.

    With a finite ``spec.max_cap_retries`` budget the from-scratch solve can
    exhaust its cap doublings; this engine then drops straight to the serial
    oracle encoding (ladder rung 2) rather than failing the add — the
    result's ``degrade_rung`` records the downgrade."""
    opts = dict(
        seed=spec.seed, n_chunks=spec.n_chunks, ell_cap=spec.ell_cap,
        ell_slack=spec.ell_slack, ovf_cap=spec.ovf_cap,
        delta_cap=spec.delta_cap, frontier_frac=spec.frontier_frac,
        max_rounds=spec.max_rounds, forbidden_impl=spec.forbidden_impl,
        max_cap_retries=spec.max_cap_retries,
        max_ovf_growth=spec.max_ovf_growth, device=device)
    try:
        st = dynamic_state(g, C=spec.C, **opts)
    except CapRetryExhausted:
        from repro_torch.obs import metrics as _metrics
        from repro_torch.resilience import ladder
        _metrics.counter("resilience.degrade", rung="oracle").inc()
        st = ladder.encode_oracle_state(g, **opts)
    colors = st.colors
    return col.ColoringResult(
        colors=colors, n_rounds=st.last_rounds,
        conflicts_per_round=np.array([st.last_conflicts]),
        total_conflicts=st.last_conflicts,
        n_colors=col.n_colors_used(colors),
        overflow=st.retries > 0, gather_passes=st.last_gather_passes,
        final_C=st.C, retries=st.retries, distance=1, state=st,
        degrade_rung=st.last_degrade_rung)
