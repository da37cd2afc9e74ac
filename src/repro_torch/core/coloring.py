"""Parallel graph coloring: serial First-Fit, Gebremedhin-Manne (GM),
Catalyurek et al. (CAT), Jones-Plassmann (JP) and the paper's contribution
RSOC — lockstep chunks on PyTorch, the chunk pass on hand-written CUDA kernels.

Vocabulary (DESIGN.md §2, carried over from the reference package):

  * "thread concurrency" -> a *chunk*: the set of vertices (re)colored
    simultaneously in one data-parallel step.  Within a chunk execution is
    lockstep; across the ``n_chunks`` chunks of one pass execution is
    sequential and reads fresh colors — exactly a thread's sequential walk
    over its partition in the paper.  ``n_chunks`` plays the role of
    1/threads: chunk width n/n_chunks is the simulated thread count.
  * Vertices are randomly relabeled once (host-side) so a chunk is a random
    vertex sample — the paper shuffles RMAT vertex ids for the same reason.
  * CAT round = phase A: chunked re-color of the defect set U (against colors
    as of the previous detect, fresh within the pass); BARRIER; phase B:
    separate detect pass -> new U; BARRIER.  Two neighbor-gather passes,
    two materialization points per round.
  * RSOC round = ONE fused detect-and-recolor pass over U: a defect is
    repaired the moment it is seen, from the same gathered neighbor row
    ("freshest data", paper §3).  One gather pass, one materialization point.
    Repairs land a round earlier than CAT's, so rounds and conflicts drop —
    the paper's Figs. 3-6 mechanism.
  * Termination under lockstep (paper §5: SIMT livelock): conflicts are broken
    *asymmetrically* by a hashed random priority — of a conflicting edge only
    the lower-priority endpoint re-colors.  Every round the highest-priority
    defective vertex becomes permanently stable => termination in <= |V|
    rounds (observed 2-8).

How the loops run here (DESIGN_TORCH.md): a pass is a Python loop over the
chunks, and each chunk is ONE call into ``kernels.ops`` — on a CUDA device one
launch of the ``firstfit`` (round 0) or ``detect_recolor`` (repair rounds,
and CAT's phase A after round 0) kernel — followed by the commit of the
chunk's new colors.  CAT's and GM's detect pass is one detect-only launch of
``detect_recolor`` over every row.  The round loop is a host loop that reads
one value back per round (what decides termination); counters, traces and
the overflow flag stay on the device until the loop ends.  JP has no kernel
under it in the reference either: its rounds are plain torch on the device.

Graph encodings: ELL (n, width) padded neighbor table, with a COO
side-channel for overflow edges of capped-width hubs (power-law graphs).
Overflow forbidden sets are built from the pass-start snapshot, which
preserves the termination argument (the stable neighbors' colors are always
avoided).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import bitset
from repro_torch.core.context import (DEFAULT_FORBIDDEN_IMPL, PassContext,
                                      resolve_impl)
from repro_torch.graphs.csr import (CSRGraph, FILL, from_edges, to_edge_list,
                                    to_ell)
from repro_torch.kernels import ops
from repro_torch.resilience import faults
from repro_torch.resilience.errors import CapRetryExhausted

MAX_ROUNDS_TRACE = 64  # fixed-size conflict trace (one device buffer)


# --------------------------------------------------------------------------
# result container + verification
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray             # (n,) int32, >= 0, original vertex ids
    n_rounds: int                  # while-loop rounds (excl. round 0)
    conflicts_per_round: np.ndarray
    total_conflicts: int
    n_colors: int
    overflow: bool                 # True iff the color cap was ever exceeded
    gather_passes: int             # neighbor-gather sweeps executed (perf proxy)
    final_C: int = 0               # color cap actually used (after doublings)
    retries: int = 0               # cap-doubling re-runs (0 = first cap fit)
    distance: int = 1              # coloring distance (2 = native two-hop)
    degrade_rung: int = 0          # resilience ladder rung that produced
                                   # the colors (0 = normal path; see
                                   # resilience/ladder.RUNG_NAMES)
    # the resolved repro_torch.api.ColoringSpec that produced this result, echoed
    # by api.color for reproducibility (None on direct engine calls); typed
    # as object because this module must not import repro_torch.api
    spec: Optional[object] = None
    # mode="incremental" only: the DynamicColoringState behind the colors
    state: Optional[object] = None
    # True iff n_rounds exceeded the MAX_ROUNDS_TRACE device buffer, i.e.
    # conflicts_per_round is a clipped view with the tail collapsed into its
    # last slot (also warned once per process — see _trim_trace)
    trace_truncated: bool = False
    # the obs.RunTrace of this run when tracing was on (api.color attaches
    # it); typed as object because this module must not import repro_torch.obs.*
    # artifacts at class scope
    trace: Optional[object] = None

    def summary(self) -> dict:
        return {"rounds": int(self.n_rounds),
                "conflicts": int(self.total_conflicts),
                "colors": int(self.n_colors),
                "gather_passes": int(self.gather_passes),
                "final_C": int(self.final_C),
                "retries": int(self.retries),
                "distance": int(self.distance)}


_trace_truncation_warned = False


def _trim_trace(trace, n_rounds):
    """Per-round conflict trace, clipped to the rounds that actually ran.

    The device-side trace buffer is a fixed MAX_ROUNDS_TRACE slots (it is
    allocated once, before the round count is known), and rounds past it
    collapse into its last slot.  The clipping is explicit:
    returns ``(trimmed, truncated)`` where ``truncated`` lands on
    ``ColoringResult.trace_truncated``, plus a once-per-process warning the
    first time a run overruns the buffer.
    """
    global _trace_truncation_warned
    n_rounds = int(n_rounds)
    trimmed = np.asarray(trace).reshape(-1)[:min(n_rounds, MAX_ROUNDS_TRACE)]
    truncated = n_rounds > MAX_ROUNDS_TRACE
    if truncated and not _trace_truncation_warned:
        _trace_truncation_warned = True
        warnings.warn(
            f"conflicts_per_round truncated: {n_rounds} repair rounds "
            f"exceed the MAX_ROUNDS_TRACE={MAX_ROUNDS_TRACE} device trace "
            f"buffer, so rounds past it collapsed into the last slot "
            f"(ColoringResult.trace_truncated=True flags this run; this "
            f"warning fires once per process)", RuntimeWarning, stacklevel=3)
    return trimmed, truncated


def is_proper(g: CSRGraph, colors: np.ndarray) -> bool:
    colors = np.asarray(colors)
    e = to_edge_list(g)
    if len(e) == 0:
        return bool((colors >= 0).all())
    return bool((colors >= 0).all() and (colors[e[:, 0]] != colors[e[:, 1]]).all())


def n_colors_used(colors) -> int:
    return int(np.asarray(colors).max()) + 1


# --------------------------------------------------------------------------
# serial oracle (paper Algorithm 1)
# --------------------------------------------------------------------------

def greedy_sequential(g: CSRGraph) -> np.ndarray:
    """Sequential First-Fit. Host-side numpy oracle."""
    colors = np.full(g.n_vertices, -1, dtype=np.int32)
    scratch = np.zeros(g.max_degree + 2, dtype=np.int64)
    for v in range(g.n_vertices):
        nc = colors[g.neighbors(v)]
        nc = nc[nc >= 0]
        scratch[nc] = v + 1          # stamp trick: no re-clearing
        c = 0
        while scratch[c] == v + 1:
            c += 1
        colors[v] = c
    return colors


# --------------------------------------------------------------------------
# problem prep (host)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColoringProblem:
    """Device-ready relabeled graph: ELL + overflow COO + priorities."""

    ell: torch.Tensor       # (n_pad, W) int32 neighbor ids (relabeled), FILL pad
    ovf_src: torch.Tensor   # (m_ovf,) int32 overflow edges (relabeled)
    ovf_dst: torch.Tensor
    pri: torch.Tensor       # (n_pad,) int32 priority (pad rows = -1)
    n: int
    n_pad: int
    perm: np.ndarray        # old id -> new id
    C: int                  # color cap (bitmask-friendly, multiple of 32)

    @property
    def device(self) -> torch.device:
        return self.ell.device


def _pick_C(g: CSRGraph, C: Optional[int]) -> int:
    if C is not None:
        return int(C)
    # The packed-bitset forbidden set costs 4 bytes per 32 colors per row
    # (vs 1 byte/color dense), so the default cap can afford to be generous:
    # a larger cap means fewer cap-doubling retries on high-degree graphs
    # (the paper's Figs. 3-6 regime) at 1/8th the dense per-row cost.
    c = min(g.max_degree + 2, 256)
    return int(max(32, -(-c // 32) * 32))


def problem_from_numpy(ell, ovf_src, ovf_dst, pri, n: int, n_pad: int, perm,
                       C: int, device) -> ColoringProblem:
    """Numpy arrays of a prepared problem -> ``ColoringProblem`` on
    ``device``.  This is the one door through which prepared state enters
    the port, so a problem prepared elsewhere (e.g. by the reference
    package) runs through these loops on exactly the same arrays."""
    device = torch.device(device)

    def dev(a):
        a = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
        if not a.flags.writeable:      # torch tensors cannot be read-only
            a = a.copy()
        return torch.from_numpy(a).to(device)

    return ColoringProblem(
        ell=dev(ell), ovf_src=dev(ovf_src), ovf_dst=dev(ovf_dst),
        pri=dev(pri), n=int(n), n_pad=int(n_pad), perm=np.asarray(perm),
        C=int(C))


def prepare(g: CSRGraph, seed: int = 0, n_chunks: int = 16,
            ell_cap: int = 512, C: Optional[int] = None,
            relabel: bool = True, device="cpu") -> ColoringProblem:
    n = g.n_vertices
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int64) if relabel else np.arange(n)
    if relabel:
        edges = perm[to_edge_list(g).astype(np.int64)]
        g = from_edges(n, edges, symmetrize=False)
    n_pad = -(-max(n, n_chunks) // n_chunks) * n_chunks
    W = max(1, min(g.max_degree, ell_cap))
    deg = g.degrees
    if g.max_degree <= ell_cap:
        ell = to_ell(g, max_degree=W, pad_vertices_to=n_pad)
        osrc = np.zeros((0,), np.int32)
        odst = np.zeros((0,), np.int32)
    else:
        ell = np.full((n_pad, W), FILL, dtype=np.int32)
        row = np.repeat(np.arange(n), deg)
        col = np.arange(g.n_edges) - np.repeat(g.indptr[:-1], deg)
        in_ell = col < W
        ell[row[in_ell], col[in_ell]] = g.indices[in_ell]
        osrc = row[~in_ell].astype(np.int32)
        odst = g.indices[~in_ell].astype(np.int32)
    # independent random priorities (asymmetric tie-break)
    pri = np.full(n_pad, -1, np.int32)
    pri[:n] = rng.permutation(n).astype(np.int32)
    return problem_from_numpy(ell, osrc, odst, pri, n, n_pad, perm,
                              _pick_C(g, C), device)


def _unpermute(colors_new, perm: np.ndarray, n: int) -> np.ndarray:
    """Map colors from relabeled space back to original ids.

    ``perm`` maps old id -> new id, so colors_old[i] = colors_new[perm[i]].
    """
    return _to_numpy(colors_new)[perm[:n]]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# device primitives (plain torch; they run outside the kernels)
# --------------------------------------------------------------------------

def _forbidden_coo(src, dst, colors, n_rows, C):
    """COO forbidden sets; FILL (-1) entries in src/dst are dead slots."""
    live = (src >= 0) & (dst >= 0)
    nbr_c = colors[dst.clamp(0, colors.shape[0] - 1).long()]
    ok = live & (nbr_c >= 0) & (nbr_c < C)
    forb = torch.zeros((n_rows, C), dtype=torch.uint8, device=colors.device)
    # scatter of ones on the selected live entries: duplicates all write 1
    forb[src[ok].clamp(0, n_rows - 1).long(), nbr_c[ok].long()] = 1
    return forb


def _mex(forb):
    """First zero per row of a dense (rows, C) table, 0 on a full row.
    (A masked ``amin`` over the column index: exact on every device, where
    ``argmin``'s choice among equal minima is not a stated guarantee.)"""
    C = forb.shape[-1]
    idx = torch.arange(C, dtype=torch.int32, device=forb.device)
    cand = torch.where(forb > 0, torch.full((), C, dtype=torch.int32,
                                            device=forb.device), idx)
    mex = cand.amin(dim=-1).to(torch.int32)
    ovf = mex >= C
    return torch.where(ovf, torch.zeros_like(mex), mex), ovf


# ---- forbidden-set representation dispatch (bitset | dense) --------------
#
# ``impl`` rides in ctx.  The chunk pass itself goes through ``kernels.ops``
# (whose CUDA kernels are the packed expression by construction); these
# helpers serve the plain-torch parts around it and keep the two
# representations bit-identical by contract.

def _forbidden(nbrc, C, impl):
    """(rows, W) gathered neighbor colors -> forbidden table (inline pack)."""
    if impl == "dense":
        return _forbidden_from_nbrc(nbrc, C)
    return bitset.pack_from_nbrc(nbrc, C)


def _mex_of(forb, C, impl):
    """Smallest free color + overflow flag per row of a forbidden table."""
    if impl == "dense":
        return _mex(forb)
    return bitset.mex_words(forb, C)


def _merge_forbidden(a, b, impl):
    """Union of two forbidden tables (gathered row ∪ COO snapshot slice)."""
    if impl == "dense":
        return torch.maximum(a, b)
    return a | b


def _snapshot_coo(src, dst, colors, n_rows, C, impl):
    """Pass-start COO snapshot table: scatter dense, then (bitset) pack —
    torch scatters have no bitwise-or mode, so the packed path routes the
    one-off scatter through a transient dense table and retains only the
    packed words (see bitset.pack_dense)."""
    dense = _forbidden_coo(src, dst, colors, n_rows, C)
    if impl == "dense":
        return dense
    return bitset.pack_dense(dense, C)


def _ovf_conflict(osrc, odst, colors, pri, n_rows):
    """Per-row defect flags from overflow edges (FILL slots are dead)."""
    live = (osrc >= 0) & (odst >= 0)
    s = osrc.clamp(0, colors.shape[0] - 1).long()
    d = odst.clamp(0, colors.shape[0] - 1).long()
    conf = live & (colors[s] == colors[d]) & (colors[s] >= 0) & (pri[d] > pri[s])
    out = torch.zeros((n_rows,), dtype=torch.bool, device=colors.device)
    out[osrc[conf].clamp(0, n_rows - 1).long()] = True
    return out


def _gather_nbr(ell_k, colors, pri):
    """Neighbor colors + priorities for a block of ELL rows."""
    safe = ell_k.clamp(0, colors.shape[0] - 1).long()
    m = ell_k >= 0
    neg = torch.full((), -1, dtype=torch.int32, device=ell_k.device)
    return torch.where(m, colors[safe], neg), torch.where(m, pri[safe], neg)


def _forbidden_from_nbrc(nbrc, C):
    rows = nbrc.shape[0]
    ok = (nbrc >= 0) & (nbrc < C)
    forb = torch.zeros((rows, C), dtype=torch.uint8, device=nbrc.device)
    r = torch.arange(rows, device=nbrc.device)[:, None].expand_as(nbrc)
    forb[r[ok], nbrc[ok].long()] = 1
    return forb


def _chunked_pass(ctx, ell, osrc, odst, pri, colors, U, force, *,
                  detect: bool, valid=None, sparse: bool = False):
    """One sequential sweep over n_chunks chunks; **updates ``colors`` in
    place** (the caller owns the tensor) and returns it.

    detect=False (round 0, CAT phase A): re-color every vertex in U | force,
                                through the ``firstfit`` kernel — or, with
                                ``sparse``, through ``detect_recolor`` with
                                U all false and ``force`` the work mask.
    detect=True  (RSOC fused) : re-color a vertex in U only if it is
                                defective right now (fresh check), or forced,
                                through the ``detect_recolor`` kernel.
    Each chunk is one call into ``kernels.ops`` — one kernel launch on a CUDA
    device — and the chunk's colors are committed after it.

    ``sparse`` is for a work set that is a small part of the rows (CAT's
    phase A after round 0 re-colors only the defect set): ``firstfit``
    computes every row of its chunk, while ``detect_recolor`` skips the rows
    that cannot work.  Forced rows take their mex, whatever their own color
    (the mex never reads it), so both routes give the same colors, flags
    and overflow bit for bit.

    With ``detect=True`` the forced rows must be uncolored (``colors < 0``,
    as ``_fused_repair`` builds them): such a row is never defective, which
    is what lets the defect count be read off the kernel's ``recolored``
    output as ``recolored & ~force``.

    ``valid`` overrides the default prefix validity mask (length
    ``ctx.n_pad``).  ``colors``/``pri`` may be longer than ``ctx.n_pad``:
    only the first ``n_pad`` rows are swept, but gathers read the full table.
    Returns (colors, recolored_mask, n_defects, overflowed); the last two are
    0-dim device tensors.
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    cs = n_pad // n_chunks
    device = ell.device
    valid_row = (torch.arange(n_pad, device=device) < n
                 if valid is None else valid)
    has_ovf = osrc.shape[0] > 0
    # the overflow-COO snapshot and the overflow-edge conflicts are evaluated
    # once, on the pass-start colors, before any chunk commits.  (Conflicts
    # only ever arise between two vertices recolored in the same earlier
    # pass, so the snapshot view is sufficient for detection; see module
    # docstring termination argument.)
    forb0 = ovf_defect = None
    if has_ovf:
        snap = _snapshot_coo(osrc, odst, colors, n_pad, C, impl)
        # ops.* take the snapshot as packed words whatever ``impl`` is
        forb0 = snap if impl == "bitset" else bitset.pack_dense(snap, C)
        if detect:
            ovf_defect = _ovf_conflict(osrc, odst, colors, pri, n_pad)
    if not detect:
        work_all = valid_row & (U | force)
        if sparse:
            no_u = torch.zeros((n_pad,), dtype=torch.bool, device=device)

    recolored = torch.empty((n_pad,), dtype=torch.bool, device=device)
    ovf_rows = torch.empty((n_pad,), dtype=torch.bool, device=device)
    for k in range(n_chunks):
        lo, hi = k * cs, (k + 1) * cs
        f0 = forb0[lo:hi] if has_ovf else None
        if detect:
            newc, rec, ovf_k = ops.detect_recolor(
                ell[lo:hi], colors, pri, U[lo:hi], lo, C, impl=impl, forb0=f0,
                extra_defect=(ovf_defect[lo:hi] if ovf_defect is not None
                              else None),
                force=force[lo:hi], valid=valid_row[lo:hi])
        elif sparse:
            newc, rec, ovf_k = ops.detect_recolor(
                ell[lo:hi], colors, pri, no_u[lo:hi], lo, C, impl=impl,
                forb0=f0, force=work_all[lo:hi])
        else:
            mex, full = ops.firstfit(ell[lo:hi], colors, C, impl=impl,
                                     forb0=f0)
            newc, rec, ovf_k = bitset.apply_recolor(
                work_all[lo:hi], mex, full, colors[lo:hi])
        # The commit happens AFTER the launch, in place: within the chunk
        # every row read the pre-chunk colors (the kernel writes newc, never
        # colors), and the next chunk's launch — ordered behind this copy on
        # the stream — reads the fresh ones (DESIGN.md §2).
        colors[lo:hi] = newc
        recolored[lo:hi] = rec
        ovf_rows[lo:hi] = ovf_k
    if detect:
        n_def = (recolored & ~force).sum(dtype=torch.int32)
    else:
        n_def = torch.zeros((), dtype=torch.int32, device=device)
    return colors, recolored, n_def, ovf_rows.any()


def _detect_pass(ctx, ell, osrc, odst, pri, colors, U):
    """CAT phase B: standalone defect detection over U (a full gather pass).

    ONE detect-only launch of the ``detect_recolor`` kernel over all
    ``n_pad`` rows (``row_start=0``), as the reference's single full-width
    gather: it reads the pass-start colors and commits nothing, so no chunk
    waits for another.  Overflow-edge conflicts are OR-ed in
    (``extra_defect``).  Returns the (n_pad,) bool ``defect & U & valid``.
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    valid_row = torch.arange(n_pad, device=ell.device) < n
    extra = (_ovf_conflict(osrc, odst, colors, pri, n_pad)
             if osrc.shape[0] > 0 else None)
    return ops.detect_recolor(ell, colors, pri, U, 0, C, impl=impl,
                              extra_defect=extra, valid=valid_row,
                              detect_only=True)


# --------------------------------------------------------------------------
# algorithm loops
# --------------------------------------------------------------------------

def _fused_repair(ctx, ell, osrc, odst, pri, colors, U, max_rounds,
                  ovf0=False):
    """Fused detect-and-recolor rounds from an arbitrary (colors, U) start;
    **updates ``colors`` in place**.

    This is the RSOC inner loop factored out of the from-scratch loop so a
    caller can supply its own seed set U and partial coloring.  Vertices in U
    are re-colored only when defective *right now*; uncolored seeds
    (colors < 0) are force-colored on their first pass.  Returns
    (colors, n_rounds, trace, total_defects, ovf) — one neighbor-gather pass
    per round — or, under ``ctx.trace``, (colors, n_rounds, trace, ftrace,
    total_defects, ovf) with a per-round |U| trace spliced in BEFORE the
    trailing pair so the retry contract (overflow flag last) survives.

    The round loop runs on the host and reads ONE integer back per round
    (the work count that decides termination).  ``trace``, ``ftrace``,
    ``total_defects`` and ``ovf`` stay device tensors; ``n_rounds`` is a
    Python int.  With ``ctx.trace`` False nothing else is read back.
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    trace = torch.zeros((MAX_ROUNDS_TRACE,), dtype=torch.int32, device=device)
    ftrace = (torch.zeros((MAX_ROUNDS_TRACE,), dtype=torch.int32,
                          device=device) if ctx.trace else None)
    tot = torch.zeros((), dtype=torch.int32, device=device)
    ovf = (ovf0.clone() if isinstance(ovf0, torch.Tensor)
           else torch.tensor(bool(ovf0), device=device))
    r, last_def = 0, 1
    # terminate when a full fused pass detected zero defects: colors were
    # untouched during that pass, so its detection was complete.
    while last_def > 0 and r < max_rounds:
        slot = min(r, MAX_ROUNDS_TRACE - 1)
        if ctx.trace:
            ftrace[slot] = U.sum(dtype=torch.int32)
        force = U & (colors[:n_pad] < 0)
        # ONE fused detect-and-recolor pass
        colors, recolored, n_def, ovf2 = _chunked_pass(
            ctx, ell, osrc, odst, pri, colors, U, force, detect=True)
        trace[slot] = n_def
        # forced vertices were colored speculatively, not verified: keep the
        # loop alive so the next pass checks them (two adjacent uncolored
        # seeds can pick the same color from one snapshot)
        n_work = n_def + force.sum(dtype=torch.int32)
        U, r, tot, ovf = recolored, r + 1, tot + n_def, ovf | ovf2
        last_def = int(n_work)      # the one host read-back of the round
    if ctx.trace:
        return colors, r, trace, ftrace, tot, ovf
    return colors, r, trace, tot, ovf


def _rsoc_loop(ell, osrc, odst, pri, ctx, max_rounds):
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    colors0 = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    valid = torch.arange(n_pad, device=device) < n
    zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)

    # round 0: tentative coloring of the whole graph (chunked, fresh)
    colors1, U, _, ovf0 = _chunked_pass(
        ctx, ell, osrc, odst, pri, colors0, zeros, valid, detect=False)
    out = _fused_repair(
        ctx, ell, osrc, odst, pri, colors1, U, max_rounds, ovf0)
    return (out[0][:n],) + out[1:]


def _rsoc_repair_loop(ell, osrc, odst, pri, colors, U, ctx, max_rounds):
    """Externally-seeded fused repair (full-width passes; no round 0).  The
    caller's ``colors`` is left untouched: the loop works on a copy."""
    return _fused_repair(ctx, ell, osrc, odst, pri, colors.clone(), U,
                         max_rounds)


def _cat_loop(ell, osrc, odst, pri, ctx, max_rounds):
    """CAT's rounds.  A host loop that reads ONE value back per round
    (``U.any()``, which decides termination); ``trace``, ``tot`` and ``ovf``
    stay device tensors, ``n_rounds`` is a Python int.  Returns (colors[:n],
    n_rounds, trace, total_conflicts, ovf)."""
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    colors = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    valid = torch.arange(n_pad, device=device) < n
    zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)

    # round 0 phase A: color everything (chunked, fresh within pass)
    colors, _, _, ovf = _chunked_pass(
        ctx, ell, osrc, odst, pri, colors, zeros, valid, detect=False)
    # round 0 phase B: detect                                   (pass 2)
    U = _detect_pass(ctx, ell, osrc, odst, pri, colors, valid)
    trace = torch.zeros((MAX_ROUNDS_TRACE,), dtype=torch.int32, device=device)
    tot = torch.zeros((), dtype=torch.int32, device=device)
    r = 0
    while r < max_rounds and bool(U.any()):   # the one host read-back
        n_def = U.sum(dtype=torch.int32)
        trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
        # phase A: re-color the defect set                      (pass 1)
        colors, _, _, ovf2 = _chunked_pass(
            ctx, ell, osrc, odst, pri, colors, U, zeros, detect=False,
            sparse=True)
        # phase B: separate detect pass                         (pass 2)
        U = _detect_pass(ctx, ell, osrc, odst, pri, colors, U)
        r, tot, ovf = r + 1, tot + n_def, ovf | ovf2
    return colors[:n], r, trace, tot, ovf


def _gm_round0(ell, osrc, odst, pri, ctx):
    """GM's speculative pass and its detect pass: (colors, defect, ovf)."""
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    colors0 = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    valid = torch.arange(n_pad, device=device) < n
    zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)
    colors1, _, _, ovf = _chunked_pass(
        ctx, ell, osrc, odst, pri, colors0, zeros, valid, detect=False)
    defect = _detect_pass(ctx, ell, osrc, odst, pri, colors1, valid)
    return colors1, defect, ovf


def _jp_loop(src, dst, pri, n: int, C: int, max_rounds: int,
             impl: str = DEFAULT_FORBIDDEN_IMPL):
    """Jones-Plassmann rounds over the COO edge list, plain torch on the
    tensors' device: the reference runs them in jnp with no Pallas kernel
    under them, so this is their port (and they go through no ``ops``
    dispatcher).  A host loop that reads ONE value back per round (whether
    a vertex is still uncolored).  Returns (colors, n_rounds, ovf)."""
    device = pri.device
    colors = torch.full((n,), -1, dtype=torch.int32, device=device)
    ovf = torch.zeros((), dtype=torch.bool, device=device)
    neg = torch.full((), -1, dtype=torch.int32, device=device)
    s, d = src.long(), dst.long()
    r = 0
    while r < max_rounds and bool((colors < 0).any()):
        uncolored = colors < 0
        nbr_pri = torch.where(uncolored[d], pri[d], neg)
        best = torch.full((n,), -1, dtype=torch.int32,
                          device=device).scatter_reduce_(
            0, s, nbr_pri, "amax", include_self=True)
        elig = uncolored & (pri > best)
        forb = _snapshot_coo(src, dst, colors, n, C, impl)
        mex, o = _mex_of(forb, C, impl)
        colors = torch.where(elig, mex, colors)
        r, ovf = r + 1, ovf | (o & elig).any()
    return colors, r, ovf


# --------------------------------------------------------------------------
# the shared retry loop and its adapters
# --------------------------------------------------------------------------

def _block_until_ready(out):
    """Wait for the device work behind a loop's outputs (the port's form of
    the reference's block-until-ready rule for phase timers)."""
    for x in out:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            break
    return out


def _run_with_retry(run, C: int, *, engine: str = "",
                    max_retries: Optional[int] = None):
    """Run ``run(C)``, doubling the color cap until it fits.

    ``run`` returns any tuple whose LAST element is the boolean overflow
    flag.  This is the single cap-doubling loop shared by every engine —
    they differ only in the closure they pass.  Returns
    (run output, final C, number of cap-doubling retries).

    ``max_retries`` bounds the doublings (``ColoringSpec.max_cap_retries``):
    a pathological graph/cap pair raises ``CapRetryExhausted`` instead of
    spinning.  ``None`` keeps the unbounded loop.  The ``cap.exhaust`` fault
    site rides here too — host-side, before any launch.

    Observability rides here precisely because every engine funnels through:
    each attempt is a ``solve`` phase on the current tracer (synchronizing
    the device so the wall time is real — only when a tracer is active), and
    each doubling bumps the ``engine.cap_retry{engine=...}`` counter.
    """
    retries = 0
    while True:
        if faults.fires("cap.exhaust", engine=engine):
            raise CapRetryExhausted(engine=engine, C=C, retries=retries,
                                    budget=max_retries, forced=True)
        tracer = obs.current_tracer()
        if tracer is None:
            out = run(C)
        else:
            with tracer.phase("solve", C=int(C), attempt=retries):
                out = _block_until_ready(run(C))
        if not bool(out[-1]):
            return out, C, retries
        if max_retries is not None and retries >= max_retries:
            raise CapRetryExhausted(engine=engine, C=C, retries=retries,
                                    budget=max_retries)
        C *= 2  # rare: color cap exceeded -> retry with doubled cap
        retries += 1
        obs.metrics.counter("engine.cap_retry",
                            engine=engine or "unknown").inc()


def _prob_runner(loop, prob: ColoringProblem, n_chunks: int, max_rounds: int,
                 impl: str, trace: bool = False):
    """Adapt the standard from-scratch loop signature to ``_run_with_retry``."""
    def run(C):
        ctx = PassContext.for_problem(prob, n_chunks=n_chunks, C=C,
                                      forbidden_impl=impl, trace=trace)
        return loop(prob.ell, prob.ovf_src, prob.ovf_dst, prob.pri,
                    ctx, max_rounds)
    return run


def _loop_outputs(out, traced: bool):
    """Split a retry-loop output tuple into (colors, r, trace, ftrace, tot).

    The traced loop returns six elements (frontier trace spliced before
    the trailing (tot, ovf) pair), the plain loop five; ftrace is None
    when the loop did not collect one.
    """
    if traced:
        colors, r, trace, ftrace, tot, _ = out
        return colors, r, trace, ftrace, tot
    colors, r, trace, tot, _ = out
    return colors, r, trace, None, tot


def _report_frontier(tracer, ftrace, r, cap=None):
    """Hand a loop-carried frontier trace to the tracer, clipped like the
    conflict trace is."""
    if tracer is not None and ftrace is not None:
        trimmed = _to_numpy(ftrace).reshape(-1)[
            :min(int(r), MAX_ROUNDS_TRACE)]
        tracer.set_frontier_trace(trimmed, cap=cap)


# --------------------------------------------------------------------------
# registered engines (the implementations behind repro_torch.api.color)
# --------------------------------------------------------------------------

@registry.register_engine("rsoc", distance=1, mode="static",
                          replaces="color_rsoc")
def _rsoc_engine(g: CSRGraph, spec, *, device="cpu") -> ColoringResult:
    """RSOC (paper Alg. 3): fused detect-and-recolor, one pass per round."""
    impl = resolve_impl(spec.forbidden_impl)
    tracer = obs.current_tracer()
    with obs.phase("prepare"):
        prob = prepare(g, spec.seed, spec.n_chunks, spec.ell_cap, spec.C,
                       spec.relabel, device=device)
    out, final_C, retries = _run_with_retry(
        _prob_runner(_rsoc_loop, prob, spec.n_chunks, spec.max_rounds, impl,
                     trace=tracer is not None),
        prob.C, engine="rsoc", max_retries=spec.max_cap_retries)
    colors, r, trace, ftrace, tot = _loop_outputs(out, tracer is not None)
    _report_frontier(tracer, ftrace, r)
    conf, truncated = _trim_trace(_to_numpy(trace), r)
    colors = _unpermute(colors, prob.perm, prob.n)
    return ColoringResult(colors=colors, n_rounds=int(r),
                          conflicts_per_round=conf,
                          total_conflicts=int(tot),
                          n_colors=n_colors_used(colors),
                          overflow=retries > 0,
                          gather_passes=1 + int(r),
                          final_C=final_C, retries=retries,
                          trace_truncated=truncated)


@registry.register_engine("cat", distance=1, mode="static",
                          replaces="color_cat")
def _cat_engine(g: CSRGraph, spec, *, device="cpu") -> ColoringResult:
    """Catalyurek et al. (paper Alg. 2): two-phase rounds."""
    impl = resolve_impl(spec.forbidden_impl)
    tracer = obs.current_tracer()
    with obs.phase("prepare"):
        prob = prepare(g, spec.seed, spec.n_chunks, spec.ell_cap, spec.C,
                       spec.relabel, device=device)
    (colors, r, trace, tot, _), final_C, retries = _run_with_retry(
        _prob_runner(_cat_loop, prob, spec.n_chunks, spec.max_rounds, impl),
        prob.C, engine="cat", max_retries=spec.max_cap_retries)
    conf, truncated = _trim_trace(_to_numpy(trace), r)
    # CAT's frontier IS its conflict count: a round re-colors exactly the
    # defect set U detected by the previous phase B, so no extra device
    # collection is needed (the traced and untraced loops are identical).
    _report_frontier(tracer, conf, r)
    colors = _unpermute(colors, prob.perm, prob.n)
    return ColoringResult(colors=colors, n_rounds=int(r),
                          conflicts_per_round=conf,
                          total_conflicts=int(tot),
                          n_colors=n_colors_used(colors),
                          overflow=retries > 0,
                          gather_passes=2 * (1 + int(r)),
                          final_C=final_C, retries=retries,
                          trace_truncated=truncated)


@registry.register_engine("gm", distance=1, mode="static",
                          replaces="color_gm")
def _gm_engine(g: CSRGraph, spec, *, device="cpu") -> ColoringResult:
    """Gebremedhin-Manne: speculate, detect, serial repair (one round —
    ``spec.max_rounds`` is inert for this engine)."""
    impl = resolve_impl(spec.forbidden_impl)
    with obs.phase("prepare"):
        prob = prepare(g, spec.seed, spec.n_chunks, spec.ell_cap, spec.C,
                       spec.relabel, device=device)
    ctx = PassContext.for_problem(prob, n_chunks=spec.n_chunks,
                                  forbidden_impl=impl)
    with obs.phase("solve", C=prob.C):
        colors, defect, ovf = _block_until_ready(
            _gm_round0(prob.ell, prob.ovf_src, prob.ovf_dst, prob.pri, ctx))
    colors_np = _to_numpy(colors[:prob.n]).copy()
    defect_np = _to_numpy(defect[:prob.n])
    # serial repair in the *relabeled* space: rebuild neighbor lists from ELL
    # plus the COO overflow side-channel (capped-width hub rows spill there —
    # skipping it produced improper repairs on power-law graphs).
    with obs.phase("serial_repair",
                   n_defects=int(defect_np.sum())):
        ell_np = _to_numpy(prob.ell)
        osrc_np = _to_numpy(prob.ovf_src)
        odst_np = _to_numpy(prob.ovf_dst)
        order = np.argsort(osrc_np, kind="stable")
        osrc_sorted, odst_sorted = osrc_np[order], odst_np[order]
        for v in np.nonzero(defect_np)[0]:
            nb = ell_np[v]
            nb = nb[(nb >= 0) & (nb < prob.n)]
            if len(osrc_sorted):
                lo, hi = np.searchsorted(osrc_sorted, [v, v + 1])
                nb = np.concatenate([nb, odst_sorted[lo:hi]])
            nc = colors_np[nb]
            used = set(int(x) for x in nc if x >= 0)
            c = 0
            while c in used:
                c += 1
            colors_np[v] = c
    tot = int(defect_np.sum())
    colors_out = _unpermute(colors_np, prob.perm, prob.n)
    return ColoringResult(colors=colors_out, n_rounds=1,
                          conflicts_per_round=np.array([tot]),
                          total_conflicts=tot,
                          n_colors=n_colors_used(colors_out),
                          overflow=bool(ovf),
                          gather_passes=2, final_C=prob.C, retries=0)


@registry.register_engine("jp", distance=1, mode="static",
                          replaces="color_jp")
def _jp_engine(g: CSRGraph, spec, *, device="cpu") -> ColoringResult:
    """Jones-Plassmann priority-MIS baseline (COO formulation; the ELL/chunk
    fields of the spec — n_chunks, ell_cap, relabel — are inert here)."""
    impl = resolve_impl(spec.forbidden_impl)
    n = g.n_vertices

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                ).to(device)

    with obs.phase("prepare"):
        e = to_edge_list(g)
        src, dst = dev(e[:, 0]), dev(e[:, 1])
        pri = dev(np.random.default_rng(spec.seed).permutation(n))
    (colors, r, _), Cv, retries = _run_with_retry(
        lambda Cv: _jp_loop(src, dst, pri, n, Cv, spec.max_rounds, impl),
        _pick_C(g, spec.C), engine="jp",
        max_retries=spec.max_cap_retries)
    colors = _to_numpy(colors)
    if (colors < 0).any():
        # never silent: a JP round bound that is too small would otherwise
        # return a partial coloring with -1 entries (adversarial priority
        # chains need one round per step)
        raise RuntimeError(
            f"JP left {int((colors < 0).sum())} vertices uncolored after "
            f"max_rounds={spec.max_rounds}; raise ColoringSpec.max_rounds "
            f"(JP needs one round per step of its longest decreasing "
            f"priority path)")
    return ColoringResult(colors=colors, n_rounds=int(r),
                          conflicts_per_round=np.zeros(1),
                          total_conflicts=0,
                          n_colors=n_colors_used(colors),
                          overflow=retries > 0,
                          gather_passes=int(r),
                          final_C=Cv, retries=retries)


# --------------------------------------------------------------------------
# legacy entry points: thin deprecation shims over repro_torch.api.color
# --------------------------------------------------------------------------

def color_rsoc(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
               n_chunks: int = 16, max_rounds: int = 1000,
               ell_cap: int = 512, relabel: bool = True,
               forbidden_impl: Optional[str] = None, *,
               device=None) -> ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, algorithm="rsoc", ...)``.
    ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_rsoc", "algorithm='rsoc'", g, algorithm="rsoc", seed=seed,
        C=C, n_chunks=n_chunks, max_rounds=max_rounds, ell_cap=ell_cap,
        relabel=relabel, forbidden_impl=forbidden_impl, device=device)


def color_cat(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
              n_chunks: int = 16, max_rounds: int = 1000,
              ell_cap: int = 512, relabel: bool = True,
              forbidden_impl: Optional[str] = None, *,
              device=None) -> ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, algorithm="cat", ...)``.
    ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_cat", "algorithm='cat'", g, algorithm="cat", seed=seed,
        C=C, n_chunks=n_chunks, max_rounds=max_rounds, ell_cap=ell_cap,
        relabel=relabel, forbidden_impl=forbidden_impl, device=device)


def color_gm(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
             n_chunks: int = 16, ell_cap: int = 512,
             relabel: bool = True,
             forbidden_impl: Optional[str] = None, *,
             device=None) -> ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, algorithm="gm", ...)``.
    ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_gm", "algorithm='gm'", g, algorithm="gm", seed=seed,
        C=C, n_chunks=n_chunks, ell_cap=ell_cap, relabel=relabel,
        forbidden_impl=forbidden_impl, device=device)


def color_jp(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
             max_rounds: int = 10000,
             forbidden_impl: Optional[str] = None, *,
             device=None) -> ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, algorithm="jp", ...)``.
    ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_jp", "algorithm='jp'", g, algorithm="jp", seed=seed, C=C,
        max_rounds=max_rounds, forbidden_impl=forbidden_impl, device=device)


class _AlgorithmsView(Mapping):
    """``ALGORITHMS`` as a live registry view (DESIGN.md §11).

    Keys are the algorithm names registered for the classic combo
    (distance=1, mode="static", backend="local"); values are callables
    ``fn(g, **overrides) -> ColoringResult`` that route through
    ``repro_torch.api.color`` — the supported bulk interface, so unlike the
    ``color_*`` shims it does not emit deprecation warnings.  ``overrides``
    are spec fields and ``api.color``'s ``device``.
    """

    def _names(self) -> list[str]:
        from repro_torch import api
        return api.algorithms()   # the (1, "static", "local") slice

    def __getitem__(self, name: str):
        if name not in self._names():
            raise KeyError(name)

        def run(g, **overrides):
            from repro_torch import api
            return api.color(g, algorithm=name, **overrides)

        run.__name__ = f"color_via_registry[{name}]"
        return run

    def __iter__(self):
        return iter(self._names())

    def __len__(self) -> int:
        return len(self._names())

    def __repr__(self) -> str:
        return f"ALGORITHMS({', '.join(self._names())})"


ALGORITHMS = _AlgorithmsView()
