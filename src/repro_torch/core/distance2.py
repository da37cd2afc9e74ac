"""Distance-2 coloring: native fused two-hop engine + materialized oracle
(the port of the reference's ``core/distance2.py``).

The paper's §6 outlook argues RSOC's edge over CAT grows with density,
making it the natural engine for distance-2 coloring — but materializing G²
costs |E(G²)| ≈ n·deg² memory.  The native engine colors G² *without ever
constructing it*: one fused **two-hop pass** walks the ELL table twice (for
each vertex: neighbor colors, then each neighbor's own ELL row) and feeds a
single packed forbidden set, wired into the same speculative
detect-and-recolor loop as distance-1 RSOC (chunked passes,
``frontier._compact_repair`` frontier compaction).

Semantics: vertex v's forbidden set is the colors of every u ≠ v within
distance ≤ 2; defects are broken asymmetrically by the same hashed priority
as distance-1, so the termination argument carries over — the conflict
graph is G², not G.

``color_bipartite_partial`` is the Jacobian-compression entry point:
distance-2 color only one side of a bipartite graph.  It is the same
two-hop pass restricted to a row mask — hop-1 neighbors (the other side)
stay uncolored, so only the two-hop (same-side, shared-neighbor) colors
bite.

How the passes run here (DESIGN_TORCH.md): every chunk of every pass, round
0 included, is ONE ``kernels.ops.twohop`` call — on a CUDA device one launch
of the ``twohop_detect_recolor`` kernel — followed by the commit of the
chunk's colors.  The materialized ``power_graph`` path is kept as the oracle
(``color_distance_d`` / ``is_distance_d_proper``); the native path requires
the full adjacency in ELL (no overflow side-channel) and raises when
``max_degree > ell_cap``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import bitset
from repro_torch.core import coloring as col
from repro_torch.core import frontier as fr
from repro_torch.core.context import PassContext, resolve_impl
from repro_torch.graphs.csr import CSRGraph, power_graph, to_edge_list
from repro_torch.kernels import ops, ref


# --------------------------------------------------------------------------
# materialized oracle path (the ground truth the native engine is
# differentially tested against)
# --------------------------------------------------------------------------

def color_distance_d(g: CSRGraph, d: int = 2, algorithm: str = "rsoc", *,
                     device=None, **kwargs
                     ) -> tuple[col.ColoringResult, CSRGraph]:
    """Color G^d by materializing the power graph (oracle path), with the
    distance-1 static engine ``col.ALGORITHMS[algorithm]`` (an unknown name
    raises ``KeyError``).  ``device`` as for ``api.color``."""
    gd = power_graph(g, d)
    fn = col.ALGORITHMS[algorithm]
    res = dataclasses.replace(fn(gd, device=device, **kwargs), distance=d)
    return res, gd


def is_distance_d_proper(g: CSRGraph, colors: np.ndarray, d: int) -> bool:
    return col.is_proper(power_graph(g, d), colors)


def is_bipartite_partial_proper(g: CSRGraph, n_left: int,
                                colors: np.ndarray) -> bool:
    """Proper one-sided distance-2 coloring: every pair of left vertices
    (ids < n_left) sharing a neighbor has distinct colors, all colored."""
    colors = np.asarray(colors)
    if (colors[:n_left] < 0).any():
        return False
    e = to_edge_list(power_graph(g, 2))
    sel = (e[:, 0] < n_left) & (e[:, 1] < n_left)
    e = e[sel]
    if len(e) == 0:
        return True
    return bool((colors[e[:, 0]] != colors[e[:, 1]]).all())


def bipartite_partial_oracle(g: CSRGraph, n_left: int) -> np.ndarray:
    """Serial greedy one-sided distance-2 coloring (host-side numpy oracle,
    the partial-coloring analogue of ``coloring.greedy_sequential``)."""
    colors = np.full(n_left, -1, dtype=np.int32)
    for v in range(n_left):
        used = set()
        for w in g.neighbors(v):
            for x in g.neighbors(w):
                if x != v and x < n_left and colors[x] >= 0:
                    used.add(int(colors[x]))
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


# --------------------------------------------------------------------------
# native engine: fused two-hop passes
# --------------------------------------------------------------------------

def _twohop_gather(ell, colors, pri, row_ids, n_pad):
    """Colors/priorities of every vertex within two hops of each row, the
    plain expression of what one chunk of a two-hop pass gathers.

    Returns (allc, allp), both (R, W + W²): hop-1 neighbor colors followed by
    hop-2 colors gathered through each neighbor's own ELL row.  Dead slots
    and the row vertex itself carry -1, so they never forbid a color or flag
    a defect.  (The passes below call ``ops.twohop``, whose plain version
    gathers through the same ``ref.twohop_panels``.)
    """
    e1 = ell[row_ids.clamp(0, n_pad - 1).long()]          # (R, W) hop-1 ids
    return ref.twohop_panels(e1, ell, colors, pri, row_ids, n_pad)


def _d2_chunked_pass(ctx, ell, pri, rows_mask, colors, U, force, *,
                     detect: bool):
    """One sequential two-hop sweep over n_chunks chunks; **updates
    ``colors`` in place**.

    The distance-2 mirror of ``coloring._chunked_pass`` (same fused
    detect-and-recolor contract, fresh colors across chunks), each chunk one
    ``ops.twohop`` call.  ``rows_mask`` is the set of rows that participate
    at all — ``arange < n`` for plain distance-2, the left-side mask for
    bipartite partial coloring.  With ``detect`` the forced rows must be
    uncolored (``_compact_repair`` builds ``force = U & (colors < 0)``):
    such a row is never defective, so the defect count ``valid & U &
    defect`` is read off the kernel's output as ``recolored & ~force``.
    Returns (colors, recolored_mask, n_defects, overflowed).
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    cs = n_pad // n_chunks
    device = colors.device
    recolored = torch.empty((n_pad,), dtype=torch.bool, device=device)
    ovf_rows = torch.empty((n_pad,), dtype=torch.bool, device=device)
    for k in range(n_chunks):
        lo, hi = k * cs, (k + 1) * cs
        newc, rec, o = ops.twohop(
            ell[lo:hi], ell, colors, pri, U[lo:hi], lo, C, impl=impl,
            force=force[lo:hi], valid=rows_mask[lo:hi], detect=detect)
        colors[lo:hi] = newc            # commit after the launch
        recolored[lo:hi] = rec
        ovf_rows[lo:hi] = o
    if detect:
        n_def = (recolored & ~force).sum(dtype=torch.int32)
    else:
        n_def = torch.zeros((), dtype=torch.int32, device=device)
    return colors, recolored, n_def, ovf_rows.any()


def _d2_compact_pass(ctx, ell, pri, colors, idx, idx_valid, count: int):
    """Two-hop fused pass over a compacted frontier-index buffer (the
    distance-2 mirror of ``frontier._slot_pass``); **updates ``colors``
    in place**.  Gathers only the ≤ cap frontier rows, so repair rounds pay
    cap·W² instead of n·W².  Each chunk is one ``ops.twohop`` call with
    ``row_ids`` (U = live, force = live & uncolored); the defect count
    ``defect & live`` is ``recolored & ~force`` since a forced row is
    uncolored and so never defective."""
    n, n_pad_s, C, n_chunks, impl = ctx.unpack()
    cap = idx.shape[0]
    cs = cap // n_chunks
    n_pad = colors.shape[0]
    device = colors.device
    ids_c = idx.clamp(0, n_pad - 1)
    # ids are unique: a slot's colour cannot change before its own chunk
    force = idx_valid & (colors[ids_c.long()] < 0)
    recolored = torch.zeros((n_pad,), dtype=torch.bool, device=device)
    rec_slots = torch.empty((cap,), dtype=torch.bool, device=device)
    ovf_slots = torch.empty((cap,), dtype=torch.bool, device=device)
    for k in range(n_chunks):
        lo, hi = k * cs, (k + 1) * cs
        newc, rec, o = ops.twohop(
            None, ell, colors, pri, idx_valid[lo:hi], 0, C, impl=impl,
            force=force[lo:hi], row_ids=ids_c[lo:hi])
        fr._commit_live(colors, recolored, ids_c[lo:hi], newc, rec, lo,
                        count)
        rec_slots[lo:hi] = rec
        ovf_slots[lo:hi] = o
    n_def = (rec_slots & ~force).sum(dtype=torch.int32)
    return colors, recolored, n_def, ovf_slots.any()


def _d2_loop(ell, pri, rows_mask, ctx, cap, max_rounds):
    """Round 0 (tentative two-hop coloring of every masked row) followed by
    the frontier-compacted fused repair, with two-hop passes plugged into
    ``frontier._compact_repair``.  Returns full-length (n_pad) colors."""
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    colors0 = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)
    colors1, U, _, ovf0 = _d2_chunked_pass(
        ctx, ell, pri, rows_mask, colors0, zeros, rows_mask, detect=False)

    def pass_small(colors, idx, idx_valid, count):
        return _d2_compact_pass(ctx, ell, pri, colors, idx, idx_valid, count)

    def pass_big(colors, U, force):
        return _d2_chunked_pass(ctx, ell, pri, rows_mask, colors, U, force,
                                detect=True)

    # arity follows ctx.trace, as in frontier._compact_repair
    return fr._compact_repair(
        ctx, cap, pass_small, pass_big, colors1, U, max_rounds, ovf0)


# --------------------------------------------------------------------------
# native engine: solve, result, registered engines
# --------------------------------------------------------------------------

def native_ws_mb(g: CSRGraph, n_chunks: int = 16, C: Optional[int] = None,
                 impl: str = "bitset") -> float:
    """Peak working set (MB) of one native two-hop gather pass as the
    reference counts it: G's ELL table, the (n,) color/priority vectors, one
    chunk's transient (cs, W + W²) gathered color+priority panels, and the
    chunk's packed forbidden table.  (The CUDA kernel keeps the panels and
    the table in registers; the account is the plain version's.)"""
    W = max(g.max_degree, 1)
    cap = _pick_C_d2(g, C)
    n = g.n_vertices
    cs = -(-n // max(int(n_chunks), 1))
    ell_bytes = n * W * 4
    vec_bytes = 2 * n * 4
    gather_bytes = 2 * cs * (W + W * W) * 4     # colors + priorities panels
    forb_bytes = bitset.ws_bytes(cs, cap, impl)
    return (ell_bytes + vec_bytes + gather_bytes + forb_bytes) / 2**20


def _pick_C_d2(g: CSRGraph, C: Optional[int]) -> int:
    if C is not None:
        return int(C)
    # distance-2 degree is bounded by deg² but typically far smaller
    # (neighborhoods overlap); start moderately generous: the packed rows
    # cost C/8 bytes, and a larger cap saves cap-doubling retries
    c = min(g.max_degree * g.max_degree + 2, 512)
    return int(max(32, -(-c // 32) * 32))


def _prepare_native(g: CSRGraph, seed: int, n_chunks: int, C: Optional[int],
                    relabel: bool, ell_cap: int,
                    device="cpu") -> col.ColoringProblem:
    if g.max_degree > ell_cap:
        raise ValueError(
            f"native distance-2 needs the full adjacency in ELL: max_degree "
            f"{g.max_degree} > ell_cap {ell_cap} (two-hop walks cannot cross "
            f"the COO overflow side-channel; use color_distance_d instead)")
    prob = col.prepare(g, seed, n_chunks, ell_cap=max(g.max_degree, 1),
                       C=_pick_C_d2(g, C), relabel=relabel, device=device)
    if prob.ovf_src.shape[0] != 0:
        raise RuntimeError("native distance-2 problem has overflow edges")
    return prob


def _run_d2_with_retry(prob: col.ColoringProblem, rows_mask, n_chunks: int,
                       cap: int, max_rounds: int, impl: str,
                       engine: str = "rsoc_d2", trace: bool = False,
                       max_retries=None):
    def run(C):
        ctx = PassContext.for_problem(prob, n_chunks=n_chunks, C=C,
                                      forbidden_impl=impl, trace=trace)
        return _d2_loop(prob.ell, prob.pri, rows_mask, ctx, cap, max_rounds)
    return col._run_with_retry(run, prob.C, engine=engine,
                               max_retries=max_retries)


def _d2_result(colors, r, trace, tot, final_C, retries,
               truncated: bool = False) -> col.ColoringResult:
    return col.ColoringResult(
        colors=colors, n_rounds=int(r),
        conflicts_per_round=np.asarray(trace), total_conflicts=int(tot),
        n_colors=col.n_colors_used(colors), overflow=retries > 0,
        gather_passes=1 + int(r), final_C=final_C, retries=retries,
        distance=2, trace_truncated=truncated)


def _solve_native(g: CSRGraph, spec, device, rows_mask_np, engine: str):
    """Shared body of the two registered engines: prepare, solve with cap
    doubling, unpermute.  ``rows_mask_np`` maps the prepared problem to the
    (n_pad,) bool mask of rows to color (None: every vertex)."""
    impl = resolve_impl(spec.forbidden_impl)
    tracer = obs.current_tracer()
    with obs.phase("prepare"):
        prob = _prepare_native(g, spec.seed, spec.n_chunks, spec.C,
                               spec.relabel, spec.ell_cap, device=device)
    cap = fr.frontier_cap(prob.n_pad, spec.n_chunks, spec.frontier_frac)
    if rows_mask_np is None:
        rows_mask = torch.arange(prob.n_pad, device=prob.device) < prob.n
    else:
        rows_mask = torch.from_numpy(rows_mask_np(prob)).to(prob.device)
    out, final_C, retries = _run_d2_with_retry(
        prob, rows_mask, spec.n_chunks, cap, spec.max_rounds, impl,
        engine=engine, trace=tracer is not None,
        max_retries=spec.max_cap_retries)
    colors, r, trace, ftrace, tot = col._loop_outputs(out, tracer is not None)
    col._report_frontier(tracer, ftrace, r, cap=cap)
    conf, truncated = col._trim_trace(col._to_numpy(trace), r)
    colors = col._unpermute(colors, prob.perm, prob.n)
    return colors, r, conf, tot, final_C, retries, truncated


@registry.register_engine("rsoc", distance=2, mode="static",
                          replaces="color_distance2")
def _distance2_engine(g: CSRGraph, spec, *, device="cpu"
                      ) -> col.ColoringResult:
    """Native distance-2 RSOC: fused two-hop gather, G² never materialized."""
    colors, r, conf, tot, final_C, retries, truncated = _solve_native(
        g, spec, device, None, "rsoc_d2")
    return _d2_result(colors, r, conf, tot, final_C, retries, truncated)


@registry.register_engine("rsoc", distance=2, mode="partial",
                          replaces="color_bipartite_partial")
def _bipartite_partial_engine(g: CSRGraph, spec, *, device="cpu"
                              ) -> col.ColoringResult:
    """One-sided distance-2 coloring of a bipartite graph (Jacobian
    compression): color only the left side [0, spec.n_left) so that any two
    left vertices sharing a neighbor get distinct colors.

    Same two-hop engine restricted to the left-side row mask; right-side
    vertices stay uncolored, so their (hop-1) contributions are inert and
    only shared-neighbor (hop-2) colors constrain.  Returns a result whose
    ``colors`` has length ``spec.n_left``.
    """
    n_left = spec.n_left
    if n_left is None or not 0 < n_left <= g.n_vertices:
        raise ValueError(f"n_left {n_left} out of range for n={g.n_vertices}")

    def left_mask(prob):
        mask = np.zeros(prob.n_pad, dtype=bool)
        mask[prob.perm[:n_left]] = True        # left side, relabeled space
        return mask

    colors, r, conf, tot, final_C, retries, truncated = _solve_native(
        g, spec, device, left_mask, "rsoc_d2_partial")
    return _d2_result(colors[:n_left], r, conf, tot, final_C, retries,
                      truncated)


def color_distance2(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
                    n_chunks: int = 16, max_rounds: int = 1000,
                    ell_cap: int = 512, relabel: bool = True,
                    frontier_frac: float = 0.125,
                    forbidden_impl: Optional[str] = None, *,
                    device=None) -> col.ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, distance=2)``.
    ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_distance2", "distance=2", g, algorithm="rsoc", distance=2,
        seed=seed, C=C, n_chunks=n_chunks, max_rounds=max_rounds,
        ell_cap=ell_cap, relabel=relabel, frontier_frac=frontier_frac,
        forbidden_impl=forbidden_impl, device=device)


def color_bipartite_partial(g: CSRGraph, n_left: int, seed: int = 0,
                            C: Optional[int] = None, n_chunks: int = 16,
                            max_rounds: int = 1000, ell_cap: int = 512,
                            relabel: bool = True,
                            frontier_frac: float = 0.125,
                            forbidden_impl: Optional[str] = None, *,
                            device=None) -> col.ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g, distance=2,
    mode="partial", n_left=...)``.  ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_bipartite_partial", "distance=2, mode='partial', n_left=...",
        g, algorithm="rsoc", distance=2, mode="partial", n_left=n_left,
        seed=seed, C=C, n_chunks=n_chunks, max_rounds=max_rounds,
        ell_cap=ell_cap, relabel=relabel, frontier_frac=frontier_frac,
        forbidden_impl=forbidden_impl, device=device)
