"""Frontier-compacted RSOC — beyond-paper optimization (the port of the
reference's ``core/frontier.py``).

After round 0 the defect set U is a small fraction of V (sub-1% typically),
but the baseline fused pass still sweeps every ELL row each round: the
memory-roofline term is n*W*4 bytes/round regardless of |U|.  This variant
compacts U into a fixed-capacity index buffer (``nonzero_static(U,
size=cap)``: ascending ids, padded with n_pad) and gathers only those ELL
rows, cutting per-round bytes from n*W to cap*W.

A second effect: compaction re-packs the frontier densely, so two vertices
that collided inside one chunk land in *different* chunks of the compacted
pass with high probability — cross-chunk fresh-data repair then resolves
them without a re-collision.

If |U| overflows the capacity (only plausible in round 1), the round falls
back to the full-width pass.

The repair loop ``_compact_repair`` is engine-agnostic: the distance-1
passes here and the two-hop passes of ``core/distance2.py`` plug into it.
Overflow (COO side-channel) edges participate via pass-start snapshots,
built frontier-local, same as the full-width pass.

How the loops run here (DESIGN_TORCH.md): each chunk of a compacted pass is
ONE call into ``kernels.ops`` — on a CUDA device one launch of the
``detect_recolor`` kernel with ``row_ids`` (distance 1) — followed by the
commit of the chunk's live slots.  The round loop is a host loop that reads
two integers back per round, together: the work count that decides
termination and the next |U|, which picks the small or the big pass.

Not ported here: ``_mega_compact_repair`` / ``_repair_mega_loop`` (the
megabatch queue, ROADMAP A3).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import bitset
from repro_torch.core import coloring as col
from repro_torch.core.context import PassContext, resolve_impl
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels import ops

MAX_ROUNDS_TRACE = col.MAX_ROUNDS_TRACE


def _compact(U, cap: int, n_pad: int):
    """(idx, live): the ids of U in ascending order in a (cap,) int32
    buffer, dead slots holding n_pad — the reference's ``jnp.nonzero(U,
    size=cap, fill_value=n_pad)``."""
    idx = torch.nonzero_static(U, size=cap, fill_value=n_pad)[:, 0]
    idx = idx.to(torch.int32)
    return idx, idx < n_pad


def _commit_live(colors, recolored, ids, newc, rec, lo: int, count: int):
    """Commit one chunk of a compacted pass: slots ``[lo, lo + m)`` of the
    buffer are the chunk's live ones (the live slots are the first
    ``count``), so only those are scattered — a dead slot's clamped id can
    equal a live one in the same chunk, and scattering both would race."""
    m = min(max(count - lo, 0), newc.shape[0])
    if m:
        live_ids = ids[:m].long()
        colors[live_ids] = newc[:m]
        recolored[live_ids] = rec[:m]


def _compact_pass(ctx, ell, osrc, odst, pri, colors, idx, idx_valid,
                  count: int):
    """Fused detect-and-recolor over a compacted row-index buffer; **updates
    ``colors`` in place**.

    ``idx`` holds the (≤ cap) row ids of the current frontier, dead slots
    hold n_pad; ``count`` (a host int) is the number of live slots, which
    are the first ones.  A row is re-colored when it is defective *right
    now* — or still uncolored (incremental seeds).  Each chunk is one
    ``ops.detect_recolor`` call with ``row_ids`` (U = live, force = live &
    uncolored).  The defect count is read off the kernel as ``recolored &
    ~force``: a forced row is uncolored, and an uncolored row is never
    defective (neither through ELL nor through overflow edges).
    Returns (colors, recolored_mask, n_defects, cap_overflowed).
    """
    n, n_pad_s, C, n_chunks, impl = ctx.unpack()
    cap = idx.shape[0]
    cs = cap // n_chunks
    n_pad = colors.shape[0]
    device = colors.device
    has_ovf = osrc.shape[0] > 0
    ids_c = idx.clamp(0, n_pad - 1)
    # a slot's colour cannot change before its own chunk (ids are unique),
    # so the pass-start colours decide which slots are forced
    force = idx_valid & (colors[ids_c.long()] < 0)
    snap = ovf_defect = None
    if has_ovf:
        # pass-start overflow snapshots built *frontier-local*: an inverse
        # index maps each overflow edge to its compacted slot (or nowhere),
        # so the tables are (cap, C)/(cap,), not (n_pad, C).  The scatter
        # lands in a transient dense table; only the packed words are kept.
        inv = torch.full((n_pad + 1,), -1, dtype=torch.int32, device=device)
        inv[idx.long()] = torch.arange(cap, dtype=torch.int32, device=device)
        olive = (osrc >= 0) & (odst >= 0)
        neg = torch.full((), -1, dtype=torch.int32, device=device)
        pos = torch.where(olive, inv[osrc.clamp(0, n_pad).long()], neg)
        s = osrc.clamp(0, n_pad - 1).long()
        d = odst.clamp(0, n_pad - 1).long()
        nbr_c = colors[d]
        ok = (pos >= 0) & (nbr_c >= 0) & (nbr_c < C)
        dense = torch.zeros((cap, C), dtype=torch.uint8, device=device)
        dense[pos[ok].long(), nbr_c[ok].long()] = 1
        snap = bitset.pack_dense(dense, C)
        conf = ((pos >= 0) & (colors[s] == nbr_c) & (nbr_c >= 0)
                & (pri[d] > pri[s]))
        ovf_defect = torch.zeros((cap,), dtype=torch.bool, device=device)
        ovf_defect[pos[conf].long()] = True

    recolored = torch.zeros((n_pad,), dtype=torch.bool, device=device)
    rec_slots = torch.empty((cap,), dtype=torch.bool, device=device)
    ovf_slots = torch.empty((cap,), dtype=torch.bool, device=device)
    for k in range(n_chunks):
        lo, hi = k * cs, (k + 1) * cs
        newc, rec, o = ops.detect_recolor(
            ell, colors, pri, idx_valid[lo:hi], 0, C, impl=impl,
            forb0=snap[lo:hi] if has_ovf else None,
            extra_defect=ovf_defect[lo:hi] if has_ovf else None,
            force=force[lo:hi], row_ids=ids_c[lo:hi])
        # commit after the launch (fresh colours for the next chunk)
        _commit_live(colors, recolored, ids_c[lo:hi], newc, rec, lo, count)
        rec_slots[lo:hi] = rec
        ovf_slots[lo:hi] = o
    n_def = (rec_slots & ~force).sum(dtype=torch.int32)
    return colors, recolored, n_def, ovf_slots.any()


def _d1_passes(ctx, ell, osrc, odst, pri):
    """The distance-1 (pass_small, pass_big) pair for ``_compact_repair``."""
    def pass_small(colors, idx, idx_valid, count):
        return _compact_pass(ctx, ell, osrc, odst, pri, colors,
                             idx, idx_valid, count)

    def pass_big(colors, U, force):
        return col._chunked_pass(ctx, ell, osrc, odst, pri, colors,
                                 U, force, detect=True)

    return pass_small, pass_big


def _compact_repair(ctx, cap, pass_small, pass_big, colors, U,
                    max_rounds, ovf0=False):
    """Frontier-compacted fused repair from an arbitrary (colors, U) start;
    **updates ``colors`` in place**.

    Same contract as ``coloring._fused_repair`` (one gather pass per round,
    U_{r+1} = recolored_r, terminates on a zero-defect pass) but each pass
    gathers only the ≤ cap compacted frontier rows; rounds whose frontier
    exceeds ``cap`` fall back to the full-width pass.

    The loop is engine-agnostic: ``pass_small(colors, idx, idx_valid,
    count)`` recolors the ``count`` ≤ cap compacted frontier rows,
    ``pass_big(colors, U, force)`` is the full-width fallback; both return
    (colors, recolored_mask, n_defects, cap_overflowed).

    The round loop runs on the host and reads two integers back per round,
    in one transfer: the work count (termination) and the next |U| (small
    or big pass).  Under ``ctx.trace`` the return grows a per-round |U|
    trace spliced before the trailing (tot, ovf) pair, as in
    ``coloring._fused_repair``; the count is free here.
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = colors.device
    trace = torch.zeros((MAX_ROUNDS_TRACE,), dtype=torch.int32, device=device)
    ftrace = np.zeros((MAX_ROUNDS_TRACE,), np.int32) if ctx.trace else None
    tot = torch.zeros((), dtype=torch.int32, device=device)
    ovf = (ovf0.clone() if isinstance(ovf0, torch.Tensor)
           else torch.tensor(bool(ovf0), device=device))
    r, last = 0, 1
    count = int(U.sum(dtype=torch.int32))
    while last > 0 and r < max_rounds:
        slot = min(r, MAX_ROUNDS_TRACE - 1)
        if ctx.trace:
            ftrace[slot] = count
        force = U & (colors < 0)
        n_forced = force.sum(dtype=torch.int32)
        if count <= cap:
            idx, live = _compact(U, cap, n_pad)
            colors, recolored, n_def, ovf2 = pass_small(colors, idx, live,
                                                        count)
        else:
            colors, recolored, n_def, ovf2 = pass_big(colors, U, force)
        trace[slot] = n_def
        # forced (uncolored-seed) work is speculative: keep the loop alive
        # so the next pass verifies it (see coloring._fused_repair)
        U, r, tot, ovf = recolored, r + 1, tot + n_def, ovf | ovf2
        # the one host read-back of the round
        last, count = torch.stack(
            [n_def + n_forced, U.sum(dtype=torch.int32)]).tolist()
    if ctx.trace:
        return colors, r, trace, ftrace, tot, ovf
    return colors, r, trace, tot, ovf


def _rsoc_compact_loop(ell, osrc, odst, pri, ctx, cap, max_rounds):
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    device = ell.device
    colors0 = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
    valid = torch.arange(n_pad, device=device) < n
    zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)

    # round 0: full-width chunked coloring (everyone needs a color anyway)
    colors1, U, _, ovf0 = col._chunked_pass(
        ctx, ell, osrc, odst, pri, colors0, zeros, valid, detect=False)
    pass_small, pass_big = _d1_passes(ctx, ell, osrc, odst, pri)
    out = _compact_repair(
        ctx, cap, pass_small, pass_big, colors1, U, max_rounds, ovf0)
    return (out[0][:n],) + out[1:]


def _repair_compact_loop(ell, osrc, odst, pri, colors, U, ctx, cap,
                         max_rounds):
    """Externally-seeded compacted repair (no round 0): the incremental
    recoloring entry point.  Returns full-length (n_pad) colors; the
    caller's ``colors`` is left untouched (the loop works on a copy)."""
    pass_small, pass_big = _d1_passes(ctx, ell, osrc, odst, pri)
    return _compact_repair(ctx, cap, pass_small, pass_big, colors.clone(), U,
                           max_rounds)


@registry.register_engine("rsoc_compact", distance=1, mode="static",
                          replaces="color_rsoc_compact")
def _rsoc_compact_engine(g: CSRGraph, spec, *, device="cpu"
                         ) -> col.ColoringResult:
    """RSOC with frontier compaction after round 0."""
    impl = resolve_impl(spec.forbidden_impl)
    tracer = obs.current_tracer()
    with obs.phase("prepare"):
        prob = col.prepare(g, spec.seed, spec.n_chunks, spec.ell_cap, spec.C,
                           spec.relabel, device=device)
    cap = frontier_cap(prob.n_pad, spec.n_chunks, spec.frontier_frac)

    def run(C_):
        ctx = PassContext.for_problem(prob, n_chunks=spec.n_chunks, C=C_,
                                      forbidden_impl=impl,
                                      trace=tracer is not None)
        return _rsoc_compact_loop(prob.ell, prob.ovf_src, prob.ovf_dst,
                                  prob.pri, ctx, cap, spec.max_rounds)

    out, C_, retries = col._run_with_retry(run, prob.C,
                                           engine="rsoc_compact",
                                           max_retries=spec.max_cap_retries)
    colors, r, trace, ftrace, tot = col._loop_outputs(out, tracer is not None)
    col._report_frontier(tracer, ftrace, r, cap=cap)
    conf, truncated = col._trim_trace(col._to_numpy(trace), r)
    colors = col._unpermute(colors, prob.perm, prob.n)
    return col.ColoringResult(
        colors=colors, n_rounds=int(r), conflicts_per_round=conf,
        total_conflicts=int(tot), n_colors=col.n_colors_used(colors),
        overflow=retries > 0, gather_passes=1 + int(r),
        final_C=C_, retries=retries, trace_truncated=truncated)


def color_rsoc_compact(g: CSRGraph, seed: int = 0, C: Optional[int] = None,
                       n_chunks: int = 16, max_rounds: int = 1000,
                       ell_cap: int = 512, relabel: bool = True,
                       frontier_frac: float = 0.125,
                       forbidden_impl: Optional[str] = None, *,
                       device=None) -> col.ColoringResult:
    """Deprecated: use ``repro_torch.api.color(g,
    algorithm="rsoc_compact")``.  ``device`` as for ``api.color``."""
    return registry.legacy_entry(
        "color_rsoc_compact", "algorithm='rsoc_compact'", g,
        algorithm="rsoc_compact", seed=seed, C=C, n_chunks=n_chunks,
        max_rounds=max_rounds, ell_cap=ell_cap, relabel=relabel,
        frontier_frac=frontier_frac, forbidden_impl=forbidden_impl,
        device=device)


def frontier_cap(n_pad: int, n_chunks: int, frac: float = 0.125) -> int:
    """Compacted-frontier capacity: a fraction of n_pad, chunk-aligned."""
    cap = max(n_chunks, int(n_pad * frac))
    return -(-cap // n_chunks) * n_chunks
