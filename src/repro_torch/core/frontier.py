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

The megabatched repair (``_mega_compact_repair`` / ``_repair_mega_loop``,
DESIGN.md §13) repairs a whole slot class of same-shape tenants at once.
The reference ``vmap``s the scalar loop over a leading slot axis; here the
slot axis is explicit: each slot keeps its own loop state (rounds, last
work count, defects, escape flag) on the host, a slot whose loop has ended
is *frozen* — its rows take no further pass and its counters stop, as
JAX's ``while_loop`` batching rule freezes a finished instance — and chunk
k of a round is ONE launch of ``detect_recolor``'s slot-stride form over
chunk k of every running slot (DESIGN_TORCH.md §15).
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


def _d1_passes(ctx, ell, osrc, odst, pri):
    """The distance-1 (pass_small, pass_big) pair for ``_compact_repair``.
    The small pass is ``_slot_pass``'s one-slot case on the one-table form
    of ``detect_recolor`` (``slot_rows`` 0); ``idx_valid`` and ``count``
    are implied by ``idx`` there."""
    slot0 = torch.zeros((1,), dtype=torch.int64, device=ell.device)

    def pass_small(colors, idx, idx_valid, count):
        recolored, n_def, ovf = _slot_pass(ctx, ell, osrc[None], odst[None],
                                           pri, colors, slot0,
                                           idx[None].long(), 0)
        return colors, recolored[0], n_def[0], ovf[0]

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


def _compact_rows(U, cap: int, n_pad: int):
    """Per row of U (L, n_pad), its ids in ascending order in a (cap,)
    int64 buffer, dead slots holding n_pad: ``_compact`` for every slot at
    once (ids past the first ``cap`` are dropped)."""
    L = U.shape[0]
    out = torch.full((L, cap + 1), n_pad, dtype=torch.int64,
                     device=U.device)
    rank = U.cumsum(1) - 1
    col_ = torch.where(U & (rank < cap), rank, cap)    # column cap: a sink
    out.scatter_(1, col_, torch.arange(n_pad, device=U.device).expand(L,
                                                                      n_pad))
    return out[:, :cap]


def _slot_layout(t, n_chunks: int):
    """(L, cap, ...) per-slot frontier tensor -> (n_chunks, L * cs, ...):
    row k holds chunk k of every slot, slot after slot — the rows of the
    pass's k-th launch."""
    L, cap = t.shape[:2]
    cs = cap // n_chunks
    tail = t.shape[2:]
    return t.reshape((L, n_chunks, cs) + tail).transpose(0, 1).reshape(
        (n_chunks, L * cs) + tail).contiguous()


def _unslot_layout(t, L: int):
    """Inverse of ``_slot_layout``: (n_chunks, L * cs, ...) -> (L, cap,
    ...)."""
    n_chunks, rows = t.shape[:2]
    cs = rows // L
    tail = t.shape[2:]
    return t.reshape((n_chunks, L, cs) + tail).transpose(0, 1).reshape(
        (L, n_chunks * cs) + tail)


def _slot_snapshot(C, n_pad, osrc, odst, pri, colors, slots, idx):
    """The pass-start overflow snapshots of the slots ``slots`` (L,) int64,
    built *frontier-local* per slot and stacked: (forb0 (L*cap,
    n_words(C)) int32, overflow-edge conflicts (L*cap,) bool), row
    ``j*cap + i`` for slot j's frontier slot i; (None, None) without an
    overflow buffer.  ``colors`` and ``pri`` are the S slots' flat
    (S*n_pad,) tables, ``osrc`` / ``odst`` (S, ocap).  An inverse index
    maps each overflow edge to its compacted slot (or nowhere), so the
    tables are (L*cap, C) / (L*cap,), not (n_pad, C); only the entries
    that land are scattered, into a transient dense table of which only
    the packed words are kept."""
    S, ocap = osrc.shape
    if ocap == 0:
        return None, None
    L, cap = idx.shape
    device = colors.device
    col_s, pri_s = colors.view(S, n_pad), pri.view(S, n_pad)
    if L < S:                 # the slots that sit out are left alone
        osrc, odst = osrc[slots], odst[slots]
        col_s, pri_s = col_s[slots], pri_s[slots]
    # each slot's inverse index: frontier position of each of its rows
    inv = torch.full((L, n_pad + 1), -1, dtype=torch.int32, device=device)
    inv.scatter_(1, idx, torch.arange(L * cap, dtype=torch.int32,
                                      device=device).view(L, cap))
    olive = (osrc >= 0) & (odst >= 0)
    pos = torch.where(olive, inv.gather(1, osrc.clamp(0, n_pad).long()), -1)
    s = osrc.clamp(0, n_pad - 1).long()
    d = odst.clamp(0, n_pad - 1).long()
    nbr_c = col_s.gather(1, d)
    hit = ((pos >= 0) & (nbr_c >= 0) & (nbr_c < C)).nonzero(as_tuple=True)
    dense = torch.zeros((L * cap, C), dtype=torch.uint8, device=device)
    dense[pos[hit].long(), nbr_c[hit].long()] = 1
    snap = bitset.pack_dense(dense, C)
    conf = ((pos >= 0) & (col_s.gather(1, s) == nbr_c) & (nbr_c >= 0)
            & (pri_s.gather(1, d) > pri_s.gather(1, s)))
    ovf_defect = torch.zeros((L * cap,), dtype=torch.bool, device=device)
    ovf_defect[pos[conf].long()] = True
    return snap, ovf_defect


def _slot_pass(ctx, ell, osrc, odst, pri, colors, slots, idx,
               slot_rows: int):
    """Fused detect-and-recolor over the compacted frontiers of the slots
    ``slots`` (L,) int64; **updates ``colors`` in place**.

    ``ell`` (S*n_pad, W), ``pri`` and ``colors`` (S*n_pad,) are S slots'
    stacked tables flattened, ``osrc`` / ``odst`` (S, ocap) their overflow
    buffers, ``idx`` (L, cap) int64 the frontiers of the slots passed, in
    ascending order with dead slots holding n_pad.  A row is re-colored
    when it is defective *right now* — or still uncolored (incremental
    seeds): U = live, force = live & uncolored, decided on the pass-start
    colours (ids are unique, so a slot's colour cannot change before its
    own chunk).  The overflow snapshot is built frontier-local per slot
    (``_slot_snapshot``).  Chunk k is ONE ``ops.detect_recolor`` call with
    ``row_ids`` over chunk k of every slot passed — the slot-stride form
    (``slot_rows`` = n_pad) for a megabatch, the one-table form
    (``slot_rows`` 0, S = 1) for one tenant — whose live rows are committed
    before chunk k + 1 (fresh colours).  The defect count is read off the
    kernel as ``recolored & ~force``: a forced row is uncolored, and an
    uncolored row is never defective (neither through ELL nor through
    overflow edges).  Returns (recolored (L, n_pad) bool, n_defects (L,),
    cap_overflowed (L,)).
    """
    n, n_pad, C, n_chunks, impl = ctx.unpack()
    L, cap = idx.shape
    device = colors.device
    valid = idx < n_pad
    gid = slots[:, None] * n_pad + idx.clamp(max=n_pad - 1)  # global rows
    force = valid & (colors[gid] < 0)
    snap, ovf_defect = _slot_snapshot(C, n_pad, osrc, odst, pri, colors,
                                      slots, idx)
    if snap is not None:
        snap = _slot_layout(snap.reshape(L, cap, -1), n_chunks)
        ovf_defect = _slot_layout(ovf_defect.view(L, cap), n_chunks)
    gid_k = _slot_layout(gid, n_chunks)
    rows = _slot_layout(gid.to(torch.int32), n_chunks)
    valid_k = _slot_layout(valid, n_chunks)
    force_k = _slot_layout(force, n_chunks)
    rec_k, ovf_k = [], []
    for k in range(n_chunks):
        newc, rec, o = ops.detect_recolor(
            ell, colors, pri, valid_k[k], 0, C, impl=impl,
            forb0=snap[k] if snap is not None else None,
            extra_defect=ovf_defect[k] if ovf_defect is not None else None,
            force=force_k[k], row_ids=rows[k], slot_rows=slot_rows)
        # commit the chunk as the change of each row: a row that does not
        # work, dead ones included, returns the colour it read at its id,
        # so it adds 0 there — and a dead row's clamped id may be a live
        # row's of its slot (a plain scatter of both would race)
        colors.index_add_(0, gid_k[k], newc - colors[gid_k[k]])
        rec_k.append(rec)
        ovf_k.append(o)
    rec = _unslot_layout(torch.stack(rec_k), L)
    recolored = torch.zeros((L, n_pad + 1), dtype=torch.bool, device=device)
    recolored.scatter_(1, idx, rec)           # dead slots: column n_pad
    n_def = (rec & ~force).sum(dim=1, dtype=torch.int32)
    return (recolored[:, :n_pad], n_def,
            _unslot_layout(torch.stack(ovf_k), L).any(dim=1))


def _mega_compact_repair(ctx, cap, pass_small, colors, U, max_rounds,
                         esc0):
    """Megabatched compacted repair (DESIGN.md §13) over an explicit slot
    axis; **updates ``colors`` (S, n_pad) in place**.

    Per slot, the semantics of ``_compact_repair``'s small branch
    (``U_{r+1} = recolored_r``, forced uncolored seeds keep the loop alive,
    terminates on a zero-defect pass), with each slot's loop state (rounds,
    last work count, defects, escape flag) its own.  A slot whose loop has
    ended is **frozen**: its rows take no further pass and its counters
    stop — what JAX's ``while_loop`` batching rule does to a finished
    instance of the reference's ``vmap``, and what makes every slot's
    result bit-identical to its scalar loop.  There is no full-width
    fallback and no cap doubling: a frontier past ``cap`` or a mex past the
    colour cap raises the slot's escape flag and freezes it, and the host
    redoes that slot through the per-tenant path (its colours are discarded
    by contract).  ``esc0`` (S,) marks slots escaped before this repair:
    they run zero rounds.

    ``pass_small(colors, slots, idx)`` is one compacted pass of the running
    slots (``_slot_pass``).  Each round reads back, in one
    transfer, what the loop needs: each running slot's defects, forced
    seeds, overflow flag and next frontier size.  Returns (colors, n_rounds
    (S,), total_defects (S,), escape (S,)), host numpy arrays but colors.
    """
    S, n_pad = U.shape
    device = colors.device
    r = np.zeros((S,), np.int64)
    tot = np.zeros((S,), np.int64)
    esc = np.array(esc0, dtype=bool).reshape(S).copy()
    last = np.where(esc, 0, 1)
    counts = U.sum(dim=1).tolist()
    flat = colors.view(-1)
    while True:
        run = [s for s in range(S) if last[s] > 0 and r[s] < max_rounds]
        if not run:
            break
        live = []
        for s in run:
            if counts[s] > cap:       # frontier overflow: the host redoes it
                esc[s], last[s] = True, 0
                r[s] += 1
            else:
                live.append(s)
        if not live:
            continue
        slots = torch.tensor(live, dtype=torch.int64, device=device)
        Ul = U[slots]
        n_forced = (Ul & (colors[slots] < 0)).sum(dim=1, dtype=torch.int32)
        recolored, n_def, ovf = pass_small(flat, slots,
                                           _compact_rows(Ul, cap, n_pad))
        U[slots] = recolored
        back = torch.stack([n_def, n_forced, ovf.to(torch.int32),
                            recolored.sum(dim=1, dtype=torch.int32)]).tolist()
        for j, s in enumerate(live):
            d, f, o, c = (back[0][j], back[1][j], back[2][j], back[3][j])
            r[s] += 1
            tot[s] += d
            esc[s] |= bool(o)         # colour-cap overflow: the host redoes it
            # forced seeds are speculative: same liveness rule as the
            # scalar loop
            last[s] = 0 if esc[s] else d + f
            counts[s] = c
    return colors, r, tot, esc


def _repair_mega_loop(ell, osrc, odst, pri, colors, U, esc0, ctx, cap,
                      max_rounds):
    """Megabatched externally-seeded repair: every operand carries a leading
    slot axis — ell (S, n_pad, W), osrc / odst (S, ocap), pri / colors
    (S, n_pad), U (S, n_pad) bool, esc0 (S,) bool — and each chunk of a
    round is one slot-stride launch for every running slot.  Per-slot
    ``(colors, n_rounds, total_defects, escape)``; a raised escape flag
    means that slot must be redone per-tenant, and its colours are
    garbage.  The caller's ``colors`` and ``U`` are left untouched (the
    loop works on copies)."""
    S, n_pad, W = ell.shape
    ell_f = ell.reshape(S * n_pad, W)
    pri_f = pri.reshape(S * n_pad)

    def pass_small(colors_f, slots, idx):
        return _slot_pass(ctx, ell_f, osrc, odst, pri_f, colors_f, slots,
                          idx, n_pad)

    return _mega_compact_repair(ctx, cap, pass_small, colors.clone(),
                                U.clone(), max_rounds, esc0)


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
