"""Multi-shard graph coloring over a ``core.mesh.Mesh`` (the port of the
reference's ``core/distributed.py``).

Collective schedules (DESIGN.md §2 — the paper's barrier analysis, in
collectives):

  RSOC  : one fused detect-and-recolor pass per round; the updated local color
          slice and the local defect count ride the SAME ``all_gather``
          (payload = [colors_local, n_defects_local]).   => 1 collective/round
  CAT   : phase A re-colors the defect set, whose colors must be re-replicated
          before phase B can detect (all_gather #1); phase B's defect count
          feeds the termination test, a global consensus (psum #2).  The data
          dependency detect-after-exchange is structural — exactly the second
          barrier of the paper's Algorithm 2.            => 2 collectives/round

Two color-exchange strategies:
  * ``replicated``: the full color vector is re-gathered each round
    (bytes/round = n*4).  Simple, the baseline.
  * ``halo``: only boundary colors are exchanged (bytes/round = D*max_b*4),
    using the static HaloPlan (partition.py).

How they run here (DESIGN_TORCH.md, "Distributed and sharded").  The
reference traces one ``shard_map`` program; the port is single-controller
too: a builder returns a host-driven function that loops over the mesh's
shards.  Each shard owns its tensors on its own device, *including its own
copy of the color table*: within a pass a shard reads its own fresh commits
and the other shards' colors as of the last exchange, and a table shared by
two shards would let one read the other's commits early.  A round is each
shard's chunked pass in turn, then the exchange — ONE ``mesh.all_gather``
of one payload a shard, the color slice (or boundary colors) and the
round's scalars in the same tensor — written into every shard's table, and
one read-back of the globally summed termination scalar.

On a CUDA device the passes are kernel launches: a chunk of
``_local_fused_pass`` is one ``detect_recolor`` (B2) launch with ``row_start
= row_base + lo`` into the shard's table (detect) or one ``firstfit`` (B1)
launch plus ``bitset.apply_recolor`` (round 0, CAT's phase A); CAT's
``detect_local`` is one detect-only B2 launch a shard; the sharded builders
run ``coloring._chunked_pass`` and ``frontier._slot_pass``'s one-slot form
(B2 with ``row_ids`` into a table with a ghost tail).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import bitset
from repro_torch.core import coloring as col
from repro_torch.core import frontier
from repro_torch.core.context import PassContext, resolve_impl
from repro_torch.core.mesh import Mesh, all_gather
from repro_torch.core.partition import block_partition
from repro_torch.graphs.csr import CSRGraph, to_ell
from repro_torch.kernels import ops

MAX_ROUNDS_TRACE = col.MAX_ROUNDS_TRACE

_NO_MESH = ("backend='distributed' requires a device mesh: "
            "repro_torch.api.color(g, spec, "
            "mesh=repro_torch.core.mesh.make_mesh((D,), ('data',)))")


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32).reshape(1)


def _per_shard(a: np.ndarray, devs) -> list:
    """Shard d's block ``a[d]`` of a host array with a leading shard axis,
    on ``devs[d]``."""
    return [torch.from_numpy(np.ascontiguousarray(a[d])).to(dev)
            for d, dev in enumerate(devs)]


def _replicated(a: np.ndarray, devs) -> list:
    """One copy of a host array per distinct device, listed per shard (a
    read-only operand the shards of one device share)."""
    by_dev = {}
    for dev in devs:
        if dev not in by_dev:
            by_dev[dev] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return [by_dev[dev] for dev in devs]


# --------------------------------------------------------------------------
# local fused pass (shared)
# --------------------------------------------------------------------------

def _local_fused_pass(ell_loc, colors_g, pri_glb, U_loc, force_loc,
                      row_base: int, ctx: PassContext, *, detect: bool):
    """Chunked detect-and-recolor of this shard's rows against its color
    table; **commits each chunk into ``colors_g`` in place** (the shard's
    own table: later chunks of the pass read the fresh colors).

    ell_loc:   (n_loc, W) neighbor ids into the table
    colors_g:  (n_glb,)   this shard's table (replicated, or local+ghost)
    row_base:  the table row of this shard's first row
    ctx:       ``ctx.n`` bounds the valid table rows
    ``detect=True`` takes no ``force`` (every caller's is empty there), so
    the defect count is the recolored count.  The mex's overflow flag is
    ignored, as in the reference (no cap doubling here).
    Returns (new local colors (n_loc,) — a view of the table, recolored
    mask, n_defects (0-dim)).
    """
    n, _, C, n_chunks, impl = ctx.unpack()
    n_loc = ell_loc.shape[0]
    cs = n_loc // n_chunks
    device = ell_loc.device
    if detect and force_loc is not None:
        raise ValueError("the detect pass takes no force mask")
    valid = (torch.arange(n_loc, device=device) + row_base) < n
    recolored = torch.zeros((n_loc,), dtype=torch.bool, device=device)
    for k in range(n_chunks):
        lo, hi = k * cs, (k + 1) * cs
        g0 = row_base + lo
        if detect:
            newc, rec, _ = ops.detect_recolor(
                ell_loc[lo:hi], colors_g, pri_glb, U_loc[lo:hi], g0, C,
                impl=impl, valid=valid[lo:hi])
        else:
            mex, full = ops.firstfit(ell_loc[lo:hi], colors_g, C, impl=impl)
            work = valid[lo:hi] & (U_loc[lo:hi] | force_loc[lo:hi])
            newc, rec, _ = bitset.apply_recolor(work, mex, full,
                                                colors_g[g0:g0 + cs])
        colors_g[g0:g0 + cs] = newc
        recolored[lo:hi] = rec
    n_def = (recolored.sum(dtype=torch.int32) if detect
             else torch.zeros((), dtype=torch.int32, device=device))
    return colors_g[row_base:row_base + n_loc], recolored, n_def


# --------------------------------------------------------------------------
# replicated-exchange engines
# --------------------------------------------------------------------------

def build_rsoc_distributed(mesh: Mesh, axis: str, ctx: PassContext,
                           max_rounds: int = 64):
    """Returns fn(ell, pri) -> (colors (n_pad,), rounds, trace, conflicts):
    ``ell`` shard d's (n_loc, W) rows on its device, ``pri`` the (n_pad,)
    priorities on each shard's device.  ONE collective per round (colors
    slice + defect count).

    ``ctx`` carries (n, n_pad, C, n_chunks, forbidden_impl) for the whole
    (unsharded) problem; each shard owns n_pad / D rows.
    """
    n_pad = ctx.n_pad
    devs = mesh.shard_devices(axis)
    D = len(devs)
    n_loc = n_pad // D

    def fn(ell, pri):
        tabs = [torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
                for dev in devs]
        ones = [torch.ones((n_loc,), dtype=torch.bool, device=dev)
                for dev in devs]

        def exchange(c_l, n_def_l):
            """The ONE collective: every shard's tabs <- all colors; the
            summed defect count (a device scalar)."""
            allp = all_gather([torch.cat([c, _i32(k)])
                               for c, k in zip(c_l, n_def_l)])
            for d in range(D):
                tabs[d].copy_(allp[d][:, :n_loc].reshape(n_pad))
            return allp[0][:, n_loc].sum()

        # round 0: color everything; 1 collective
        c_l = [_local_fused_pass(ell[d], tabs[d], pri[d], ones[d], ones[d],
                                 d * n_loc, ctx, detect=False)[0]
               for d in range(D)]
        exchange(c_l, [torch.zeros((), dtype=torch.int32, device=dev)
                       for dev in devs])
        U = ones
        trace = np.zeros((MAX_ROUNDS_TRACE,), np.int32)
        r, tot, last = 0, 0, 1
        while last > 0 and r < max_rounds:
            outs = [_local_fused_pass(ell[d], tabs[d], pri[d], U[d], None,
                                      d * n_loc, ctx, detect=True)
                    for d in range(D)]
            n_def = int(exchange([o[0] for o in outs],
                                 [o[2] for o in outs]))   # ONE collective
            trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
            U = [o[1] for o in outs]
            r, tot, last = r + 1, tot + n_def, n_def
        return tabs[0], r, trace, tot

    return fn


def build_cat_distributed(mesh: Mesh, axis: str, ctx: PassContext,
                          max_rounds: int = 64):
    """CAT with the structural 2-collectives-per-round schedule; the same
    inputs and outputs as ``build_rsoc_distributed``'s function."""
    n_pad, C, impl = ctx.n_pad, ctx.C, ctx.forbidden_impl
    devs = mesh.shard_devices(axis)
    D = len(devs)
    n_loc = n_pad // D

    def fn(ell, pri):
        tabs = [torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
                for dev in devs]
        zeros = [torch.zeros((n_loc,), dtype=torch.bool, device=dev)
                 for dev in devs]
        ones = [torch.ones((n_loc,), dtype=torch.bool, device=dev)
                for dev in devs]

        def gather_colors(c_l):
            allc = all_gather(c_l)
            for d in range(D):
                tabs[d].copy_(allc[d].reshape(n_pad))

        def psum(U):
            return int(all_gather([_i32(u.sum(dtype=torch.int32))
                                   for u in U])[0].sum())

        def detect_local(U):
            """One detect-only launch a shard: U & defect."""
            return [ops.detect_recolor(ell[d], tabs[d], pri[d], U[d],
                                       d * n_loc, C, impl=impl,
                                       detect_only=True)
                    for d in range(D)]

        # round 0
        c_l = [_local_fused_pass(ell[d], tabs[d], pri[d], zeros[d], ones[d],
                                 d * n_loc, ctx, detect=False)[0]
               for d in range(D)]
        gather_colors(c_l)                                # collective 1
        U = detect_local(ones)
        n_def = psum(U)                                   # collective 2
        trace = np.zeros((MAX_ROUNDS_TRACE,), np.int32)
        r, tot = 0, 0
        while n_def > 0 and r < max_rounds:
            trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
            # phase A: recolor defect set
            c_l = [_local_fused_pass(ell[d], tabs[d], pri[d], U[d],
                                     zeros[d], d * n_loc, ctx,
                                     detect=False)[0]
                   for d in range(D)]
            gather_colors(c_l)                            # collective 1
            # phase B: detect + global consensus
            U = detect_local(U)
            r, tot = r + 1, tot + n_def
            n_def = psum(U)                               # collective 2
        return tabs[0], r, trace, tot

    return fn


# --------------------------------------------------------------------------
# halo-exchange RSOC (collective-term optimized)
# --------------------------------------------------------------------------

def build_rsoc_halo(mesh: Mesh, axis: str, plan_shapes: dict,
                    ctx: PassContext, max_rounds: int = 64):
    """RSOC exchanging only boundary colors.

    Inputs per shard (lists, shard d's on its device): ell_local (n_loc, W)
    with local/ghost slot ids; pri_loc (n_loc,); pri_ghost (max_g,);
    boundary (max_b,); ghost flat index (max_g,) into the gathered
    (D*max_b,) boundary payload; valid_loc (n_loc,) bool.  Color table per
    shard has n_loc + max_g slots (ghosts at the tail).  ``ctx`` supplies
    (C, n_chunks, forbidden_impl); its row counts are re-derived per shard.
    Returns (colors (D*n_loc,) — the shards' local colors in shard order,
    on the first shard's device; rounds, trace, conflicts).
    """
    devs = mesh.shard_devices(axis)
    D, n_loc = plan_shapes["D"], plan_shapes["n_loc"]
    max_b, max_g = plan_shapes["max_b"], plan_shapes["max_g"]
    if D != len(devs):
        raise ValueError(f"plan has {D} shards, the mesh axis {len(devs)}")
    # every local row is a valid candidate; the shard's color table carries
    # max_g ghost slots at the tail
    lctx = dataclasses.replace(ctx, n=n_loc, n_pad=n_loc + max_g)
    n_tab = n_loc + max_g

    def fn(ell_loc, pri_loc, pri_ghost, boundary, ghost_flat, valid_loc):
        tabs = [torch.full((n_tab,), -1, dtype=torch.int32, device=dev)
                for dev in devs]
        pri_tab = [torch.cat([pri_loc[d], pri_ghost[d]]) for d in range(D)]
        zeros = [torch.zeros((n_loc,), dtype=torch.bool, device=dev)
                 for dev in devs]
        bsafe = [b.clamp(0, n_loc - 1).long() for b in boundary]
        gsafe = [gf.clamp(0, D * max_b - 1).long() for gf in ghost_flat]
        neg = [torch.full((), -1, dtype=torch.int32, device=dev)
               for dev in devs]

        def exchange(n_def_l):
            payload = [torch.cat([torch.where(boundary[d] >= 0,
                                              tabs[d][bsafe[d]], neg[d]),
                                  _i32(n_def_l[d])]) for d in range(D)]
            allp = all_gather(payload)
            for d in range(D):
                flat = allp[d][:, :max_b].reshape(D * max_b)
                tabs[d][n_loc:] = torch.where(ghost_flat[d] >= 0,
                                              flat[gsafe[d]], neg[d])
            return allp[0][:, max_b].sum()

        def fused(U, force, detect):
            return [_local_fused_pass(ell_loc[d], tabs[d], pri_tab[d], U[d],
                                      force[d] if force else None, 0, lctx,
                                      detect=detect) for d in range(D)]

        # round 0
        fused(zeros, valid_loc, False)
        exchange([torch.zeros((), dtype=torch.int32, device=dev)
                  for dev in devs])                      # 1 collective
        U = valid_loc
        trace = np.zeros((MAX_ROUNDS_TRACE,), np.int32)
        r, tot, last = 0, 0, 1
        while last > 0 and r < max_rounds:
            outs = fused(U, None, True)
            n_def = int(exchange([o[2] for o in outs]))   # 1 collective
            trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
            U = [o[1] for o in outs]
            r, tot, last = r + 1, tot + n_def, n_def
        colors_l = torch.cat([t[:n_loc].to(devs[0]) for t in tabs])
        return colors_l, r, trace, tot

    return fn


# --------------------------------------------------------------------------
# sharded mutable-state passes (dynamic/sharded.py; DESIGN.md §15)
#
# Same halo protocol as build_rsoc_halo — ONE all_gather per round carrying
# [boundary colors, n_defects, work, overflow] — but over the *mutable*
# encode: per-shard overflow COO alongside the ELL, external (colors, U)
# seeds instead of a from-scratch start, and the overflow flag returned
# last so ``col._run_with_retry`` can drive cap doubling.
# --------------------------------------------------------------------------

def _sharded_exchange(D: int, n_loc: int, max_b: int, boundary, ghost_flat):
    """Shared halo exchange: publish my boundary colors + (n_def, work, ovf)
    scalars, gather all shards' payloads, refresh my ghost tail.  Returns a
    closure ``exchange(tabs, n_def_l, work_l, ovf_l) -> (3,) int32`` that
    refreshes every shard's table in place and returns the globally summed
    (n_def, work, ovf) on the first shard's device (ovf > 0: overflow)."""
    bsafe = [b.clamp(0, n_loc - 1).long() for b in boundary]
    gsafe = [gf.clamp(0, D * max_b - 1).long() for gf in ghost_flat]

    def exchange(tabs, n_def_l, work_l, ovf_l):
        payload = []
        for d in range(D):
            neg = torch.full((), -1, dtype=torch.int32, device=tabs[d].device)
            b = torch.where(boundary[d] >= 0, tabs[d][bsafe[d]], neg)
            tail = torch.stack([torch.as_tensor(x, device=tabs[d].device)
                                .to(torch.int32).reshape(())
                                for x in (n_def_l[d], work_l[d], ovf_l[d])])
            payload.append(torch.cat([b, tail]))
        allp = all_gather(payload)
        for d in range(D):
            flat = allp[d][:, :max_b].reshape(D * max_b)
            neg = torch.full((), -1, dtype=torch.int32, device=tabs[d].device)
            tabs[d][n_loc:] = torch.where(ghost_flat[d] >= 0, flat[gsafe[d]],
                                          neg)
        return allp[0][:, max_b:].sum(dim=0)

    return exchange


def build_sharded_scratch(mesh: Mesh, axis: str, D: int, n_loc: int,
                          max_b: int, max_g: int, ctx: PassContext,
                          max_rounds: int):
    """From-scratch coloring of a sharded mutable state: round 0 force-colors
    every valid local row, then fused detect-and-recolor rounds with one halo
    exchange each.  On a 1-shard mesh this replays ``col._rsoc_loop``'s
    program bit-for-bit (same chunked pass, same carry schedule).

    Returns fn(ell, ovf_src, ovf_dst, pri_tab, valid_loc, boundary,
    ghost_flat) — each a list of shard d's (n_loc, W), (cap,), (cap,),
    (n_tab,), (n_loc,), (max_b,), (max_g,) tensors on its device — ->
    (colors_tab list of (n_tab,), rounds, trace, total_conflicts,
    overflowed)."""
    if D != len(mesh.shard_devices(axis)):
        raise ValueError(f"D={D} is not the mesh axis' size")
    n_tab = n_loc + max_g
    lctx = dataclasses.replace(ctx, n=n_loc, n_pad=n_loc, trace=False)

    def fn(ell, osrc, odst, pri_tab, valid_loc, boundary, ghost_flat):
        exchange = _sharded_exchange(D, n_loc, max_b, boundary, ghost_flat)
        tabs = [torch.full((n_tab,), -1, dtype=torch.int32, device=e.device)
                for e in ell]
        U, ovf_l = [], []
        # round 0: color every valid local row against fresh local colors
        for d in range(D):
            zeros = torch.zeros((n_loc,), dtype=torch.bool,
                                device=ell[d].device)
            _, rec, _, o = col._chunked_pass(
                lctx, ell[d], osrc[d], odst[d], pri_tab[d], tabs[d], zeros,
                valid_loc[d], detect=False, valid=valid_loc[d])
            U.append(rec)
            ovf_l.append(o)
        z = [0] * D
        ovf = int(exchange(tabs, z, z, ovf_l)[2]) > 0
        trace = np.zeros((MAX_ROUNDS_TRACE,), np.int32)
        r, work, tot = 0, 1, 0
        while work > 0 and r < max_rounds:
            recs, n_def_l, work_l, ovf_l = [], [], [], []
            for d in range(D):
                force = U[d] & (tabs[d][:n_loc] < 0)
                _, rec, nd, o = col._chunked_pass(
                    lctx, ell[d], osrc[d], odst[d], pri_tab[d], tabs[d],
                    U[d], force, detect=True, valid=valid_loc[d])
                recs.append(rec)
                n_def_l.append(nd)
                work_l.append(nd + force.sum(dtype=torch.int32))
                ovf_l.append(o | ovf)
            n_def, work, ovf_c = exchange(tabs, n_def_l, work_l,
                                          ovf_l).tolist()
            trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
            U, r, tot, ovf = recs, r + 1, tot + n_def, ovf_c > 0
        return tabs, r, trace, tot, ovf

    return fn


def build_sharded_repair(mesh: Mesh, axis: str, D: int, n_loc: int,
                         max_b: int, max_g: int, ctx: PassContext,
                         cap: int, max_rounds: int):
    """Incremental repair of a sharded mutable state from external
    (colors, U) seeds: the sharded counterpart of
    ``frontier._repair_compact_loop``, with a halo exchange per round.

    An up-front exchange freshens ghost colors before the first detect
    (newly-allocated ghost slots start at -1 on the referencing shard), then
    each round recolors each shard's frontier — compacted to ``cap`` slots
    when the shard's own count is small enough (``frontier._slot_pass``'s
    one-slot form: B2 with ``row_ids`` into the table with its ghost tail),
    a full chunked sweep otherwise — and exchanges boundary colors +
    termination scalars in one collective.  Shards may take different
    passes in one round.  Each round reads back, in one transfer, the
    summed scalars and every shard's next frontier size.  On a 1-shard mesh
    this replays ``frontier._repair_compact_loop`` bit-for-bit.

    Returns fn(ell, ovf_src, ovf_dst, pri_tab, colors_tab, U, valid_loc,
    boundary, ghost_flat) (per-shard lists; ``colors_tab`` is left as it
    is: the loop works on copies) -> (colors_tab list, rounds, trace,
    total_conflicts, overflowed)."""
    devs = mesh.shard_devices(axis)
    if D != len(devs):
        raise ValueError(f"D={D} is not the mesh axis' size")
    n_tab = n_loc + max_g
    lctx = dataclasses.replace(ctx, n=n_loc, n_pad=n_loc, trace=False)
    # the compacted pass indexes the whole table: dead slots hold n_tab
    sctx = dataclasses.replace(lctx, n_pad=n_tab)

    def fn(ell, osrc, odst, pri_tab, colors_tab, U, valid_loc, boundary,
           ghost_flat):
        exchange = _sharded_exchange(D, n_loc, max_b, boundary, ghost_flat)
        tabs = [t.clone() for t in colors_tab]
        z = [0] * D
        exchange(tabs, z, z, z)
        slot0 = [torch.zeros((1,), dtype=torch.int64, device=dev)
                 for dev in devs]
        counts = torch.stack([u.sum(dtype=torch.int32).to(devs[0])
                              for u in U]).tolist()
        trace = np.zeros((MAX_ROUNDS_TRACE,), np.int32)
        r, work, tot, ovf = 0, 1, 0, False
        while work > 0 and r < max_rounds:
            recs, n_def_l, work_l, ovf_l = [], [], [], []
            for d in range(D):
                tab = tabs[d]
                n_forced = (U[d] & (tab[:n_loc] < 0)).sum(dtype=torch.int32)
                if counts[d] <= cap:
                    # fill n_tab (NOT n_loc): dead frontier slots must fall
                    # off the table, not alias ghost slot 0
                    idx, _ = frontier._compact(U[d], cap, n_tab)
                    rec, nd, o = frontier._slot_pass(
                        sctx, ell[d], osrc[d][None], odst[d][None],
                        pri_tab[d], tab, slot0[d], idx[None].long(), 0)
                    rec, nd, o = rec[0, :n_loc], nd[0], o[0]
                else:
                    force = U[d] & (tab[:n_loc] < 0)
                    _, rec, nd, o = col._chunked_pass(
                        lctx, ell[d], osrc[d], odst[d], pri_tab[d], tab,
                        U[d], force, detect=True, valid=valid_loc[d])
                recs.append(rec)
                n_def_l.append(nd)
                work_l.append(nd + n_forced)
                ovf_l.append(o | ovf)
            tail = exchange(tabs, n_def_l, work_l, ovf_l)
            back = torch.cat([tail] + [u.sum(dtype=torch.int32).to(devs[0])
                                       .reshape(1) for u in recs]).tolist()
            n_def, work, ovf_c = back[:3]
            counts = back[3:]
            trace[min(r, MAX_ROUNDS_TRACE - 1)] = n_def
            U, r, tot, ovf = recs, r + 1, tot + n_def, ovf_c > 0
        return tabs, r, trace, tot, ovf

    return fn


# --------------------------------------------------------------------------
# host-level drivers
# --------------------------------------------------------------------------

def _color_distributed(g: CSRGraph, mesh: Mesh, axis: str = "data",
                       algorithm: str = "rsoc", seed: int = 0,
                       n_chunks: int = 4, C: Optional[int] = None,
                       max_rounds: int = 64,
                       forbidden_impl: Optional[str] = None):
    """Run distributed coloring on the mesh's devices."""
    devs = mesh.shard_devices(axis)
    D = len(devs)
    with obs.phase("prepare"):
        part = block_partition(g, D, seed)
        gg = part.graph
        W = max(1, gg.max_degree)
        n_loc = -(-part.n_pad // D)
        n_loc = -(-n_loc // n_chunks) * n_chunks
        n_pad = n_loc * D
        ell = to_ell(gg, max_degree=W, pad_vertices_to=n_pad)
        rng = np.random.default_rng(seed + 1)
        pri = np.full(n_pad, -1, np.int32)
        pri[:part.n] = rng.permutation(part.n).astype(np.int32)
        ell_sh = _per_shard(ell.reshape(D, n_loc, W), devs)
        pri_sh = _replicated(pri, devs)
    ctx = PassContext(n=part.n, n_pad=n_pad,
                      C=C or col._pick_C(gg, None), n_chunks=n_chunks,
                      forbidden_impl=resolve_impl(forbidden_impl))
    build = {"rsoc": build_rsoc_distributed,
             "cat": build_cat_distributed}[algorithm]
    fn = build(mesh, axis, ctx, max_rounds)
    with obs.phase("solve", C=ctx.C, devices=D):
        colors, r, trace, tot = col._block_until_ready(fn(ell_sh, pri_sh))
    conf, truncated = col._trim_trace(trace, r)
    # back to original ids: perm maps old->new, colors_old[i] = colors_new[perm[i]]
    colors = col._to_numpy(colors)[part.perm]
    return col.ColoringResult(
        colors=colors, n_rounds=int(r), conflicts_per_round=conf,
        total_conflicts=int(tot), n_colors=col.n_colors_used(colors),
        overflow=False,
        gather_passes=(1 + int(r)) * (1 if algorithm == "rsoc" else 2),
        final_C=ctx.C, retries=0, distance=1, trace_truncated=truncated)


def _distributed_engine(algorithm: str):
    def engine(g: CSRGraph, spec, *, mesh: Optional[Mesh] = None,
               axis: str = "data") -> col.ColoringResult:
        if mesh is None:
            raise ValueError(_NO_MESH)
        return _color_distributed(
            g, mesh, axis=axis, algorithm=algorithm, seed=spec.seed,
            n_chunks=spec.n_chunks, C=spec.C, max_rounds=spec.max_rounds,
            forbidden_impl=spec.forbidden_impl)
    engine.__name__ = f"_{algorithm}_distributed_engine"
    return engine


registry.register_engine("rsoc", distance=1, mode="static",
                         backend="distributed",
                         replaces="color_distributed")(
    _distributed_engine("rsoc"))
registry.register_engine("cat", distance=1, mode="static",
                         backend="distributed",
                         replaces="color_distributed")(
    _distributed_engine("cat"))


def color_distributed(g: CSRGraph, mesh: Mesh, axis: str = "data",
                      algorithm: str = "rsoc", seed: int = 0,
                      n_chunks: int = 4, C: Optional[int] = None,
                      max_rounds: int = 64):
    """Deprecated: use ``repro_torch.api.color(g, backend="distributed",
    mesh=...)``."""
    return registry.legacy_entry(
        "color_distributed", "backend='distributed', mesh=...", g,
        algorithm=algorithm, backend="distributed", mesh=mesh, axis=axis,
        seed=seed, n_chunks=n_chunks, C=C, max_rounds=max_rounds)
