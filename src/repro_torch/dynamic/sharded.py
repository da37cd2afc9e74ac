"""Sharded incremental recoloring: distributed × dynamic (DESIGN.md §15; the
port of the reference's ``dynamic/sharded.py``).

``ShardedColoringState`` is the mesh-distributed counterpart of
``DynamicColoringState``: the mutable ELL+overflow encode is laid out
per-shard in *slot space* (local slots [0, n_loc), ghost slots n_loc+g for
remote neighbors), and every repair round exchanges exactly one collective
carrying boundary colors plus three termination scalars — bytes per round
∝ boundary, never ∝ n.  Çatalyürek-style speculation is what makes this
sound: the fused detect-and-recolor pass tolerates stale cross-shard colors,
so a round may read ghost colors one exchange old and the next round's
detect repairs any conflict it caused (core/distributed.py docstring).

The differential bar that keeps this honest: on a 1-shard mesh the whole
stack — encode, from-scratch solve, wave-applied updates, frontier-compacted
repair, cap doubling — replays the single-device ``mode="incremental"``
engine bit-for-bit.  That works because ``block_partition`` threads the same
numpy stream ``prepare`` draws from, ``build_halo_mutable`` reproduces the
mutable encode exactly, the sharded loops in ``core/distributed.py`` mirror
the single-device carry schedules, and ``delta.plan_group(directed=True)``
dedups a routed batch to the same wave set ``plan_updates`` emits.

Routing (host side): an undirected update (u, v) becomes two *directed*
slot-space mutations, one per owning shard — (u_loc, slot-of-v-in-u's-shard)
and (v_loc, slot-of-u-in-v's-shard).  Cross-shard targets resolve through
the ghost table; inserts allocate ghost/boundary slots append-only (existing
ghost pointers never move), and a batch that outgrows the slack capacity
re-plans the halo once (``sharded.replan`` counter) with doubled caps —
colors and priorities are per-vertex, so a re-plan never perturbs them.
The reference routes pair by pair through Python dicts; here a batch is
routed with array lookups (a per-shard dense ghost index, one boundary-slot
index) and first-occurrence ranks (a stable sort), which allocate the same
slots in the same order.

How it runs here (DESIGN_TORCH.md, "Distributed and sharded").  The state's
tensors carry a leading shard axis as a tuple: ``ell[d]``, ``colors_tab[d]``
... are shard d's, on ``mesh.shard_devices(axis)[d]``; the halo metadata
stays numpy on the host.  A batch's waves run the slot-axis bodies of
``dynamic/delta.py`` with the shards of one device stacked as the slots (one
call a wave for all of them; the stacking is the batch's copy, so the state
is copy-on-write like ``DynamicColoringState``), and the repair runs
``core/distributed.build_sharded_repair`` on B1 / B2.

Budget exhaustion degrades through the same ladder as the single-device
engine (``resilience/ladder.py`` dispatches here): rung 1 re-encodes the
updated graph from scratch through ``api.color``'s front door, rung 2 is
the serial oracle + pure encode.  Rung attribution is preserved verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, registry
from repro_torch.core import coloring as col
from repro_torch.core import distributed as dist
from repro_torch.core import frontier
from repro_torch.core import partition as part_mod
from repro_torch.core.context import PassContext, resolve_impl
from repro_torch.dynamic import delta
from repro_torch.dynamic.incremental import _check_edges
from repro_torch.graphs.csr import CSRGraph, FILL, from_edges
from repro_torch.resilience import faults
from repro_torch.resilience.errors import (CapRetryExhausted,
                                           OvfGrowthExhausted)

# the per-shard tensor fields of a state: a tuple of D tensors each
TENSOR_FIELDS = ("ell", "ovf_src", "ovf_dst", "pri_tab", "colors_tab")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedColoringState:
    """Sharded mutable-graph coloring state.

    The tensor fields hold one tensor per shard (the leading shard axis),
    shard d's on ``devices[d]``; ``boundary`` / ``ghost_*`` halo metadata
    is authoritative on the host (it changes only on slot allocation and
    re-plan, both host decisions) and is shipped to the devices per repair
    call — these arrays are boundary-sized, not n-sized.  Immutable: every
    batch returns a new state and never writes a state's tensors, so
    service snapshot/rollback is free.
    """

    # -- per-shard tensors (shard d's on devices[d]) ------------------------
    ell: tuple                # (n_loc, W) slot-space neighbors, FILL pad
    ovf_src: tuple            # (ovf_cap,) overflow COO local rows
    ovf_dst: tuple            # (ovf_cap,) overflow COO slot targets
    pri_tab: tuple            # (n_tab,) priorities: local rows + ghost tail
    colors_tab: tuple         # (n_tab,) colors: local rows + ghost tail
    # -- host halo metadata (copy-on-write) ---------------------------------
    boundary: np.ndarray      # (D, max_b_cap) int32 local slots, FILL pad
    n_boundary: np.ndarray    # (D,) live boundary slots
    ghost_ids: np.ndarray     # (D, max_g_cap) int64 global relabeled ids
    ghost_flat: np.ndarray    # (D, max_g_cap) int32 owner*max_b_cap + slot
    n_ghost: np.ndarray       # (D,) live ghost slots
    # -- geometry / statics -------------------------------------------------
    n: int
    blk: int                  # shard-membership block size (v // blk)
    n_loc: int                # chunk-aligned row-table height per shard
    n_shards: int
    mesh: object              # core.mesh.Mesh
    axis: str
    C: int
    n_chunks: int
    frontier_cap: int         # per-shard compacted-frontier capacity
    delta_cap: int
    ell_cap: int              # encode parameters, persisted for re-plans
    ell_slack: int
    perm: np.ndarray          # old id -> relabeled id
    inv_perm: np.ndarray      # relabeled id -> old id
    pri_global: np.ndarray    # (n,) priority of each relabeled id
    row_of: np.ndarray        # (n,) relabeled id -> flat row d*n_loc + slot
    forbidden_impl: str = "bitset"
    max_rounds: int = 1000
    version: int = 0
    last_rounds: int = 0
    last_conflicts: int = 0
    last_gather_passes: int = 0
    total_gather_passes: int = 0
    retries: int = 0
    ovf_grows: int = 0
    replans: int = 0              # cumulative halo re-plans
    last_halo_bytes: int = 0      # collective payload bytes of the last step
    total_halo_bytes: int = 0
    max_cap_retries: Optional[int] = None
    max_ovf_growth: Optional[int] = None
    last_degrade_rung: int = 0

    # -- derived geometry ---------------------------------------------------

    @property
    def devices(self) -> tuple:
        return self.mesh.shard_devices(self.axis)

    @property
    def n_tab(self) -> int:
        return int(self.colors_tab[0].shape[0])

    @property
    def max_b_cap(self) -> int:
        return int(self.boundary.shape[1])

    @property
    def max_g_cap(self) -> int:
        return int(self.ghost_flat.shape[1])

    @property
    def ell_width(self) -> int:
        """Row width of the slot tables, slack columns included."""
        return int(self.ell[0].shape[1])

    @property
    def ovf_cap(self) -> int:
        return int(self.ovf_src[0].shape[0])

    @property
    def halo_bytes_per_round(self) -> int:
        """One exchange's payload: (boundary colors + 3 scalars) int32 per
        shard, all_gathered — the O(boundary) claim, as a number."""
        return self.n_shards * (self.max_b_cap + 3) * 4

    # -- views --------------------------------------------------------------

    @property
    def colors_dev(self) -> tuple:
        """Per-shard device color tables (the service's sync handle)."""
        return self.colors_tab

    def stacked(self, field: str) -> np.ndarray:
        """A tensor field as one host array with its leading shard axis."""
        return np.stack([_host(t) for t in getattr(self, field)])

    @property
    def colors(self) -> np.ndarray:
        """Current coloring over original vertex ids."""
        flat = np.concatenate([_host(t[:self.n_loc])
                               for t in self.colors_tab])
        return flat[self.row_of[self.perm[:self.n]]]

    @property
    def n_colors(self) -> int:
        return col.n_colors_used(self.colors)

    def summary(self) -> dict:
        return {"version": self.version, "colors": self.n_colors,
                "rounds": self.last_rounds,
                "conflicts": self.last_conflicts,
                "gather_passes": self.last_gather_passes,
                "total_gather_passes": self.total_gather_passes,
                "final_C": self.C, "retries": self.retries,
                "ovf_grows": self.ovf_grows,
                "degrade_rung": self.last_degrade_rung,
                "ovf_load": sum(delta.overflow_load(o)
                                for o in self.ovf_src),
                "n_shards": self.n_shards,
                "halo_bytes_per_round": self.halo_bytes_per_round,
                "last_halo_bytes": self.last_halo_bytes,
                "replans": self.replans}

    def to_csr(self) -> CSRGraph:
        """Decode the live slot-space edge set back to a host CSRGraph over
        original ids (``delta.state_to_csr`` dispatches here)."""
        D, n_loc, blk = self.n_shards, self.n_loc, self.blk
        srcs, dsts = [], []
        for d in range(D):
            ell = _host(self.ell[d])
            osrc, odst = _host(self.ovf_src[d]), _host(self.ovf_dst[d])
            row, slot = np.nonzero(ell >= 0)
            tgt = ell[row, slot].astype(np.int64)
            live = (osrc >= 0) & (odst >= 0)
            row = np.concatenate([row.astype(np.int64),
                                  osrc[live].astype(np.int64)])
            tgt = np.concatenate([tgt, odst[live].astype(np.int64)])
            ghost = tgt >= n_loc
            gidx = np.clip(tgt - n_loc, 0, self.max_g_cap - 1)
            srcs.append(row + d * blk)
            dsts.append(np.where(ghost, self.ghost_ids[d][gidx],
                                 tgt + d * blk))
        edges = np.stack([np.concatenate(srcs), np.concatenate(dsts)],
                         axis=1)
        # cross-shard edges appear once per direction (one per owning
        # shard); symmetrize dedups the union back to the undirected set
        return from_edges(self.n, self.inv_perm[edges], symmetrize=True)


# --------------------------------------------------------------------------
# geometry helpers
# --------------------------------------------------------------------------

def _aligned_n_loc(n: int, D: int, n_chunks: int) -> int:
    """Per-shard row-table height: the block size rounded up so every
    shard's sweep divides into n_chunks (at D=1 this IS ``prepare``'s
    n_pad, which the bit-identity bar depends on)."""
    blk = -(-n // D)
    return -(-max(blk, n_chunks) // n_chunks) * n_chunks


def _valid_mask(n: int, D: int, blk: int, n_loc: int) -> np.ndarray:
    valid = np.zeros((D, n_loc), bool)
    for d in range(D):
        k = min(blk, n - d * blk)
        if k > 0:
            valid[d, :k] = True
    return valid


def _row_of(n: int, D: int, blk: int, n_loc: int) -> np.ndarray:
    v = np.arange(n, dtype=np.int64)
    d = np.minimum(v // blk, D - 1)
    return d * n_loc + (v - d * blk)


def _pri_table(pri_global: np.ndarray, plan, n: int, D: int,
               blk: int) -> np.ndarray:
    """(D, n_tab) priority table: local rows then ghost tail.  Ghost
    priorities ride in-table because the fused detect's asymmetric
    tie-break reads the *neighbor's* priority through the same gather as
    its color."""
    n_tab = plan.n_loc + plan.max_g_cap
    pri = np.full((D, n_tab), -1, np.int32)
    for d in range(D):
        lo, hi = d * blk, min((d + 1) * blk, n)
        if hi > lo:
            pri[d, :hi - lo] = pri_global[lo:hi]
        ng = int(plan.n_ghost[d])
        if ng:
            pri[d, plan.n_loc:plan.n_loc + ng] = \
                pri_global[plan.ghost_ids[d, :ng]]
    return pri


def _device_groups(devs) -> list:
    """(device, [shard ids]) for each distinct device, in shard order."""
    groups: dict = {}
    for d, dev in enumerate(devs):
        groups.setdefault(dev, []).append(d)
    return list(groups.items())


# --------------------------------------------------------------------------
# encode + from-scratch solve
# --------------------------------------------------------------------------

def _solve_scratch(ell, osrc, odst, pri_tab, valid, boundary, ghost_flat, *,
                   n, n_loc, D, mesh, axis, C0, n_chunks, impl, max_rounds,
                   max_cap_retries):
    """Run the sharded from-scratch loop under the shared cap-doubling
    retry (per-shard tensor lists in, host halo arrays beside them).
    Returns ((colors_tab list, r, trace, tot, ovf), C, retries)."""
    devs = mesh.shard_devices(axis)
    max_b = int(boundary.shape[1])
    max_g = int(ghost_flat.shape[1])
    valid_sh = dist._per_shard(valid, devs)
    bound_sh = dist._per_shard(boundary, devs)
    ghost_sh = dist._per_shard(ghost_flat, devs)

    def run(C):
        ctx = PassContext(n=n, n_pad=n_loc * D, C=C, n_chunks=n_chunks,
                          forbidden_impl=impl)
        fn = dist.build_sharded_scratch(mesh, axis, D, n_loc, max_b, max_g,
                                        ctx, max_rounds)
        return fn(ell, osrc, odst, pri_tab, valid_sh, bound_sh, ghost_sh)

    return col._run_with_retry(run, C0, engine="sharded",
                               max_retries=max_cap_retries)


def sharded_state(g: CSRGraph, mesh, axis: str = "data", seed: int = 0,
                  n_chunks: int = 16, ell_cap: int = 512,
                  C: Optional[int] = None, ell_slack: int = 4,
                  ovf_cap: Optional[int] = None, delta_cap: int = 2048,
                  frontier_frac: float = 0.125, max_rounds: int = 1000,
                  forbidden_impl: Optional[str] = None,
                  max_cap_retries: Optional[int] = None,
                  max_ovf_growth: Optional[int] = None
                  ) -> ShardedColoringState:
    """Partition + encode ``g`` over ``mesh`` and color it from scratch
    once (one halo exchange per round).

    The RNG stream is shared between the partition shuffle and the
    priority draw in ``prepare``'s order, so a 1-shard mesh reproduces the
    single-device ``dynamic_state`` encode — and therefore its colors —
    bit-for-bit.
    """
    impl = resolve_impl(forbidden_impl)
    devs = mesh.shard_devices(axis)
    D = len(devs)
    rng = np.random.default_rng(seed)
    with obs.phase("prepare"):
        part = part_mod.block_partition(g, D, rng=rng)       # rng draw 1
        blk = part.n_loc
        n = part.n
        n_loc = _aligned_n_loc(n, D, n_chunks)
        plan = part_mod.build_halo_mutable(
            part, n_loc=n_loc, ell_cap=ell_cap, ell_slack=ell_slack,
            ovf_cap=ovf_cap, delta_cap=delta_cap)
        pri_global = rng.permutation(n).astype(np.int32)     # rng draw 2
        pri_tab = _pri_table(pri_global, plan, n, D, blk)
        valid = _valid_mask(n, D, blk, n_loc)
        C0 = col._pick_C(part.graph, C)
        ell = dist._per_shard(plan.ell_local, devs)
        osrc = dist._per_shard(plan.ovf_src, devs)
        odst = dist._per_shard(plan.ovf_dst, devs)
        pri = dist._per_shard(pri_tab, devs)

    (tabs, r, trace, tot, _), final_C, retries = _solve_scratch(
        ell, osrc, odst, pri, valid, plan.boundary, plan.ghost_flat, n=n,
        n_loc=n_loc, D=D, mesh=mesh, axis=axis, C0=C0, n_chunks=n_chunks,
        impl=impl, max_rounds=max_rounds, max_cap_retries=max_cap_retries)

    hb = (1 + int(r)) * D * (plan.max_b_cap + 3) * 4
    return ShardedColoringState(
        ell=tuple(ell), ovf_src=tuple(osrc), ovf_dst=tuple(odst),
        pri_tab=tuple(pri), colors_tab=tuple(tabs),
        boundary=plan.boundary, n_boundary=plan.n_boundary,
        ghost_ids=plan.ghost_ids, ghost_flat=plan.ghost_flat,
        n_ghost=plan.n_ghost,
        n=n, blk=blk, n_loc=n_loc, n_shards=D, mesh=mesh, axis=axis,
        C=final_C, n_chunks=n_chunks,
        frontier_cap=frontier.frontier_cap(n_loc, n_chunks, frontier_frac),
        delta_cap=int(delta_cap), ell_cap=int(ell_cap),
        ell_slack=int(ell_slack),
        perm=part.perm, inv_perm=np.argsort(part.perm),
        pri_global=pri_global, row_of=_row_of(n, D, blk, n_loc),
        forbidden_impl=impl, max_rounds=int(max_rounds),
        version=0, last_rounds=int(r), last_conflicts=int(tot),
        last_gather_passes=1 + int(r), total_gather_passes=1 + int(r),
        retries=retries, ovf_grows=0, replans=0,
        last_halo_bytes=hb, total_halo_bytes=hb,
        max_cap_retries=max_cap_retries, max_ovf_growth=max_ovf_growth)


# --------------------------------------------------------------------------
# routing: undirected updates -> per-shard directed slot-space mutations
# --------------------------------------------------------------------------

class _Replan(Exception):
    """A batch outgrew the boundary/ghost slack; carries the per-shard
    capacities the re-planned halo must cover."""

    def __init__(self, need_b: int, need_g: int):
        self.need_b, self.need_g = int(need_b), int(need_g)


def _ranks(groups: np.ndarray, D: int) -> np.ndarray:
    """Occurrence number of each entry within its group (``groups`` in
    [0, D)), in array order."""
    order = np.argsort(groups, kind="stable")
    start = np.searchsorted(groups[order], np.arange(D))
    rank = np.empty(len(groups), np.int64)
    rank[order] = np.arange(len(groups)) - start[groups[order]]
    return rank


def _first_new(keys: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Positions (ascending) of the first occurrence of each key among the
    entries flagged ``new``."""
    pos = np.nonzero(new)[0]
    k = keys[pos]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    return pos[np.sort(order[first])]


def _route(state: ShardedColoringState, ins_r: np.ndarray,
           dels_r: np.ndarray):
    """Route relabeled-space undirected pairs to their owning shards.

    Returns ``(batches, alloc)``: ``batches[d]`` is shard d's directed
    ``(ins, dels)`` slot-space pairs for ``delta.plan_group``, ``alloc``
    the append-only ghost/boundary slot allocations to commit.  Allocation
    is unbounded here — capacity is checked once at the end so a single
    ``_Replan`` covers the whole batch's need.

    The pairs are walked in order, as the reference's loop does: a cross
    insert (u, v) first asks u's shard for a ghost of v, then v's shard for
    a ghost of u; a ghost that is new takes the next ghost slot of its
    shard and, if its vertex is not yet published, the next boundary slot
    of the vertex's owner.  Here those slots are ranks of first
    occurrences in that order of requests.

    A delete whose remote endpoint is not in the ghost table is a no-op on
    that shard (the edge cannot be present); it is routed as a (row, row)
    self-pair, which every wave body ignores but which still seeds the
    repair frontier — mirroring the single-device treatment of deletes of
    absent edges.
    """
    D, blk, n_loc, n = state.n_shards, state.blk, state.n_loc, state.n
    max_b = state.max_b_cap
    n_b = state.n_boundary.astype(np.int64)
    n_g = state.n_ghost.astype(np.int64)
    # gidx[d, v]: v's ghost slot on shard d (-1: none); bslot[v]: v's slot
    # in its owner's boundary list (-1: not published)
    gidx = np.full((D, n), -1, np.int32)
    bslot = np.full((n,), -1, np.int32)
    for d in range(D):
        gidx[d, state.ghost_ids[d, :n_g[d]]] = np.arange(n_g[d])
        bslot[state.boundary[d, :n_b[d]].astype(np.int64) + d * blk] = \
            np.arange(n_b[d])

    def shard(v):
        return np.minimum(v // blk, D - 1)

    ins = np.asarray(ins_r, np.int64).reshape(-1, 2)
    dels = np.asarray(dels_r, np.int64).reshape(-1, 2)
    u, v = ins[:, 0], ins[:, 1]
    du, dv = shard(u), shard(v)
    cross = (du != dv) & (u != v)
    # ghost requests in the loop's order: (shard du wants v, owner dv),
    # then (shard dv wants u, owner du), pair after pair
    ci = np.nonzero(cross)[0]
    req_sh = np.stack([du[ci], dv[ci]], 1).reshape(-1)
    req_v = np.stack([v[ci], u[ci]], 1).reshape(-1)
    req_own = np.stack([dv[ci], du[ci]], 1).reshape(-1)
    new_g = _first_new(req_sh * n + req_v, gidx[req_sh, req_v] < 0)
    g_sh, g_v, g_own = req_sh[new_g], req_v[new_g], req_own[new_g]
    gidx[g_sh, g_v] = n_g[g_sh] + _ranks(g_sh, D)
    new_b = _first_new(g_v, bslot[g_v] < 0)
    b_v, b_own = g_v[new_b], g_own[new_b]
    bslot[b_v] = n_b[b_own] + _ranks(b_own, D)
    g_flat = g_own * max_b + bslot[g_v]
    new_bnd = [(b_v[b_own == d] - d * blk).astype(np.int32)
               for d in range(D)]
    new_gst = [(g_v[g_sh == d], g_flat[g_sh == d].astype(np.int32))
               for d in range(D)]
    n_b = n_b + np.bincount(b_own, minlength=D)
    n_g = n_g + np.bincount(g_sh, minlength=D)

    def directed(pairs, allocate: bool):
        """Per shard, the (row, target) pairs of ``pairs`` in the loop's
        order: (u's row, v's slot) into u's shard, then (v's row, u's
        slot) into v's; a self-pair once, as (u, u).  Without
        ``allocate`` (deletes) a remote endpoint with no ghost slot
        routes as (row, row)."""
        a, b = pairs[:, 0], pairs[:, 1]
        sa, sb = shard(a), shard(b)
        same, selfp = sa == sb, a == b

        def target(s, x, y, sy):        # slot of y in x's shard s
            g = gidx[s, y]
            loc = y - s * blk
            if allocate:
                return np.where(sy == s, loc, n_loc + g)
            return np.where(sy == s, loc,
                            np.where(g >= 0, n_loc + g, x - s * blk))

        ta = np.where(selfp, a - sa * blk, target(sa, a, b, sb))
        tb = target(sb, b, a, sa)
        rows = np.stack([a - sa * blk, b - sb * blk], 1)
        tgts = np.stack([ta, tb], 1)
        shards = np.stack([sa, sb], 1)
        keep = np.stack([np.ones_like(selfp), ~selfp], 1)
        rows, tgts, shards = rows[keep], tgts[keep], shards[keep]
        return [np.stack([rows[shards == d], tgts[shards == d]], 1)
                .astype(np.int32).reshape(-1, 2) for d in range(D)]

    if int(n_b.max()) > max_b or int(n_g.max()) > state.max_g_cap:
        raise _Replan(int(n_b.max()), int(n_g.max()))
    ins_sh = directed(ins, True)
    del_sh = directed(dels, False)
    batches = [(ins_sh[d], del_sh[d]) for d in range(D)]
    return batches, (new_bnd, new_gst, n_b, n_g)


def _commit_alloc(state: ShardedColoringState, alloc):
    """Append routed slot allocations to the host halo tables and write
    the new ghosts' priorities into (copies of) the shards' tables.
    Returns the fields to replace (no-op fast path when the batch allocated
    nothing)."""
    new_bnd, new_gst, n_b, n_g = alloc
    if not any(len(b) for b in new_bnd) and \
            not any(len(ids) for ids, _ in new_gst):
        return {}
    D, n_loc = state.n_shards, state.n_loc
    boundary = state.boundary.copy()
    n_boundary = state.n_boundary.copy()
    ghost_ids = state.ghost_ids.copy()
    ghost_flat = state.ghost_flat.copy()
    n_ghost = state.n_ghost.copy()
    pri_tab = list(state.pri_tab)
    for d in range(D):
        if len(new_bnd[d]):
            j0 = int(state.n_boundary[d])
            boundary[d, j0:n_b[d]] = new_bnd[d]
            n_boundary[d] = n_b[d]
        ids, flats = new_gst[d]
        if len(ids):
            i0 = int(state.n_ghost[d])
            ghost_ids[d, i0:n_g[d]] = ids
            ghost_flat[d, i0:n_g[d]] = flats
            n_ghost[d] = n_g[d]
            # new ghost slots need priorities before the next detect; their
            # colors stay -1 — the repair's up-front exchange freshens them
            pri_tab[d] = pri_tab[d].clone()
            pri_tab[d][n_loc + i0:n_loc + int(n_g[d])] = torch.from_numpy(
                state.pri_global[ids]).to(pri_tab[d].device)
    return dict(boundary=boundary, n_boundary=n_boundary,
                ghost_ids=ghost_ids, ghost_flat=ghost_flat, n_ghost=n_ghost,
                pri_tab=tuple(pri_tab))


def _replan(state: ShardedColoringState, need_b: int,
            need_g: int) -> ShardedColoringState:
    """Rebuild the halo plan of the *current* graph with doubled (and
    need-covering) boundary/ghost capacity.

    The partition geometry — perm, blk, n_loc — is preserved, so colors and
    priorities (per-vertex quantities) carry over untouched; only the
    slot-space tables are re-derived.  Re-encoding also compacts stale
    ghost/boundary slots left behind by deletes.  Not a version bump: the
    served coloring is unchanged."""
    from repro_torch.obs import metrics as obs_metrics

    D, blk, n_loc, n = state.n_shards, state.blk, state.n_loc, state.n
    devs = state.devices
    g_rel = part_mod.relabel(state.to_csr(), state.perm)
    part = part_mod.Partition(n=n, n_pad=blk * D, n_shards=D, n_loc=blk,
                              perm=state.perm, graph=g_rel)
    plan = part_mod.build_halo_mutable(
        part, n_loc=n_loc, ell_cap=max(state.ell_cap, state.ell_width),
        ell_slack=state.ell_slack, ovf_cap=state.ovf_cap,
        delta_cap=state.delta_cap,
        min_b_cap=max(2 * state.max_b_cap, part_mod._slack_cap(need_b)),
        min_g_cap=max(2 * state.max_g_cap, part_mod._slack_cap(need_g)))
    n_tab = n_loc + plan.max_g_cap
    pri_tab = _pri_table(state.pri_global, plan, n, D, blk)
    flat = np.concatenate([_host(t[:n_loc]) for t in state.colors_tab])
    colors_tab = np.full((D, n_tab), -1, np.int32)
    colors_tab[:, :n_loc] = flat.reshape(D, n_loc)
    for d in range(D):          # ghost colors: fresh from their owners
        ng = int(plan.n_ghost[d])
        if ng:
            colors_tab[d, n_loc:n_loc + ng] = \
                flat[state.row_of[plan.ghost_ids[d, :ng]]]
    obs_metrics.counter("sharded.replan").inc()
    return dataclasses.replace(
        state, ell=tuple(dist._per_shard(plan.ell_local, devs)),
        ovf_src=tuple(dist._per_shard(plan.ovf_src, devs)),
        ovf_dst=tuple(dist._per_shard(plan.ovf_dst, devs)),
        pri_tab=tuple(dist._per_shard(pri_tab, devs)),
        colors_tab=tuple(dist._per_shard(colors_tab, devs)),
        boundary=plan.boundary, n_boundary=plan.n_boundary,
        ghost_ids=plan.ghost_ids, ghost_flat=plan.ghost_flat,
        n_ghost=plan.n_ghost, replans=state.replans + 1)


# --------------------------------------------------------------------------
# update application + repair
# --------------------------------------------------------------------------

def _grow_overflow_b(osrc_b, odst_b, factor: int = 2):
    """Uniform per-shard overflow growth (same cap math as
    ``delta.grow_overflow``, applied along axis 1 so every shard keeps the
    same buffer shape)."""
    S, cap = osrc_b.shape
    extra = torch.full((S, max(cap, 8) * (factor - 1)), int(FILL),
                       dtype=torch.int32, device=osrc_b.device)
    return (torch.cat([osrc_b, extra], dim=1),
            torch.cat([odst_b, extra], dim=1))


def _apply_waves(state: ShardedColoringState, batches):
    """Delete-then-insert wave application across all shards in lockstep:
    the shards of one device are the slots of ``dynamic/delta.py``'s
    bodies, one call a wave for all of them, with the uniform grow-and-retry
    loop of ``delta.apply_updates``.  The stacked tables are the batch's
    copies.  Returns per-shard lists (ell, osrc, odst, U) and the number of
    growths."""
    n_tab, n_loc = state.n_tab, state.n_loc
    ovf_w, ell_w, ins_w, touched = delta.plan_group(
        batches, state.delta_cap, n_tab, directed=True)
    groups = _device_groups(state.devices)
    ell_g = [torch.stack([state.ell[d] for d in ids]) for _, ids in groups]
    os_g = [torch.stack([state.ovf_src[d] for d in ids])
            for _, ids in groups]
    od_g = [torch.stack([state.ovf_dst[d] for d in ids])
            for _, ids in groups]

    def waves(w, gi):
        dev, ids = groups[gi]
        return delta._dev(w[:, ids], dev)

    for gi in range(len(groups)):
        for w in waves(ovf_w, gi):
            delta._delete_overflow_impl(os_g[gi], od_g[gi], w)
        for w in waves(ell_w, gi):
            delta._delete_ell_wave_impl(ell_g[gi], w[..., 0], w[..., 1])
    grows = 0
    n_ins = int(ins_w.shape[0])
    if n_ins:
        skeys = [delta._sort_overflow_impl(o, d) for o, d in zip(os_g, od_g)]
        ins_g = [waves(ins_w, gi) for gi in range(len(groups))]
    for j in range(n_ins):
        while True:
            fail = False
            for gi in range(len(groups)):
                w = ins_g[gi][j]
                fail |= bool(delta._insert_wave_impl(
                    ell_g[gi], os_g[gi], od_g[gi], skeys[gi], w[..., 0],
                    w[..., 1])[3].any())
            if not fail:
                break
            if (state.max_ovf_growth is not None
                    and grows >= state.max_ovf_growth):
                raise OvfGrowthExhausted(grows=grows,
                                         budget=state.max_ovf_growth,
                                         cap=int(os_g[0].shape[1]))
            # grown buffer holds this wave's partial spills: keep it, retake
            # the presence snapshot, re-apply the same wave (idempotent)
            for gi in range(len(groups)):
                os_g[gi], od_g[gi] = _grow_overflow_b(os_g[gi], od_g[gi])
                skeys[gi] = delta._sort_overflow_impl(os_g[gi], od_g[gi])
            grows += 1
    D = state.n_shards
    ell, osrc, odst, U = [None] * D, [None] * D, [None] * D, [None] * D
    for gi, (dev, ids) in enumerate(groups):
        for j, d in enumerate(ids):
            ell[d], osrc[d], odst[d] = ell_g[gi][j], os_g[gi][j], od_g[gi][j]
            U[d] = torch.from_numpy(touched[d, :n_loc].copy()).to(dev)
    return ell, osrc, odst, U, grows


def recolor_sharded(state: ShardedColoringState, inserts=None, deletes=None,
                    max_rounds: Optional[int] = None
                    ) -> ShardedColoringState:
    """Apply an undirected edge update batch and repair the sharded
    coloring — one collective per repair round, bytes ∝ boundary.

    ``inserts`` / ``deletes`` are (k, 2) arrays of *original* vertex ids;
    deletes apply before inserts.  Returns a new state; the input state is
    untouched.  On a 1-shard mesh this is bit-identical to
    ``recolor_incremental`` on the matching single-device state.
    """
    if max_rounds is None:
        max_rounds = state.max_rounds
    ins = _check_edges(inserts if inserts is not None else [], state.n,
                       "inserts")
    dels = _check_edges(deletes if deletes is not None else [], state.n,
                        "deletes")
    if len(ins) == 0 and len(dels) == 0:
        return state
    if faults.fires("ovf.exhaust"):
        raise OvfGrowthExhausted(grows=0, budget=state.max_ovf_growth,
                                 cap=state.ovf_cap, forced=True)

    ins_r = state.perm[ins] if len(ins) else ins
    dels_r = state.perm[dels] if len(dels) else dels
    with obs.phase("apply"):
        try:
            batches, alloc = _route(state, ins_r, dels_r)
        except _Replan as rp:
            state = _replan(state, rp.need_b, rp.need_g)
            batches, alloc = _route(state, ins_r, dels_r)
        repl = _commit_alloc(state, alloc)
        if repl:
            state = dataclasses.replace(state, **repl)
        ell, osrc, odst, U, grows = _apply_waves(state, batches)
        if obs.current_tracer() is not None:
            col._block_until_ready(U)

    D, n_loc = state.n_shards, state.n_loc
    devs = state.devices
    valid = dist._per_shard(_valid_mask(state.n, D, state.blk, n_loc), devs)
    bound = dist._per_shard(state.boundary, devs)
    ghost = dist._per_shard(state.ghost_flat, devs)

    def run(C):
        ctx = PassContext(n=state.n, n_pad=n_loc * D, C=C,
                          n_chunks=state.n_chunks,
                          forbidden_impl=state.forbidden_impl)
        fn = dist.build_sharded_repair(state.mesh, state.axis, D, n_loc,
                                       state.max_b_cap, state.max_g_cap, ctx,
                                       state.frontier_cap, max_rounds)
        return fn(ell, osrc, odst, list(state.pri_tab),
                  list(state.colors_tab), U, valid, bound, ghost)

    (tabs, r, trace, tot, _), C, retries = col._run_with_retry(
        run, state.C, engine="sharded", max_retries=state.max_cap_retries)
    passes = int(r)
    # collectives: one up-front ghost refresh + one per repair round
    hb = (1 + passes) * state.halo_bytes_per_round
    return dataclasses.replace(
        state, ell=tuple(ell), ovf_src=tuple(osrc), ovf_dst=tuple(odst),
        colors_tab=tuple(tabs),
        C=C, version=state.version + 1, last_rounds=passes,
        last_conflicts=int(tot), last_gather_passes=passes,
        total_gather_passes=state.total_gather_passes + passes,
        retries=state.retries + retries, ovf_grows=state.ovf_grows + grows,
        last_halo_bytes=hb, total_halo_bytes=state.total_halo_bytes + hb,
        last_degrade_rung=0)


# --------------------------------------------------------------------------
# degradation-ladder rungs (dispatched from resilience/ladder.py)
# --------------------------------------------------------------------------

def scratch_sharded(state: ShardedColoringState, inserts=None,
                    deletes=None) -> ShardedColoringState:
    """Rung 1: re-encode + recolor the updated graph through the
    ``api.color`` front door on the tenant's own mesh, inheriting its
    statics and budgets.  Mirrors ``ladder.scratch_state``, including the
    rung attribution when the engine itself had to drop to the oracle."""
    from repro_torch import api
    from repro_torch.resilience.ladder import updated_graph

    empty = np.zeros((0, 2), np.int64)
    g2 = updated_graph(state, empty if inserts is None else inserts,
                       empty if deletes is None else deletes)
    res = api.color(
        g2, mode="incremental", backend="distributed", mesh=state.mesh,
        axis=state.axis, seed=0, n_chunks=state.n_chunks,
        ell_cap=state.ell_width, ell_slack=0, C=None,
        ovf_cap=state.ovf_cap, delta_cap=state.delta_cap,
        max_rounds=state.max_rounds, forbidden_impl=state.forbidden_impl,
        max_cap_retries=state.max_cap_retries,
        max_ovf_growth=state.max_ovf_growth)
    st = res.state
    rung = 2 if st.last_degrade_rung == 2 else 1
    return dataclasses.replace(
        st, version=state.version + 1, last_degrade_rung=rung,
        retries=state.retries + st.retries, ovf_grows=state.ovf_grows,
        replans=state.replans,
        total_gather_passes=(state.total_gather_passes
                             + st.total_gather_passes),
        total_halo_bytes=state.total_halo_bytes + st.total_halo_bytes)


def oracle_sharded(state: ShardedColoringState, inserts=None,
                   deletes=None) -> ShardedColoringState:
    """Rung 2: serial First-Fit on the host + pure sharded encode — no
    device coloring loop, no collective, nothing left to exhaust."""
    from repro_torch.resilience.ladder import updated_graph

    empty = np.zeros((0, 2), np.int64)
    g2 = updated_graph(state, empty if inserts is None else inserts,
                       empty if deletes is None else deletes)
    st = encode_oracle_sharded(
        g2, state.mesh, axis=state.axis, seed=0, n_chunks=state.n_chunks,
        ell_cap=state.ell_width, ell_slack=0, ovf_cap=state.ovf_cap,
        delta_cap=state.delta_cap, max_rounds=state.max_rounds,
        forbidden_impl=state.forbidden_impl,
        max_cap_retries=state.max_cap_retries,
        max_ovf_growth=state.max_ovf_growth)
    return dataclasses.replace(
        st, version=state.version + 1, retries=state.retries,
        ovf_grows=state.ovf_grows, replans=state.replans,
        total_gather_passes=state.total_gather_passes,
        total_halo_bytes=state.total_halo_bytes)


def encode_oracle_sharded(g: CSRGraph, mesh, axis: str = "data", *,
                          seed: int = 0, n_chunks: int = 16,
                          ell_cap: int = 512, ell_slack: int = 4,
                          ovf_cap: Optional[int] = None,
                          delta_cap: int = 2048,
                          frontier_frac: float = 0.125,
                          max_rounds: int = 1000,
                          forbidden_impl: Optional[str] = None,
                          max_cap_retries: Optional[int] = None,
                          max_ovf_growth: Optional[int] = None
                          ) -> ShardedColoringState:
    """Serial-oracle colors + the standard sharded encode of ``g`` — the
    sharded counterpart of ``ladder.encode_oracle_state``.  The RNG stream
    is threaded exactly like ``sharded_state`` so the layout (and any later
    1-shard differential run) is deterministic."""
    impl = resolve_impl(forbidden_impl)
    devs = mesh.shard_devices(axis)
    D = len(devs)
    colors = col.greedy_sequential(g)
    rng = np.random.default_rng(seed)
    part = part_mod.block_partition(g, D, rng=rng)           # rng draw 1
    blk, n = part.n_loc, part.n
    n_loc = _aligned_n_loc(n, D, n_chunks)
    plan = part_mod.build_halo_mutable(
        part, n_loc=n_loc, ell_cap=ell_cap, ell_slack=ell_slack,
        ovf_cap=ovf_cap, delta_cap=delta_cap)
    pri_global = rng.permutation(n).astype(np.int32)         # rng draw 2
    pri_tab = _pri_table(pri_global, plan, n, D, blk)
    row_of = _row_of(n, D, blk, n_loc)

    colors_rel = np.full((n,), -1, np.int32)
    colors_rel[part.perm] = colors
    n_tab = n_loc + plan.max_g_cap
    colors_tab = np.full((D, n_tab), -1, np.int32)
    for d in range(D):
        lo, hi = d * blk, min((d + 1) * blk, n)
        if hi > lo:
            colors_tab[d, :hi - lo] = colors_rel[lo:hi]
        ng = int(plan.n_ghost[d])
        if ng:
            colors_tab[d, n_loc:n_loc + ng] = \
                colors_rel[plan.ghost_ids[d, :ng]]
    n_used = int(colors.max()) + 1 if len(colors) else 1
    C = max(32, -(-n_used // 32) * 32)   # headroom for future repairs
    return ShardedColoringState(
        ell=tuple(dist._per_shard(plan.ell_local, devs)),
        ovf_src=tuple(dist._per_shard(plan.ovf_src, devs)),
        ovf_dst=tuple(dist._per_shard(plan.ovf_dst, devs)),
        pri_tab=tuple(dist._per_shard(pri_tab, devs)),
        colors_tab=tuple(dist._per_shard(colors_tab, devs)),
        boundary=plan.boundary, n_boundary=plan.n_boundary,
        ghost_ids=plan.ghost_ids, ghost_flat=plan.ghost_flat,
        n_ghost=plan.n_ghost,
        n=n, blk=blk, n_loc=n_loc, n_shards=D, mesh=mesh, axis=axis,
        C=C, n_chunks=n_chunks,
        frontier_cap=frontier.frontier_cap(n_loc, n_chunks, frontier_frac),
        delta_cap=int(delta_cap), ell_cap=int(ell_cap),
        ell_slack=int(ell_slack),
        perm=part.perm, inv_perm=np.argsort(part.perm),
        pri_global=pri_global, row_of=row_of,
        forbidden_impl=impl, max_rounds=int(max_rounds), version=0,
        max_cap_retries=max_cap_retries, max_ovf_growth=max_ovf_growth,
        last_degrade_rung=2)


# --------------------------------------------------------------------------
# registry adapter: (rsoc, 1, incremental, distributed) through repro_torch.api
# --------------------------------------------------------------------------

@registry.register_engine("rsoc", distance=1, mode="incremental",
                          backend="distributed", replaces="sharded_state")
def _sharded_engine(g: CSRGraph, spec, *, mesh=None,
                    axis: str = "data") -> col.ColoringResult:
    """Encode ``g`` over the mesh and color it from scratch once; the
    ``ShardedColoringState`` rides the result's ``state`` field so the
    ``ColoringService`` keeps applying ``recolor_sharded`` batches to it.

    Like the single-device incremental engine, a from-scratch solve that
    exhausts a finite ``spec.max_cap_retries`` drops straight to the serial
    oracle encode (rung 2) instead of failing the add."""
    if mesh is None:
        raise ValueError(dist._NO_MESH)
    opts = dict(
        axis=axis, seed=spec.seed, n_chunks=spec.n_chunks,
        ell_cap=spec.ell_cap, ell_slack=spec.ell_slack,
        ovf_cap=spec.ovf_cap, delta_cap=spec.delta_cap,
        frontier_frac=spec.frontier_frac, max_rounds=spec.max_rounds,
        forbidden_impl=spec.forbidden_impl,
        max_cap_retries=spec.max_cap_retries,
        max_ovf_growth=spec.max_ovf_growth)
    try:
        st = sharded_state(g, mesh, C=spec.C, **opts)
    except CapRetryExhausted:
        from repro_torch.obs import metrics as _metrics
        _metrics.counter("resilience.degrade", rung="oracle").inc()
        st = encode_oracle_sharded(g, mesh, **opts)
    colors = st.colors
    return col.ColoringResult(
        colors=colors, n_rounds=st.last_rounds,
        conflicts_per_round=np.array([st.last_conflicts]),
        total_conflicts=st.last_conflicts,
        n_colors=col.n_colors_used(colors),
        overflow=st.retries > 0, gather_passes=st.last_gather_passes,
        final_C=st.C, retries=st.retries, distance=1, state=st,
        degrade_rung=st.last_degrade_rung)
