"""Vertex partitioning + halo metadata for distributed coloring (the port of
the reference's ``core/partition.py``; numpy only, like it).

The replicated scheme keeps the whole color vector on every shard and
re-gathers it once a round.  The halo scheme exchanges only *boundary*
colors; this module builds the static metadata both need:

  * block partition of [0, n) into D contiguous shards (after a
    *block-preserving* relabel: vertices are shuffled within their shard so
    chunks decorrelate, but shard membership — and hence partition locality —
    is preserved),
  * per-shard boundary list (my vertices referenced by other shards), padded
    to the max across shards,
  * per-shard ghost table (external vertices I reference) with (owner shard,
    slot in owner's boundary list) coordinates, padded likewise,
  * an ELL remap: neighbor ids -> local slot [0, n_loc) or ghost slot
    n_loc + g.

Every output is array-equal to the reference's.  Where the reference walks
the cross edges with Python sets and dicts, this module sorts: the boundary
and ghost lists are the sorted distinct keys of the cross edges
(``sorted_unique``), and a vertex's boundary slot and ghost slot are read
from dense per-vertex index arrays (at 2^22 vertices there are tens of
millions of cross edges).  The relabel sorts the relabeled edge keys once
where ``from_edges`` takes a stable ``argsort``: the keys are unique, so
both give the same CSR.  ``sorted_unique`` is ``np.sort`` and a mask, not
``np.unique``: NumPy 2.3's ``np.unique`` first hashes the values, which took
40 s for 16.8M int64 keys on the H100 host where the sort took 0.35 s.  The
per-block ``rng.shuffle`` loop stays as it is: it is the RNG stream that a
1-shard partition shares with ``core.coloring.prepare``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.csr import CSRGraph, FILL, to_edge_list


@dataclasses.dataclass(frozen=True)
class Partition:
    n: int
    n_pad: int               # n rounded up to D * n_loc
    n_shards: int
    n_loc: int
    perm: np.ndarray          # old id -> new id (block-preserving shuffle)
    graph: CSRGraph           # relabeled graph


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    boundary: np.ndarray      # (D, max_b) local slots I must publish, FILL pad
    n_boundary: np.ndarray    # (D,)
    ghost_owner: np.ndarray   # (D, max_g) owning shard of each ghost, FILL pad
    ghost_slot: np.ndarray    # (D, max_g) slot in owner's boundary list
    ell_local: np.ndarray     # (D, n_loc, W) remapped ELL: [0,n_loc) local,
                              # n_loc+g ghosts, FILL pad
    max_b: int
    max_g: int


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a``, ascending (``np.unique(a)``)."""
    a = np.sort(a)
    if len(a) > 1:
        a = a[np.concatenate([[True], a[1:] != a[:-1]])]
    return a


def _index_of(ids: np.ndarray, n: int) -> np.ndarray:
    """(n,) int64: position of each vertex in ``ids`` (distinct ids), -1
    for the others."""
    out = np.full((n,), -1, np.int64)
    out[ids] = np.arange(len(ids))
    return out


def _csr_from_keys(n: int, keys: np.ndarray) -> CSRGraph:
    """CSR of the directed edges with keys ``src * n + dst`` (self-loops
    already dropped): ``graphs.csr.from_edges(..., symmetrize=False)``'s
    output, from one sort of the keys."""
    keys = sorted_unique(keys)
    src = keys // max(n, 1)
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr,
                    indices=(keys - src * n).astype(np.int32), n_vertices=n)


def relabel(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """``from_edges(n, perm[to_edge_list(g)], symmetrize=False)``."""
    n = g.n_vertices
    e = to_edge_list(g)
    src = perm[e[:, 0]].astype(np.int64)
    dst = perm[e[:, 1]].astype(np.int64)
    keep = src != dst
    return _csr_from_keys(n, src[keep] * n + dst[keep])


def block_partition(g: CSRGraph, n_shards: int, seed: int = 0,
                    rng: np.random.Generator | None = None) -> Partition:
    """``rng`` lets a caller share one numpy stream across the partition
    shuffle and its own later draws (the sharded encoder threads the same
    generator through here and the priority draw, so a 1-shard partition
    replays ``core.coloring.prepare``'s stream exactly)."""
    n = g.n_vertices
    n_loc = -(-n // n_shards)
    n_pad = n_loc * n_shards
    rng = np.random.default_rng(seed) if rng is None else rng
    # shuffle within each shard's contiguous block only
    perm = np.arange(n, dtype=np.int64)
    for d in range(n_shards):
        lo, hi = d * n_loc, min((d + 1) * n_loc, n)
        if hi > lo:
            block = perm[lo:hi].copy()
            rng.shuffle(block)
            perm[lo:hi] = block
    return Partition(n=n, n_pad=n_pad, n_shards=n_shards, n_loc=n_loc,
                     perm=perm, graph=relabel(g, perm))


def _cross_lists(e: np.ndarray, n: int, shard_of, D: int):
    """Boundary and ghost lists of the directed edges ``e`` (int64) over
    ``n`` vertices: the sorted distinct remote targets of each shard's rows
    (ghosts), and the sorted distinct targets of cross edges (boundary).
    Returns (boundary_lists, ghost_lists, bslot): ``bslot[v]`` is boundary
    vertex v's slot in its owner's list."""
    s_src, s_dst = shard_of(e[:, 0]), shard_of(e[:, 1])
    cross = s_src != s_dst
    v = e[cross, 1]
    bnd = sorted_unique(v)                   # sorted, so grouped by owner
    bowner = shard_of(bnd)
    bstart = np.searchsorted(bowner, np.arange(D))
    bend = np.searchsorted(bowner, np.arange(D), side="right")
    bslot = np.full((n,), -1, np.int64)
    bslot[bnd] = np.arange(len(bnd)) - bstart[bowner]
    boundary_lists = [bnd[bstart[d]:bend[d]] for d in range(D)]
    gkey = sorted_unique(s_src[cross] * n + v)   # (shard, id) sorted
    gshard = gkey // max(n, 1)
    gstart = np.searchsorted(gshard, np.arange(D))
    gend = np.searchsorted(gshard, np.arange(D), side="right")
    ghost_lists = [gkey[gstart[d]:gend[d]] - d * n for d in range(D)]
    return boundary_lists, ghost_lists, bslot


def build_halo(part: Partition, ell_width: int | None = None) -> HaloPlan:
    g, D, n_loc, n = part.graph, part.n_shards, part.n_loc, part.n
    W = ell_width or max(1, g.max_degree)
    if g.max_degree > W:
        raise ValueError("halo plan requires ell width >= max degree")
    shard_of = lambda v: np.minimum(v // n_loc, D - 1)   # noqa: E731

    e = to_edge_list(g).astype(np.int64)
    boundary_lists, ghost_lists, bslot = _cross_lists(e, n, shard_of, D)
    max_b = max(1, max(len(b) for b in boundary_lists))
    max_g = max(1, max(len(s) for s in ghost_lists))

    boundary = np.full((D, max_b), FILL, np.int32)
    n_boundary = np.zeros((D,), np.int32)
    ghost_owner = np.full((D, max_g), FILL, np.int32)
    ghost_slot = np.full((D, max_g), FILL, np.int32)
    for d in range(D):
        b = boundary_lists[d]
        boundary[d, :len(b)] = b - d * n_loc  # local slots
        n_boundary[d] = len(b)
        gl = ghost_lists[d]
        ghost_owner[d, :len(gl)] = shard_of(gl)
        ghost_slot[d, :len(gl)] = bslot[gl]

    # remapped ELL per shard
    ell_local = np.full((D, n_loc, W), FILL, np.int32)
    deg = g.degrees
    row = np.repeat(np.arange(n), deg)
    col = np.arange(g.n_edges) - np.repeat(g.indptr[:-1], deg)
    dst = g.indices.astype(np.int64)
    dshard = shard_of(row)
    nshard = shard_of(dst)
    local_rows = row - dshard * n_loc
    # local neighbors -> local slot
    same = dshard == nshard
    ell_local[dshard[same], local_rows[same], col[same]] = (dst[same] - nshard[same] * n_loc)
    # remote neighbors -> n_loc + ghost index (position in my ghost list)
    for d in range(D):
        m = (~same) & (dshard == d)
        if m.any():
            gidx = _index_of(ghost_lists[d], n)[dst[m]]
            ell_local[d, local_rows[m], col[m]] = n_loc + gidx
    return HaloPlan(boundary=boundary, n_boundary=n_boundary,
                    ghost_owner=ghost_owner, ghost_slot=ghost_slot,
                    ell_local=ell_local, max_b=max_b, max_g=max_g)


@dataclasses.dataclass(frozen=True)
class MutableHaloPlan:
    """Halo metadata over the *mutable* per-shard ELL+overflow layout
    (DESIGN.md §15): unlike ``HaloPlan`` the row tables carry slack (extra
    FILL columns per row, spare boundary/ghost capacity) so edge inserts
    land in place instead of forcing an immediate re-plan, and hub rows
    spill to a per-shard overflow COO exactly like the single-device
    mutable encode."""

    ell_local: np.ndarray     # (D, n_loc, W+slack) slot-space ELL, FILL pad
    ovf_src: np.ndarray       # (D, ovf_cap) per-shard overflow COO rows
    ovf_dst: np.ndarray       # (D, ovf_cap) slot-space overflow targets
    boundary: np.ndarray      # (D, max_b_cap) local slots to publish, FILL
    n_boundary: np.ndarray    # (D,) live boundary slots
    ghost_ids: np.ndarray     # (D, max_g_cap) global (relabeled) ghost ids
    ghost_flat: np.ndarray    # (D, max_g_cap) owner*max_b_cap + slot, FILL
    n_ghost: np.ndarray       # (D,) live ghost slots
    n_loc: int                # row-table height (>= partition block size)
    max_b_cap: int
    max_g_cap: int
    ell_width: int            # W before slack columns


def _slack_cap(k: int, lo: int = 8) -> int:
    """Capacity with ~25% (min 8 slots) headroom so the first few inserts
    never trigger a re-plan."""
    return max(lo, k + max(8, k // 4))


def build_halo_mutable(part: Partition, *, n_loc: int | None = None,
                       ell_cap: int = 512, ell_slack: int = 4,
                       ovf_cap: int | None = None, delta_cap: int = 2048,
                       min_b_cap: int = 0,
                       min_g_cap: int = 0) -> MutableHaloPlan:
    """Mutable-ELL halo plan: per-shard slot-space neighbor tables with
    slack, overflow spill for hub rows, and capacity-slacked boundary/ghost
    arrays.  ``n_loc`` overrides the row-table height (the sharded engine
    passes the chunk-aligned height so each shard's sweep divides evenly);
    shard *membership* always follows ``part.n_loc`` blocks.  On a 1-shard
    partition the ELL/overflow arrays are bit-identical to
    ``core.coloring.prepare``'s mutable encode of the same graph."""
    g, D, blk, n = part.graph, part.n_shards, part.n_loc, part.n
    n_loc = blk if n_loc is None else int(n_loc)
    if n_loc < blk:
        raise ValueError(f"n_loc={n_loc} below partition block size {blk}")
    shard_of = lambda v: np.minimum(v // blk, D - 1)   # noqa: E731
    W = max(1, min(g.max_degree, ell_cap))

    # ghost/boundary membership from ALL cross edges (ELL or overflow alike:
    # an overflow edge's remote endpoint still needs a ghost color slot)
    e = to_edge_list(g).astype(np.int64)
    boundary_lists, ghost_lists, bslot = _cross_lists(e, n, shard_of, D)
    del e
    max_b_cap = max(_slack_cap(max(len(b) for b in boundary_lists)),
                    int(min_b_cap))
    max_g_cap = max(_slack_cap(max(len(s) for s in ghost_lists)),
                    int(min_g_cap))

    boundary = np.full((D, max_b_cap), FILL, np.int32)
    n_boundary = np.zeros((D,), np.int32)
    ghost_ids = np.full((D, max_g_cap), FILL, np.int64)
    ghost_flat = np.full((D, max_g_cap), FILL, np.int32)
    n_ghost = np.zeros((D,), np.int32)
    for d in range(D):
        b = boundary_lists[d]
        boundary[d, :len(b)] = (b - d * blk).astype(np.int32)
        n_boundary[d] = len(b)
        gl = ghost_lists[d]
        ghost_ids[d, :len(gl)] = gl
        n_ghost[d] = len(gl)
        ghost_flat[d, :len(gl)] = shard_of(gl) * max_b_cap + bslot[gl]

    # slot-space ELL + per-shard overflow spill, in CSR order (bit-identical
    # to prepare()'s hub spill on a 1-shard partition)
    deg = g.degrees
    row = np.repeat(np.arange(n), deg)
    col = np.arange(g.n_edges) - np.repeat(g.indptr[:-1], deg)
    dst = g.indices.astype(np.int64)
    dshard = shard_of(row)
    nshard = shard_of(dst)
    local_rows = row - dshard * blk
    slot = np.empty(len(dst), np.int64)
    same = dshard == nshard
    slot[same] = dst[same] - nshard[same] * blk
    for d in range(D):
        m = (~same) & (dshard == d)
        if m.any():
            slot[m] = n_loc + _index_of(ghost_lists[d], n)[dst[m]]
    in_ell = col < W
    ell_local = np.full((D, n_loc, W + ell_slack), FILL, np.int32)
    ell_local[dshard[in_ell], local_rows[in_ell], col[in_ell]] = \
        slot[in_ell].astype(np.int32)
    spill = ~in_ell
    per_shard = np.bincount(dshard[spill], minlength=D)
    n_ovf_max = int(per_shard.max()) if D else 0
    cap = (int(ovf_cap) if ovf_cap is not None
           else max(64, 2 * n_ovf_max, delta_cap // 2))
    cap = max(cap, n_ovf_max, 8)
    ovf_src = np.full((D, cap), FILL, np.int32)
    ovf_dst = np.full((D, cap), FILL, np.int32)
    for d in range(D):
        m = spill & (dshard == d)
        k = int(per_shard[d])
        if k:
            ovf_src[d, :k] = local_rows[m].astype(np.int32)
            ovf_dst[d, :k] = slot[m].astype(np.int32)
    return MutableHaloPlan(
        ell_local=ell_local, ovf_src=ovf_src, ovf_dst=ovf_dst,
        boundary=boundary, n_boundary=n_boundary, ghost_ids=ghost_ids,
        ghost_flat=ghost_flat, n_ghost=n_ghost, n_loc=n_loc,
        max_b_cap=max_b_cap, max_g_cap=max_g_cap, ell_width=W)


def partition_stats(part: Partition) -> dict:
    e = to_edge_list(part.graph).astype(np.int64)
    s = np.minimum(e // part.n_loc, part.n_shards - 1)
    cross_m = (s[:, 0] != s[:, 1]) if len(e) else np.zeros(0, bool)
    cross = cross_m.mean() if len(e) else 0.0
    # boundary vertices: endpoints some *other* shard references (the edge
    # list carries both directions, so dst-side endpoints cover the set)
    bverts = (sorted_unique(e[cross_m, 1]) if len(e)
              else np.zeros(0, np.int64))
    if len(bverts):
        owners = np.minimum(bverts // part.n_loc, part.n_shards - 1)
        max_b = int(np.bincount(owners, minlength=part.n_shards).max())
    else:
        max_b = 0
    # one halo exchange gathers (max_b colors + 1 count) int32 per shard
    # (the static build_rsoc_halo payload); O(boundary), not O(n)
    return {"cross_edge_frac": float(cross), "n_shards": part.n_shards,
            "n_loc": part.n_loc,
            "boundary_frac": float(len(bverts) / max(1, part.n)),
            "halo_bytes_per_round": int(part.n_shards * (max_b + 1) * 4)}
