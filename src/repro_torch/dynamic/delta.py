"""Batched edge insert/delete against the device-resident ELL+overflow
encoding (DESIGN.md §7.1; the port of the reference's ``dynamic/delta.py``).

The mutable graph lives on the device as the same two structures the
coloring passes consume: a fixed-shape ``(n_pad, W)`` ELL slot table (FILL =
empty slot) and a fixed-capacity COO overflow buffer for edges that do not
fit their row (capped-width hubs, or rows filled up by later inserts):

  * delete (u,v): clear every slot equal to v in row u (and u in row v),
    and every overflow slot holding (u,v) or (v,u).  Cleared slots become
    FILL holes that later inserts re-use.
  * insert (u,v): no-op if the edge is already present (ELL row or
    overflow); otherwise write into the first FILL slot, spilling to the
    first FILL overflow slots when the row is full.  If the overflow
    buffer is full the wave reports failure and the host doubles the
    buffer and re-applies — application is idempotent.

Wave *planning* (host numpy: chunking, wave grouping, FILL padding, the
touched mask) is the reference's, unchanged: ``plan_updates`` for one
tenant, ``plan_group`` for a megabatch slot class (DESIGN.md §13).  ELL
mutations are grouped into **waves** whose target rows are unique, so each
wave is one conflict-free gather/mutate/scatter over ``(delta_cap, W)``
tiles; an all-FILL wave is a no-op through every body.

How the bodies run here (DESIGN_TORCH.md §15).  The reference computes them
in jnp, not in a Pallas kernel, so plain torch ops on the state's device
are their port.  Each body is written once over an explicit leading *slot*
axis — ``ell (S, n_pad, W)``, ``osrc (S, ocap)``, waves ``(S, delta_cap)``
— where the reference ``vmap``s: the per-tenant path calls it with S = 1,
the megabatched path with a whole slot class, one call a wave for every
slot.  Three translations keep them bit-identical to the reference:

  * ``.at[i].set(x, mode="drop")`` becomes ``_set_at``: an ``index_add_``
    of the change ``x - current`` where the entry lands and of 0 where it
    is dropped (at its clamped position), so dropped entries write nothing
    whatever position they share with a landing one.
  * pair membership (``_pair_member``, a lexicographic binary search in the
    reference, which runs without 64-bit integers) is an int64 fused key
    ``(s << 32) | d`` and ``torch.searchsorted``; the sentinel pair
    ``(2**31 - 1, 2**31 - 1)`` still sorts last.
  * the first free ELL slot is ``argmax`` over ``uint8`` (the first
    maximum, as ``jnp.argmax``), and the free overflow slots are taken in
    ascending order (``_first_free``, as ``jnp.nonzero(size=k)``): the j-th
    spilling entry takes the j-th free slot, so the buffer layout matches
    bit for bit.

**Copy-on-write.**  The bodies write in place into the tensors they are
given.  ``apply_updates`` gives them copies made once per batch, before the
first write, so a state's tensors are never written after it is made: the
service's snapshot and rollback rest on that (the reference's arrays are
immutable).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import sorted_unique
from repro_torch.graphs.csr import CSRGraph, FILL, ell_to_edges, from_edges
from repro_torch.resilience import faults
from repro_torch.resilience.errors import OvfGrowthExhausted

_SENTINEL = 2147483647                       # sorts after any id
_SENT_KEY = (_SENTINEL << 32) | _SENTINEL    # the sentinel pair's key


# --------------------------------------------------------------------------
# wave bodies over a leading slot axis (S = 1 for one tenant)
# --------------------------------------------------------------------------

def _key(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int64 key ``(s << 32) | d`` of int32 pairs: injective and ordered
    lexicographically for ids in [0, 2**31); a pair with a negative member
    gets a negative key, which no sorted key (all >= 0) equals."""
    return (s.to(torch.int64) << 32) | d.to(torch.int64)


def _member(qkey: torch.Tensor, sorted_keys: torch.Tensor) -> torch.Tensor:
    """found[s, i] = qkey[s, i] is in row s of ``sorted_keys`` (each row
    ascending)."""
    nb = sorted_keys.shape[1]
    if nb == 0:
        return torch.zeros(qkey.shape, dtype=torch.bool, device=qkey.device)
    pos = torch.searchsorted(sorted_keys, qkey)
    hit = sorted_keys.gather(1, pos.clamp(max=nb - 1))
    return (pos < nb) & (hit == qkey)


def _set_at(flat: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
            land: torch.Tensor) -> None:
    """``flat[pos] = val`` where ``land`` (positions unique there), nothing
    elsewhere: the change is added, and a dropped entry adds 0 wherever its
    (clamped) position lies.  ``flat`` is a view of the tensor written
    (``view(-1)``, never a copy)."""
    pos = pos.reshape(-1)
    cur = flat[pos]
    flat.index_add_(0, pos, torch.where(land.reshape(-1),
                                        val.reshape(-1).to(flat.dtype) - cur,
                                        torch.zeros_like(cur)))


def _first_free(isfree: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Per row of ``isfree`` (S, m), the column ids of its first k True
    entries in ascending order, padded with ``fill``: the reference's
    ``jnp.nonzero(row, size=k, fill_value=fill)`` for every slot at once."""
    S, m = isfree.shape
    out = torch.full((S, k + 1), fill, dtype=torch.int64,
                     device=isfree.device)
    rank = isfree.cumsum(1) - 1
    col = torch.where(isfree & (rank < k), rank, k)     # column k: a sink
    out.scatter_(1, col, torch.arange(m, device=isfree.device).expand(S, m))
    return out[:, :k]


def _rows_at(ell: torch.Tensor, a: torch.Tensor):
    """(rows (S, k, W), their flat element positions (S, k, W), clamped
    row ids (S, k)) of rows ``a`` (S, k) of the slots' tables."""
    S, n_pad, W = ell.shape
    asafe = a.clamp(0, n_pad - 1).to(torch.int64)
    base = torch.arange(S, device=ell.device)[:, None] * n_pad + asafe
    pos = base[..., None] * W + torch.arange(W, device=ell.device)
    return ell.reshape(-1)[pos], pos, asafe


def _delete_overflow_impl(osrc, odst, dels):
    """Clear every overflow slot matching a delete pair (either direction),
    in place.  osrc, odst (S, ocap); dels (S, k, 2).  Delete pairs (both
    directions) are sorted as fused keys and each overflow slot runs one
    ``searchsorted``."""
    valid_d = (dels[..., 0] >= 0) & (dels[..., 1] >= 0)
    ds = torch.where(valid_d[..., None], dels,
                     torch.full((), _SENTINEL, dtype=dels.dtype,
                                device=dels.device))
    keys = torch.cat([_key(ds[..., 0], ds[..., 1]),
                      _key(ds[..., 1], ds[..., 0])], dim=1)
    keys = torch.sort(keys, dim=1).values
    dead = ((osrc >= 0) & (odst >= 0)
            & _member(_key(osrc, odst), keys))
    osrc.masked_fill_(dead, int(FILL))
    odst.masked_fill_(dead, int(FILL))
    return osrc, odst


def _delete_ell_wave_impl(ell, a, b):
    """Clear slots == b[s, i] in row a[s, i], in place; rows unique within
    each slot's wave.  ell (S, n_pad, W); a, b (S, k)."""
    rows, pos, _ = _rows_at(ell, a)
    new = torch.where((b[..., None] >= 0) & (rows == b[..., None]),
                      torch.full((), int(FILL), dtype=rows.dtype,
                                 device=rows.device), rows)
    _set_at(ell.view(-1), pos, new,
            (a >= 0)[..., None].expand_as(pos))     # drop padded entries
    return ell


def _sort_overflow_impl(osrc, odst):
    """Sorted-presence snapshot of the overflow buffers: (S, ocap) int64
    fused keys, FILL slots as the sentinel key (sorted past the end).  One
    snapshot per *batch* suffices: ``plan_updates`` dedups directed pairs,
    so no wave queries a pair an earlier wave of the same batch spilled."""
    olive = (osrc >= 0) & (odst >= 0)
    key = torch.where(olive, _key(osrc, odst),
                      torch.full((), _SENT_KEY, dtype=torch.int64,
                                 device=osrc.device))
    return torch.sort(key, dim=1).values


def snapshot_pairs(skeys: torch.Tensor):
    """(s_sorted, d_sorted) int32 of a ``_sort_overflow_impl`` snapshot:
    the reference's lexsorted pair of arrays."""
    return ((skeys >> 32).to(torch.int32),
            (skeys & 0xFFFFFFFF).to(torch.int32))


def _insert_wave_impl(ell, osrc, odst, skeys, a, b):
    """Insert b[s, i] into row a[s, i] (rows unique within each slot's
    wave), spilling row-full entries to distinct free overflow slots, in
    place.  ``skeys`` is the batch's overflow presence snapshot
    (``_sort_overflow_impl``).  Returns (ell, osrc, odst, fail (S,) bool):
    fail = some spill of that slot found no free slot."""
    S, n_pad, W = ell.shape
    ncap = osrc.shape[1]
    k = a.shape[1]
    device = ell.device
    valid = (a >= 0) & (b >= 0)
    rows, pos, asafe = _rows_at(ell, a)
    # presence = ELL row ∪ overflow buffer: without the overflow side an
    # upsert-style stream re-inserting an overflow-resident edge would
    # append a duplicate slot per batch and grow the buffer without bound
    present = ((rows == b[..., None]).any(dim=2)
               | _member(_key(a, b), skeys))
    isfill = rows == int(FILL)
    slot = isfill.to(torch.uint8).argmax(dim=2)   # first free slot (or 0)
    free = isfill.gather(2, slot[..., None])[..., 0]
    do_ell = valid & ~present & free
    _set_at(ell.view(-1), pos.gather(2, slot[..., None])[..., 0], b,
            do_ell)
    # spills: j-th spilling entry takes the j-th free overflow slot
    spill = valid & ~present & ~free
    freeslots = _first_free(osrc == int(FILL), k, ncap)
    rank = spill.cumsum(1) - 1
    oidx = torch.where(spill, freeslots.gather(1, rank.clamp(0, k - 1)),
                       ncap)
    land = oidx < ncap
    opos = (torch.arange(S, device=device)[:, None] * ncap
            + oidx.clamp(max=max(ncap - 1, 0)))
    if ncap:
        _set_at(osrc.view(-1), opos, a, land)
        _set_at(odst.view(-1), opos, b, land)
    fail = (spill & ~land).any(dim=1)
    return ell, osrc, odst, fail


# --------------------------------------------------------------------------
# host orchestration
# --------------------------------------------------------------------------

def _pad_pairs_np(pairs: np.ndarray, cap: int) -> np.ndarray:
    out = np.full((cap, 2), FILL, dtype=np.int32)
    out[:len(pairs)] = pairs
    return out


def _dedup_pairs(p: np.ndarray) -> np.ndarray:
    """Unique rows of a non-negative (k, 2) int32 array, lexicographically
    sorted — ``np.unique(p, axis=0)`` on a fused int64 key (axis-0 unique
    goes through a void view and is ~10x slower)."""
    key = (p[:, 0].astype(np.int64) << 32) | p[:, 1].astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return p[idx]


def empty_wave(cap: int) -> np.ndarray:
    """An all-FILL (cap, 2) wave — a no-op through every wave body (used
    to pad shorter tenants inside a megabatch)."""
    return np.full((cap, 2), FILL, dtype=np.int32)


def _waves(pairs: np.ndarray, cap: int):
    """Split directed (k, 2) pairs into FILL-padded (cap, 2) waves whose
    first columns (target rows) are unique within each wave."""
    if len(pairs) == 0:
        return
    a = pairs[:, 0]
    order = np.argsort(a, kind="stable")
    sa = a[order]
    first = np.concatenate([[True], sa[1:] != sa[:-1]])
    group_start = np.maximum.accumulate(
        np.where(first, np.arange(len(sa)), 0))
    rank = np.arange(len(sa)) - group_start       # occurrence # within row
    for w in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = order[rank == w]
        for lo in range(0, len(sel), cap):
            yield _pad_pairs_np(pairs[sel[lo:lo + cap]], cap)


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """Host-side wave plan of one update batch (relabeled-space ids).

    The SAME plan drives the per-tenant ``apply_updates`` loop and the
    megabatched dispatch, which is what makes the two paths bit-identical
    by construction.  All waves are FILL-padded ``(delta_cap, 2)`` int32.
    """

    ovf_del: tuple    # overflow-delete chunks (undirected pairs)
    ell_del: tuple    # ELL delete waves (directed, unique rows per wave)
    ins: tuple        # insert waves (directed, unique rows per wave)
    touched: np.ndarray             # (n_pad,) bool repair seed mask

    @property
    def n_ops(self) -> int:
        return len(self.ovf_del) + len(self.ell_del) + len(self.ins)


def plan_updates(ins: np.ndarray, dels: np.ndarray, delta_cap: int,
                 n_pad: int) -> UpdatePlan:
    """Plan a delete-then-insert batch into fixed-shape device waves."""
    ins = np.asarray(ins, dtype=np.int32).reshape(-1, 2)
    dels = np.asarray(dels, dtype=np.int32).reshape(-1, 2)

    ovf_del = []
    ell_del = []
    if len(dels):
        for lo in range(0, len(dels), delta_cap):
            ovf_del.append(_pad_pairs_np(dels[lo:lo + delta_cap], delta_cap))
        dd = np.concatenate([dels, dels[:, ::-1]])
        dd = _dedup_pairs(dd)                     # idempotent clears
        ell_del.extend(_waves(dd, delta_cap))

    ins_waves = []
    if len(ins):
        ii = np.concatenate([ins, ins[:, ::-1]])
        ii = ii[ii[:, 0] != ii[:, 1]]             # drop self-loops
        # dedup directed pairs: besides shaving waves, this is what lets the
        # overflow presence snapshot be taken ONCE per batch
        ii = _dedup_pairs(ii)
        ins_waves.extend(_waves(ii, delta_cap))

    touched = np.zeros((n_pad,), bool)
    for e in (ins, dels):
        if len(e):
            touched[e.ravel()] = True
    return UpdatePlan(ovf_del=tuple(ovf_del), ell_del=tuple(ell_del),
                      ins=tuple(ins_waves), touched=touched)


def _rank_waves_group(pairs: np.ndarray, slots: np.ndarray, n_slots: int,
                      cap: int) -> np.ndarray:
    """Fused-across-slots equivalent of ``_dedup_pairs`` + ``_waves``:
    directed ``pairs`` tagged with ``slots`` ids come out as ONE
    ``(n_waves, n_slots, cap, 2)`` FILL-padded tensor whose slice
    ``[:, b]`` is bit-identical to ``_waves(_dedup_pairs(pairs of b), cap)``
    — same dedup order (lex by (a, b)), same occurrence-rank partition,
    same over-``cap`` chunk splitting.
    """
    if len(pairs) == 0:
        return np.zeros((0, n_slots, cap, 2), np.int32)
    # dedup per slot + lex sort by (slot, a, b) on one fused int64 key
    q = ((slots.astype(np.int64) << 48)
         | (pairs[:, 0].astype(np.int64) << 24)
         | pairs[:, 1].astype(np.int64))
    uq = sorted_unique(q)          # np.unique(q): see core/partition.py
    s = (uq >> 48).astype(np.int64)
    a = ((uq >> 24) & 0xFFFFFF).astype(np.int32)
    b = (uq & 0xFFFFFF).astype(np.int32)
    m = len(uq)
    idx = np.arange(m)

    def group_pos(key):
        first = np.empty(m, bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        start = np.maximum.accumulate(np.where(first, idx, 0))
        return first, idx - start

    # rank = occurrence # of row a within its slot
    _, rank = group_pos(uq >> 24)
    # group by (slot, rank) with a stable sort, keeping the (a, b) order
    srk = (s << 24) | rank
    order = np.argsort(srk, kind="stable")
    s, a, b, srk = s[order], a[order], b[order], srk[order]
    g_first, pos = group_pos(srk)
    # wave ordinal: ranks in order, each rank's chunks sequentially
    gidx = np.cumsum(g_first) - 1                  # entry -> group index
    sizes = np.bincount(gidx)
    nch = -(sizes // -cap)                         # chunks per group
    cum = np.cumsum(nch) - nch                     # global chunk prefix
    group_slot = s[g_first]
    g_range = np.arange(len(sizes))
    slot_first = np.empty(len(sizes), bool)
    slot_first[0] = True
    np.not_equal(group_slot[1:], group_slot[:-1], out=slot_first[1:])
    slot_base = cum[np.maximum.accumulate(np.where(slot_first, g_range, 0))]
    wave = (cum - slot_base)[gidx] + pos // cap

    n_waves = int(wave.max()) + 1
    out = np.full((n_waves, n_slots, cap, 2), FILL, np.int32)
    out[wave, s, pos % cap, 0] = a
    out[wave, s, pos % cap, 1] = b
    return out


def plan_group(batches, delta_cap: int, n_pad: int, directed: bool = False):
    """Vectorized ``plan_updates`` over a whole slot class for ONE batch
    round.  ``batches[b]`` is slot b's relabeled ``(ins, dels)`` pair of
    (k, 2) int32 arrays (empty arrays for a no-op slot).  Returns numpy
    ``(ovf_w, ell_w, ins_w, touched)`` — three ``(n_waves, n_slots,
    delta_cap, 2)`` wave tensors and a ``(n_slots, n_pad)`` bool repair
    seed mask — where every slot's slices are bit-identical to its own
    ``plan_updates`` waves.  ``directed=True`` takes each pair as an
    already-directed (row, target) mutation and skips the reversal.
    """
    n_slots = len(batches)
    touched = np.zeros((n_slots, n_pad), bool)
    for bi, (ins, dels) in enumerate(batches):
        for e in (ins, dels):
            if len(e):
                touched[bi, np.ravel(e)] = True

    # overflow deletes: raw undirected pairs chunked per slot
    n_ovf = max((-(len(d) // -delta_cap)) for _, d in batches)
    ovf_w = np.full((n_ovf, n_slots, delta_cap, 2), FILL, np.int32)
    for bi, (_, dels) in enumerate(batches):
        for j in range(0, len(dels), delta_cap):
            ovf_w[j // delta_cap, bi, :len(dels[j:j + delta_cap])] = \
                dels[j:j + delta_cap]

    def fused(kind):
        ps, ss = [], []
        for bi, (ins, dels) in enumerate(batches):
            e = ins if kind == "ins" else dels
            if not len(e):
                continue
            d = np.asarray(e) if directed else np.concatenate([e, e[:, ::-1]])
            if kind == "ins":
                d = d[d[:, 0] != d[:, 1]]          # drop self-loops
            ps.append(d)
            ss.append(np.full((len(d),), bi, np.int64))
        if not ps:
            return np.zeros((0, n_slots, delta_cap, 2), np.int32)
        return _rank_waves_group(np.concatenate(ps), np.concatenate(ss),
                                 n_slots, delta_cap)

    return ovf_w, fused("dels"), fused("ins"), touched


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device)


def apply_updates(ell, osrc, odst, ins: np.ndarray, dels: np.ndarray,
                  delta_cap: int, max_grows=None):
    """Apply (k, 2) delete-then-insert batches (relabeled-space host arrays)
    to one tenant's ``ell`` (n_pad, W) and overflow buffers.

    Returns (ell, osrc, odst, touched, n_grows): ``touched`` is an (n_pad,)
    bool device mask of the endpoints of every update (the repair seed set),
    ``n_grows`` counts overflow-buffer doublings performed.  The inputs are
    never written: a tensor the batch changes is copied once, before the
    first write, and a tensor it leaves alone is returned as it is.
    ``max_grows`` bounds the doublings per batch (None: unbounded);
    exhaustion raises ``OvfGrowthExhausted``, which the degradation ladder
    (DESIGN.md §14) catches.
    """
    if faults.fires("ovf.exhaust"):
        raise OvfGrowthExhausted(grows=0, budget=max_grows,
                                 cap=int(osrc.shape[0]), forced=True)
    plan = plan_updates(ins, dels, delta_cap, ell.shape[0])
    device = ell.device
    # copy-on-write, once per batch
    if plan.ovf_del or plan.ins:
        osrc, odst = osrc.clone(), odst.clone()
    if plan.ell_del or plan.ins:
        ell = ell.clone()
    e, s_, d_ = ell[None], osrc[None], odst[None]
    for wave in plan.ovf_del:
        _delete_overflow_impl(s_, d_, _dev(wave, device)[None])
    for wave in plan.ell_del:
        w = _dev(wave, device)[None]
        _delete_ell_wave_impl(e, w[..., 0], w[..., 1])
    grows = 0
    if plan.ins:
        skeys = _sort_overflow_impl(s_, d_)        # once per batch
    for wave in plan.ins:
        w = _dev(wave, device)[None]
        while True:
            fail = _insert_wave_impl(e, s_, d_, skeys, w[..., 0],
                                     w[..., 1])[3]
            if not bool(fail[0]):
                break
            # overflow full: grow and re-apply the wave (idempotent).  The
            # wave's ELL writes and partial spills stay; the grown buffer
            # holds the spills, so the snapshot is retaken — re-applying
            # against the stale one would duplicate the entries that landed
            if max_grows is not None and grows >= max_grows:
                raise OvfGrowthExhausted(grows=grows, budget=max_grows,
                                         cap=int(s_.shape[1]))
            osrc, odst = grow_overflow(s_[0], d_[0])
            s_, d_ = osrc[None], odst[None]
            grows += 1
            skeys = _sort_overflow_impl(s_, d_)
    touched = torch.from_numpy(plan.touched).to(device)
    return e[0], s_[0], d_[0], touched, grows


def _apply_waves_stacked(ell_b, osrc_b, odst_b, ovf_w, ell_w, ins_w):
    """Apply one batch round's stacked waves to a slot class, **in place**:
    each of ``ovf_w`` / ``ell_w`` / ``ins_w`` (J, S, delta_cap, 2) int32 on
    the slots' device holds wave j of every slot (shorter slots ride on
    all-FILL no-op waves), and each wave is ONE call of its body for the
    whole slot class.  There is no grow-and-retry: a slot whose insert
    spill finds the overflow buffer full raises its flag in the returned
    ``fail`` (S,) bool device tensor, and its tensors are garbage."""
    fail = torch.zeros((ell_b.shape[0],), dtype=torch.bool,
                       device=ell_b.device)
    for w in ovf_w:
        _delete_overflow_impl(osrc_b, odst_b, w)
    for w in ell_w:
        _delete_ell_wave_impl(ell_b, w[..., 0], w[..., 1])
    if len(ins_w):
        skeys = _sort_overflow_impl(osrc_b, odst_b)    # once per batch
        for w in ins_w:
            fail |= _insert_wave_impl(ell_b, osrc_b, odst_b, skeys,
                                      w[..., 0], w[..., 1])[3]
    return fail


def apply_updates_mega(ell_b, osrc_b, odst_b, plans, delta_cap: int):
    """Apply one ``UpdatePlan`` per slot in lockstep (DESIGN.md §13):
    ``_apply_waves_stacked`` on the plans' waves stacked per wave index.

    ``ell_b``/``osrc_b``/``odst_b`` carry a leading slot axis; ``plans`` is
    one plan per slot.  A slot whose insert wave finds the overflow buffer
    full raises its ``fail`` flag and the caller escapes that slot to the
    per-tenant path.  The inputs are copied first, as in ``apply_updates``.

    Returns (ell_b, osrc_b, odst_b, fail) with ``fail`` a host bool array.
    """
    ell_b, osrc_b, odst_b = ell_b.clone(), osrc_b.clone(), odst_b.clone()

    def stacked(kind: str):
        waves = [getattr(p, kind) for p in plans]
        out = np.full((max(map(len, waves)), len(plans), delta_cap, 2),
                      FILL, np.int32)
        for b, ws in enumerate(waves):
            for j, w in enumerate(ws):
                out[j, b] = w
        return _dev(out, ell_b.device)

    fail = _apply_waves_stacked(ell_b, osrc_b, odst_b, stacked("ovf_del"),
                                stacked("ell_del"), stacked("ins"))
    return ell_b, osrc_b, odst_b, fail.cpu().numpy()


def grow_overflow(osrc, odst, factor: int = 2):
    """Double the overflow buffer (FILL-padded): new tensors."""
    cap = osrc.shape[0]
    extra = torch.full((max(cap, 8) * (factor - 1),), int(FILL),
                       dtype=torch.int32, device=osrc.device)
    return torch.cat([osrc, extra]), torch.cat([odst, extra])


def overflow_load(osrc) -> int:
    """Live (non-FILL) overflow slots."""
    return int((osrc >= 0).sum())


def state_to_csr(state) -> CSRGraph:
    """Decode a dynamic coloring state back to a host CSRGraph (original
    ids).  Sharded states carry their own slot-space decoder (``to_csr``,
    dynamic/sharded.py) — duck-typed here so every state consumer (service
    verification, the degradation ladder's ``updated_graph``) stays
    engine-agnostic."""
    if hasattr(state, "to_csr"):
        return state.to_csr()

    def host(t):
        return t.detach().cpu().numpy()

    edges = ell_to_edges(host(state.ell), state.n, host(state.ovf_src),
                         host(state.ovf_dst))
    return from_edges(state.n, state.inv_perm[edges], symmetrize=False)
