"""Megabatched multi-tenant stepping (DESIGN.md §13; the port of the
reference's ``dynamic/megabatch.py``).

``ColoringService.step`` looping tenants in Python dispatches one delta
apply + repair per graph per batch — per-dispatch host overhead multiplied
by the tenant count.  This module stacks same-shape tenants into a leading
*slot* axis so one call of each wave body applies wave j of every tenant's
update plan and one launch of ``detect_recolor``'s slot-stride form per
chunk repairs every tenant's coloring (``core/frontier._repair_mega_loop``).

Slot classes
------------
Two tenants can share a batch only if every shape / static parameter of the
stepping code matches: ``slot_key`` collects them.  The service buckets
tenants by this key; the stacked batch is padded to a power-of-two capacity
(duplicating slot 0 with no-op plans), as the reference pads it.

Escape-to-retry
---------------
The per-tenant path has two data-dependent escapes the batched loop does
not take: the full-width fallback when a frontier overflows
``frontier_cap`` and the ``_run_with_retry`` color-cap doubling.  The
batched code instead raises per-slot ``fail``/``escape`` flags; the host
discards that slot's outputs, rebuilds its pre-chunk state from the
previous chunk's stacked tensors, and redoes the batches through plain
``recolor_incremental`` (through the ladder) — the exact code the
per-tenant loop runs, so escaped tenants are bit-identical by construction.
Non-escaped slots are bit-identical too: the same ``UpdatePlan`` drives both
paths and a finished slot is frozen, so each slot sees the exact scalar pass
sequence.

Deferred commit
---------------
Stacked tensors are carried across batch rounds; per-tenant slices (views)
are taken once at the end, not per round.  Each chunk of rounds works on
copies of the stacked tensors (the pre-chunk ones are the escape path's
source), so no tensor a state holds is written.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import frontier
from repro_torch.core.context import PassContext
from repro_torch.dynamic import delta
from repro_torch.dynamic import incremental as inc
from repro_torch.dynamic.incremental import DynamicColoringState
from repro_torch.resilience import ladder


def slot_key(state: DynamicColoringState) -> tuple:
    """Every shape / static parameter of the stepping code.

    Tenants agreeing on this key stack into one batch: tensor shapes
    (n_pad, W, ovf_cap, frontier/delta caps), the ``PassContext`` statics
    (n, C, n_chunks, forbidden_impl), and the repair-round bound.  (The
    device is not in the key: a service keeps its tenants on one.)
    """
    return (state.n, state.n_pad, int(state.ell.shape[1]),
            int(state.ovf_src.shape[0]), state.C, state.n_chunks,
            state.frontier_cap, state.delta_cap, state.forbidden_impl,
            state.max_rounds)


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


# bound on how many batch rounds one fused step spans: the host holds a
# pre-CHUNK snapshot for escape redos, so an escape replays at most this
# many batches per-tenant
FUSE_ROUNDS = 8


def _mega_step(ell_b, osrc_b, odst_b, pri_b, colors_b, U_r,
               ovf_r, ell_r, ins_r, ctx, cap, max_rounds):
    """Advance a whole slot class by a CHUNK of batch rounds: for each
    round, every delete/insert wave of every slot (one wave-body call for
    all slots), then the megabatched repair loop.  **Writes ``ell_b``,
    ``osrc_b`` and ``odst_b`` in place** (the caller passes copies).

    A slot that escapes (an insert spill finds the overflow buffer full, or
    a repair escape — see ``frontier._mega_compact_repair``) is dead for
    the rest of the chunk: its repair is frozen via ``esc0``, its tensors
    keep flowing through later wave bodies as garbage, and the host
    discards them.  Returns ``(ell, osrc, odst, colors, fail[r], rounds[r],
    defects[r], esc[r])``, the last four host arrays with per-round leading
    dims; ``esc`` is cumulative (a dead slot stays flagged), ``fail`` is
    per-round."""
    n_slots = ell_b.shape[0]
    dead = np.zeros((n_slots,), bool)
    fails, rs, tots, escs = [], [], [], []
    for r in range(U_r.shape[0]):
        fail_h = delta._apply_waves_stacked(
            ell_b, osrc_b, odst_b, ovf_r[r], ell_r[r], ins_r[r]).cpu().numpy()
        colors_b, r_b, tot_b, esc_b = frontier._repair_mega_loop(
            ell_b, osrc_b, odst_b, pri_b, colors_b, U_r[r], dead | fail_h,
            ctx, cap, max_rounds)
        dead = dead | fail_h | esc_b
        fails.append(fail_h)
        rs.append(r_b)
        tots.append(tot_b)
        escs.append(dead)
    return (ell_b, osrc_b, odst_b, colors_b, np.stack(fails),
            np.stack(rs), np.stack(tots), np.stack(escs))


def _stack_rounds(tensors, cap: int, device):
    """Stack per-round ``(J_r, n_slots, cap, 2)`` wave tensors (one wave
    kind, one chunk of batch rounds) into a ``(n_rounds, J, n_slots, cap,
    2)`` chunk tensor on ``device``; shorter rounds ride on all-FILL no-op
    waves.  The shared wave count J is padded up to a power of two, as the
    reference pads it (there, to keep the compiled shapes few)."""
    R = len(tensors)
    _, n_slots, _, _ = tensors[0].shape
    n = max(t.shape[0] for t in tensors)
    n = _pow2(n) if n else 0
    out = np.empty((R, n, n_slots, cap, 2), np.int32)
    out[...] = delta.empty_wave(cap)          # broadcast-fill the padding
    for r, t in enumerate(tensors):
        out[r, :t.shape[0]] = t
    return torch.from_numpy(out).to(device)


def step_group(states: Sequence[DynamicColoringState],
               queues: Sequence[Sequence[Tuple]],
               capacity: int = None,
               ) -> Tuple[List[DynamicColoringState], List[dict]]:
    """Drain every tenant's update-batch queue with megabatched steps.

    ``states`` must share one ``slot_key`` (and one device); ``queues[i]``
    is tenant i's list of ``(inserts, deletes)`` batches in original vertex
    ids, applied in order.  The queues are drained in chunks of up to
    ``FUSE_ROUNDS`` batch rounds, ONE ``_mega_step`` per chunk: round r of a
    chunk applies the r-th batch of every tenant that has one and repairs
    every coloring.  Slots that raise an escape flag anywhere in a chunk
    (overflow-buffer full, frontier past cap, color cap exceeded) replay
    that chunk's batches through ``recolor_incremental`` from their
    pre-chunk state; if the replay changed the tenant's shapes (grown
    buffer, doubled C) it leaves the batch and drains the rest of its queue
    per-tenant ("solo").

    Returns ``(new_states, outcomes)`` — ``outcomes[i]`` counts the path
    each non-empty batch took: ``{"batched": .., "escaped": .., "solo": ..}``
    (an escape charges every batch of its tenant's chunk to "escaped").
    Empty batches are skipped without a version bump, matching
    ``recolor_incremental``.
    """
    if len(states) != len(queues):
        raise ValueError("one queue per state required")
    k = len(states)
    outcomes = [{"batched": 0, "escaped": 0, "solo": 0} for _ in range(k)]
    if k == 0:
        return [], outcomes
    key = slot_key(states[0])
    for st in states[1:]:
        if slot_key(st) != key:
            raise ValueError("step_group requires a single slot class; "
                             f"got {slot_key(st)} vs {key}")
        if st.device != states[0].device:
            raise ValueError("step_group requires one device; got "
                             f"{st.device} vs {states[0].device}")
    st0 = states[0]
    device = st0.device
    n_pad, delta_cap = st0.n_pad, st0.delta_cap
    ctx = PassContext(n=st0.n, n_pad=st0.n_pad, C=st0.C,
                      n_chunks=st0.n_chunks,
                      forbidden_impl=st0.forbidden_impl)

    # validate + relabel host-side up front: a malformed batch must raise
    # before any tenant's tensors are touched.  Wave planning happens per
    # chunk round through ``delta.plan_group`` — ONE fused-key pass for the
    # whole slot class instead of a sort per tenant.
    rel_q: List[list] = []     # per tenant: relabeled (ins, dels) | None
    raw_q: List[list] = []     # per tenant: validated original-id pairs
    for st, q in zip(states, queues):
        rels, raws = [], []
        for ins, dels in q:
            ins = inc._check_edges(ins if ins is not None else [],
                                   st.n, "inserts")
            dels = inc._check_edges(dels if dels is not None else [],
                                    st.n, "deletes")
            if len(ins) == 0 and len(dels) == 0:
                rels.append(None)
                raws.append(None)
                continue
            rels.append((st.perm[ins] if len(ins) else ins,
                         st.perm[dels] if len(dels) else dels))
            raws.append((ins, dels))
        rel_q.append(rels)
        raw_q.append(raws)

    n_batch_rounds = max(len(q) for q in rel_q)
    cap_slots = capacity if capacity is not None else _pow2(k)
    if cap_slots < k:
        raise ValueError(f"capacity {cap_slots} < group size {k}")
    pad_idx = list(range(k)) + [0] * (cap_slots - k)
    ell_b = torch.stack([states[i].ell for i in pad_idx])
    osrc_b = torch.stack([states[i].ovf_src for i in pad_idx])
    odst_b = torch.stack([states[i].ovf_dst for i in pad_idx])
    colors_b = torch.stack([states[i].colors_dev for i in pad_idx])
    pri_b = torch.stack([states[i].pri for i in pad_idx])

    cur = list(states)
    # dirty[i]: cur[i]'s tensor fields are stale — its latest tensors live
    # in the stacked batch and are sliced out at final commit
    dirty = [False] * k
    solo = [False] * k
    empty = (np.zeros((0, 2), np.int32),      # no-op slot for plan_group
             np.zeros((0, 2), np.int32))

    # scalar bookkeeping (version bumps, pass counters) is deferred like the
    # tensors: batched rounds only accumulate here and fold into cur[i] once
    # — at final commit, or on escape (the redo path needs the state)
    pend_ver = [0] * k
    pend_last = [(0, 0)] * k     # (last_rounds, last_conflicts) of latest
    pend_passes = [0] * k

    def _fold(i):
        if pend_ver[i]:
            st = cur[i]
            lr, lc = pend_last[i]
            cur[i] = dataclasses.replace(
                st, version=st.version + pend_ver[i], last_rounds=lr,
                last_conflicts=lc, last_gather_passes=lr,
                total_gather_passes=st.total_gather_passes + pend_passes[i])
            pend_ver[i] = 0
            pend_passes[i] = 0

    for lo in range(0, n_batch_rounds, FUSE_ROUNDS):
        chunk = range(lo, min(lo + FUSE_ROUNDS, n_batch_rounds))
        for i in range(k):          # solo tenants drain per-tenant
            if solo[i]:
                for rnd in chunk:
                    if rnd < len(rel_q[i]) \
                            and rel_q[i][rnd] is not None:
                        ins, dels = raw_q[i][rnd]
                        cur[i], _ = ladder.apply_with_ladder(cur[i], ins,
                                                             dels)
                        outcomes[i]["solo"] += 1
        act = [set(i for i in range(k)
                   if not solo[i] and rnd < len(rel_q[i])
                   and rel_q[i][rnd] is not None)
               for rnd in chunk]
        if not any(act):
            continue
        rounds = [delta.plan_group(
            [rel_q[j][rnd] if (j < k and j in a) else empty
             for j in pad_idx], delta_cap, n_pad)
            for rnd, a in zip(chunk, act)]

        prev = (ell_b, osrc_b, odst_b, colors_b)
        U_r = torch.from_numpy(np.stack([t[3] for t in rounds])).to(device)
        ell_b, osrc_b, odst_b, colors_b, fail_r, r_h, tot_h, esc_r = \
            _mega_step(ell_b.clone(), osrc_b.clone(), odst_b.clone(), pri_b,
                       colors_b, U_r,
                       _stack_rounds([t[0] for t in rounds], delta_cap,
                                     device),
                       _stack_rounds([t[1] for t in rounds], delta_cap,
                                     device),
                       _stack_rounds([t[2] for t in rounds], delta_cap,
                                     device),
                       ctx, st0.frontier_cap, st0.max_rounds)
        esc = fail_r | esc_r                # (rounds, slots)

        for i in range(k):
            mine = [ri for ri, a in enumerate(act) if i in a]
            if not mine:
                continue
            if not esc[mine, i].any():
                for ri in mine:
                    passes = int(r_h[ri, i])
                    pend_ver[i] += 1
                    pend_last[i] = (passes, int(tot_h[ri, i]))
                    pend_passes[i] += passes
                    outcomes[i]["batched"] += 1
                dirty[i] = True
                continue
            # escaped somewhere in the chunk: this slot's stacked tensors
            # are garbage by contract.  Rebuild its pre-chunk state and
            # replay the chunk's batches through the per-tenant retry path
            # (bit-identical by construction — it IS the reference path).
            _fold(i)
            st = cur[i]
            if dirty[i]:
                st = dataclasses.replace(
                    st, ell=prev[0][i], ovf_src=prev[1][i],
                    ovf_dst=prev[2][i], colors_dev=prev[3][i])
            for ri in mine:
                ins, dels = raw_q[i][chunk[ri]]
                st, _ = ladder.apply_with_ladder(st, ins, dels)
                outcomes[i]["escaped"] += 1
            cur[i] = st
            if slot_key(st) == key:
                # shapes survived: write back and stay in the batch (these
                # stacked tensors are this chunk's own copies)
                ell_b[i] = st.ell
                osrc_b[i] = st.ovf_src
                odst_b[i] = st.ovf_dst
                colors_b[i] = st.colors_dev
                dirty[i] = False
            else:
                # grown buffer / doubled C: can no longer ride this class
                dirty[i] = False
                solo[i] = True

    # deferred commit: one slice (a view) + one replace per dirty tenant
    for i in range(k):
        _fold(i)
        if dirty[i]:
            cur[i] = dataclasses.replace(
                cur[i], ell=ell_b[i], ovf_src=osrc_b[i], ovf_dst=odst_b[i],
                colors_dev=colors_b[i])
    return cur, outcomes
