"""The work of each kernel, in one place, and the hooks a cost counter
listens on.

Each function here says what one call of a kernel must do at the least: the
FLOPs it must compute and the bytes it must move, each input read once and
each output written once.  ``chip_smoke.py``'s phase 6 prints its bounds
from them, and the dry run (``launch/cost.py``) bills a kernel call with
them: on a meta tensor a wrapper computes nothing and records its work
here; on a CUDA tensor it records the same while a counter is open.

  B5 ``attention_work``   the larger-of rule: 4 * Hq * D FLOPs a visible
                          (query, key) pair, q / k / v / out moved once
  B4 ``ell_spmm_bytes``   the table, each distinct live feature row once,
                          the output
  B1-B3 ``*_bytes``       ``gather_bytes`` (the ELL rows, colours and
                          priorities the pass reads, each once) plus the
                          per-row flags, forb0 words and outputs

B1-B4's bytes depend on the data (which slots are live, which rows work).
A meta tensor has none, so there the wrappers record the most a call could
move (every slot live, every row working): ``*_bytes_bound``.

The hooks: a counter pushes itself with ``listen`` and receives
``kernel(name, flops, nbytes)`` and, from ``core/mesh.py``'s collectives,
``collective(...)``.  With no counter open each hook is one list check.
"""
from __future__ import annotations

import contextlib

import torch

_LISTENERS: list = []


@contextlib.contextmanager
def listen(counter):
    """Within the scope ``counter`` receives every kernel's work and every
    collective."""
    _LISTENERS.append(counter)
    try:
        yield counter
    finally:
        _LISTENERS.remove(counter)


def listening() -> bool:
    return bool(_LISTENERS)


def on_card(t: torch.Tensor) -> bool:
    """True for a tensor that takes the card's routes: a CUDA tensor, and a
    meta tensor (the dry run's, which a caller asks for: it costs the
    card's route and computes nothing).  A CPU tensor takes the plain
    versions."""
    return t.device.type in ("cuda", "meta")


def record_kernel(name: str, flops: float, nbytes: float,
                  inputs=()) -> None:
    """One call of kernel ``name`` on ``inputs`` doing ``flops`` and moving
    ``nbytes``."""
    for c in _LISTENERS:
        c.kernel(name, float(flops), float(nbytes), inputs)


def stacked(t: torch.Tensor, positions) -> None:
    """``t`` stacks the payloads of mesh ``positions`` (a collective's
    gather): while a counter listens, the gradient of ``t`` is reported in
    the backward, so its row j is billed to ``positions[j]``."""
    if _LISTENERS and t.requires_grad:
        t.register_hook(lambda g: _stack_grad(g, tuple(positions)))


def _stack_grad(g: torch.Tensor, positions: tuple):
    if g.stride(0) == 0:          # a sum's backward: one row, expanded
        g = g.contiguous()
    for c in _LISTENERS:
        c.stack_grad(g, positions)
    return g


@contextlib.contextmanager
def collective(kind: str, groups, payload_bytes: list, result_bytes: list):
    """One collective of ``kind`` ("all-gather", "all-reduce",
    "reduce-scatter") over ``groups`` (tuples of mesh positions):
    ``payload_bytes[i]`` / ``result_bytes[i]`` are position i's operand and
    result.  The ops run inside the scope are the collective's own (a
    stack, a sum): a counter bills them as the collective, not as ops."""
    for c in _LISTENERS:
        c.collective_begin(kind, groups, payload_bytes, result_bytes)
    try:
        yield
    finally:
        for c in _LISTENERS:
            c.collective_end()


# --------------------------------------------------------------------------
# B5: attention
# --------------------------------------------------------------------------

def attention_pairs(Lq: int, Lk: int, causal: bool) -> int:
    """(query, key) pairs a head computes: with ``causal``, query r sees the
    keys <= r + (Lk - Lq) (Lk >= Lq, so every row sees r + Lk - Lq + 1)."""
    if not causal:
        return Lq * Lk
    return Lq * (Lk - Lq + 1) + Lq * (Lq - 1) // 2


def attention_work(B: int, Hq: int, Hkv: int, Lq: int, Lk: int, D: int,
                   causal: bool, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one forward attention: 4 * Hq * D FLOPs a visible
    pair (QK^T and PV, a multiply and an add each) and q, k, v, out moved
    once."""
    flops = 4 * B * Hq * D * attention_pairs(Lq, Lk, causal)
    nbytes = (2 * B * Hq * Lq * D + 2 * B * Hkv * Lk * D) * itemsize
    return flops, nbytes


# --------------------------------------------------------------------------
# B4: ELL aggregation
# --------------------------------------------------------------------------

def ell_spmm_bytes(R: int, W: int, distinct: int, d: int,
                   itemsize: int) -> int:
    """The table (int32), each distinct live feature row once, the (R, d)
    output."""
    return R * W * 4 + distinct * d * itemsize + R * d * itemsize


# --------------------------------------------------------------------------
# B1-B3: the coloring passes
# --------------------------------------------------------------------------

def gather_bytes(ell_k, colors, vids, work, test, *, own: bool, ell=None):
    """The gathered part of the bytes a pass must move, each input read
    once, counted on this call's data.  ``vids`` (R,) are the rows' vertex
    ids, ``work`` the rows that can work, ``test`` the rows whose defect
    test reads priorities (in U, unforced, coloured).  Counted:

      * the ELL row of each working row, W*4 B;
      * with ``ell`` (the full table: a two-hop pass), the row of each
        distinct live hop-1 neighbour of a working row, once, W*4 B;
      * 4 B of colour per distinct vertex in a live slot of a working row
        (either hop; the row itself is no hop-2 slot), and of every row
        itself where ``own`` (its colour is its output when it keeps it);
      * 4 B of priority per distinct vertex that is a tested row or sits in
        a live slot of a tested row with the row's colour: the defect test
        reads no other.

    Returns (bytes, live slots of the working rows)."""
    n = colors.shape[0]
    W = ell_k.shape[1]
    need_row = torch.zeros(n, dtype=torch.bool, device=colors.device)
    need_col = torch.zeros_like(need_row)
    need_pri = torch.zeros_like(need_row)
    if own:
        need_col[vids.long()] = True
    need_pri[vids[test].long()] = True
    rows = torch.nonzero(work)[:, 0]
    live = 0
    step = max(1, 2 ** 24 // (W * (W if ell is not None else 1)))
    for s in range(0, rows.numel(), step):
        r = rows[s:s + step]
        v = vids[r].long()
        c_v, t = colors[v][:, None], test[r][:, None]
        e = ell_k[r].long()
        ok = e >= 0
        e = e.clamp(0, n - 1)
        slots = [(e, ok)]
        if ell is not None:
            need_row[e[ok]] = True
            e2 = ell[e].long()                                # (b, W, W)
            ok2 = ok[:, :, None] & (e2 >= 0) & (e2 != v[:, None, None])
            slots.append((e2.clamp(0, n - 1).reshape(len(r), -1),
                          ok2.reshape(len(r), -1)))
        for ids, ok_s in slots:
            live += int(ok_s.sum())
            need_col[ids[ok_s]] = True
            need_pri[ids[ok_s & t & (colors[ids] == c_v)]] = True
    nbytes = (int(work.sum()) * W * 4 + int(need_row.sum()) * W * 4
              + 4 * int(need_col.sum()) + 4 * int(need_pri.sum()))
    return nbytes, live


def firstfit_bytes(gathered: int, R: int, nW: int, forb0: bool) -> int:
    """B1: the gathered bytes (``gather_bytes`` with ``own=False``), the
    forb0 words where given, 5 B of outputs a row (mex and ovf)."""
    return gathered + (R * nW * 4 if forb0 else 0) + R * 5


def detect_recolor_bytes(gathered: int, R: int, may: int, nW: int,
                         has_ovf: bool) -> int:
    """B2: the gathered bytes (``own=True``), 3 B of per-row flags (U,
    force, valid) and ``extra_defect``'s where there is an overflow, the
    forb0 words of the ``may`` rows that can work, 6 B of outputs a row."""
    return (gathered + R * (3 + (1 if has_ovf else 0))
            + (may * nW * 4 if has_ovf else 0) + R * 6)


def twohop_bytes(gathered: int, R: int) -> int:
    """B3: the gathered bytes (``own=True`` with the full table), 3 B of
    per-row flags and 6 B of outputs a row."""
    return gathered + R * (3 + 6)


def gather_bytes_bound(R: int, W: int, n: int, own: bool,
                       two_hop: bool = False) -> int:
    """The most ``gather_bytes`` can count for R working rows of width W
    over n vertices: every slot live, every slot's vertex distinct (up to
    n), every priority read."""
    slots = R * W * (1 + (W if two_hop else 0))
    rows = R * W + (min(n, R * W) * W if two_hop else 0)
    cols = min(n, slots + (R if own else 0))
    return rows * 4 + 4 * cols + 4 * min(n, slots + R)

