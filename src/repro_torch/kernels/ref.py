"""Plain PyTorch versions of the kernels (the oracle the kernels are held to).

Each ``<name>_ref`` computes exactly what the CUDA kernel of the same name
in ``csrc/`` computes — bit for bit for the integer coloring kernels, up to
float rounding for ``ell_spmm_ref`` and ``flash_attention_ref``.  The
wrappers take these for tensors that lie on the CPU, the CPU tests hold them
against the reference package, and ``chip_smoke.py`` holds each kernel
against them on the card.

The coloring refs take ``impl``: "bitset" (default) runs the packed
forbidden-set + branch-free mex of ``core/bitset.py``, "dense" keeps the
(R, W, C) one-hot + first-zero formulation as the independent oracle.  All
corners agree bit-for-bit.

Beyond the reference package's refs, they take the optional inputs that
the engines' chunk passes need (``core/coloring._chunked_pass``,
``core/frontier._slot_pass``, ``core/distance2._d2_*_pass``): ``forb0``
(R, n_words(C)) int32 packed words OR-ed into the forbidden set before the
mex (the overflow-COO snapshot slice), ``extra_defect`` (R,) bool OR-ed into
the defect flags, ``force`` / ``valid`` (R,) bool so that ``work = valid &
((U & defect) | force)``, and ``row_ids`` (R,) int32: row r is vertex
``row_ids[r]`` (clamped to ``[0, n-1]``, as the gathers clamp) of the full
ELL table instead of ``row_start + r`` of a tile — the compacted-frontier
passes.  ``twohop_ref`` also takes ``detect=False`` (round 0: ``work = valid
& (U | force)``, no priority read).  With all of them absent the outputs are
the reference's.  ``detect_recolor_ref`` also takes ``detect_only=True``
(CAT's separate detect pass): it returns the ``recolored`` flags alone and
computes no forbidden set and no mex.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitset


def _first_zero(forb: torch.Tensor):
    """(mex, all-forbidden) of a dense (R, C) bool table: index of the first
    False per row, 0 on an all-True row.  (``argmin`` is not used: which of
    several equal minima it returns is not a documented guarantee on every
    device, a masked ``amin`` over the column index is exact.)"""
    R, C = forb.shape
    idx = torch.arange(C, dtype=torch.int32, device=forb.device)[None, :]
    cand = torch.where(forb, torch.full((), C, dtype=torch.int32,
                                        device=forb.device), idx)
    mex = cand.amin(dim=1).to(torch.int32)
    full = mex >= C
    return torch.where(full, torch.zeros_like(mex), mex), full


def _forbidden_mex(nbrc: torch.Tensor, C: int, impl: str,
                   forb0: Optional[torch.Tensor] = None):
    """(R, W) gathered colors -> (mex (R,), all-forbidden (R,) bool)."""
    if impl == "dense":
        idx = torch.arange(C, dtype=torch.int32, device=nbrc.device)
        forb = (nbrc[:, :, None] == idx[None, None, :]).any(dim=1)
        if forb0 is not None:
            forb = forb | (bitset.to_dense(forb0, C) > 0)
        return _first_zero(forb)
    words = bitset.pack_from_nbrc(nbrc, C)
    if forb0 is not None:
        words = words | forb0
    return bitset.mex_words(words, C)


def _scatter_mex(nbrc: torch.Tensor, C: int, impl: str):
    """``_forbidden_mex`` for wide rows (the W + W**2 slots of a two-hop
    row): scatter the colors into a dense (R, C) table — O(R*W) where the
    inline pack and the one-hot compare cost O(R*W*words) and O(R*W*C) —
    then "bitset" packs it (``bitset.pack_dense``, the scatter-then-pack
    route) for the branch-free mex, "dense" takes its first zero."""
    R = nbrc.shape[0]
    ok = (nbrc >= 0) & (nbrc < C)
    forb = torch.zeros((R, C), dtype=torch.uint8, device=nbrc.device)
    r = torch.arange(R, device=nbrc.device)[:, None].expand_as(nbrc)
    forb[r[ok], nbrc[ok].long()] = 1
    if impl == "dense":
        return _first_zero(forb > 0)
    return bitset.mex_words(bitset.pack_dense(forb, C), C)


def _gather(ell: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """``vec[ell]`` with FILL (< 0) slots reading -1; indices are clamped
    as the reference's gathers clamp them (torch would raise instead)."""
    n = vec.shape[0]
    safe = ell.clamp(0, n - 1).long()
    return torch.where(ell >= 0, vec[safe],
                       torch.full((), -1, dtype=vec.dtype, device=vec.device))


# --------------------------------------------------------------------------
# first-fit tentative coloring (paper Alg. 1 inner loop, one chunk)
# --------------------------------------------------------------------------

def firstfit_ref(ell, colors, C: int, impl: str = "bitset", forb0=None):
    """Smallest color not used by any neighbor, per ELL row.

    ell:    (R, W) int32 neighbor ids, FILL(-1) padded
    colors: (n,)   int32 current colors (-1 uncolored)
    returns (mex (R,) int32, overflow (R,) bool)
    """
    return _forbidden_mex(_gather(ell, colors), C, impl, forb0)


# --------------------------------------------------------------------------
# fused detect-and-recolor (RSOC, paper Alg. 3 inner loop, one chunk)
# --------------------------------------------------------------------------

def _row_ids(row_ids, row_start: int, R: int, n: int, device):
    """Vertex id of each row: ``row_ids`` clamped to [0, n-1], else the tile
    ``row_start + arange(R)``."""
    if row_ids is not None:
        return row_ids.clamp(0, n - 1).long()
    return row_start + torch.arange(R, device=device)


def _work(U_rows, defect, force, valid):
    """``valid & ((U & defect) | force)``; ``defect=None`` is round 0."""
    work = U_rows if defect is None else U_rows & defect
    if force is not None:
        work = work | force
    if valid is not None:
        work = work & valid
    return work


def _slot_ids(ell, vid, slot_rows: int):
    """The slot-stride form's global neighbour ids: each row's local ids
    clamped to its slot and moved to the slot's first row (FILL stays
    FILL)."""
    base = (vid - vid % slot_rows)[:, None].to(ell.dtype)
    return torch.where(ell >= 0, base + ell.clamp(max=slot_rows - 1), ell)


def detect_recolor_ref(ell, colors, pri, row_start: int, U_rows, C: int,
                       impl: str = "bitset", forb0=None, extra_defect=None,
                       force=None, valid=None, row_ids=None,
                       detect_only: bool = False, slot_rows: int = 0):
    """For rows [row_start, row_start+R) — or, with ``row_ids``, vertices
    ``row_ids`` of the full table ``ell`` — if in U and defective (same color
    as a higher-priority neighbor), re-color with first-fit; else keep.
    ``slot_rows > 0`` (with ``row_ids``): the tables are stacked slots of
    ``slot_rows`` rows and each row's neighbour ids are local to its slot.

    returns (new row colors (R,), recolored (R,) bool, overflow (R,) bool);
    with ``detect_only`` the recolored flags alone (R,) bool
    """
    R = ell.shape[0] if row_ids is None else row_ids.shape[0]
    vid = _row_ids(row_ids, row_start, R, colors.shape[0], ell.device)
    if row_ids is not None:
        # a table longer than ell (a ghost tail): the rows past ell's last
        # cannot work, and read its last row, as a clamped gather does
        ell = ell[vid.clamp(max=ell.shape[0] - 1)]
        if slot_rows:
            ell = _slot_ids(ell, vid, slot_rows)
    c_r = colors[vid]
    p_r = pri[vid]
    nbrc = _gather(ell, colors)
    nbrp = _gather(ell, pri)
    defect = ((nbrc == c_r[:, None]) & (c_r[:, None] >= 0)
              & (nbrp > p_r[:, None])).any(dim=1)
    if extra_defect is not None:
        defect = defect | extra_defect
    if detect_only:
        return _work(U_rows, defect, force, valid)
    mex, ovf = _forbidden_mex(nbrc, C, impl, forb0)
    return bitset.apply_recolor(_work(U_rows, defect, force, valid), mex, ovf,
                                c_r)


# --------------------------------------------------------------------------
# fused two-hop detect-and-recolor (native distance-2, one chunk)
# --------------------------------------------------------------------------

# slots (rows x (W + W**2)) of the gathered panels the two-hop plain version
# builds at once; larger chunks go in row blocks (same result: rows are
# independent), so a chunk of a real-size graph fits on the card
TWOHOP_BLOCK_SLOTS = 2 ** 24


def twohop_panels(e1, ell_all, colors, pri, vid, n: int, detect: bool = True):
    """Colors (and, with ``detect``, priorities) of every vertex within two
    hops of each row: (allc, allp), both (R, W1 + W1*W) for (R, W1) hop-1
    ids ``e1`` and an (n_all, W) table — hop-1 neighbour colors, then hop-2
    colors gathered through each neighbour's own row of ``ell_all``.  Dead
    slots and the row's own id ``vid`` (its own two-hop neighbour through
    any neighbour; compared as given) carry -1.  Every index is clamped to
    [0, n-1].  ``allp`` is None without ``detect``."""
    R, W1 = e1.shape
    W = ell_all.shape[1]
    live1 = e1 >= 0
    s1 = e1.clamp(0, n - 1).long()
    e2 = ell_all[s1.reshape(-1)].reshape(R, W1 * W)          # hop-2 ids
    live2 = (live1.repeat_interleave(W, dim=1) & (e2 >= 0)
             & (e2 != vid[:, None]))                          # self-exclusion
    s2 = e2.clamp(0, n - 1).long()
    neg = torch.full((), -1, dtype=colors.dtype, device=colors.device)
    allc = torch.cat([torch.where(live1, colors[s1], neg),
                      torch.where(live2, colors[s2], neg)], dim=1)
    if not detect:
        return allc, None
    allp = torch.cat([torch.where(live1, pri[s1], neg),
                      torch.where(live2, pri[s2], neg)], dim=1)
    return allc, allp


def twohop_ref(ell_rows, ell_all, colors, pri, row_start: int, U_rows, C: int,
               impl: str = "bitset", force=None, valid=None, row_ids=None,
               detect: bool = True):
    """Distance-2 analogue of ``detect_recolor_ref``: the forbidden set and
    the defect test read the colors of every vertex reachable in one or two
    hops — hop 2 re-gathers each neighbor's ELL row from ``ell_all``, so
    G²'s adjacency is consumed on the fly, never materialized.  A vertex is
    its own two-hop neighbor through any neighbor and is excluded.

    ell_rows: (R, W) neighbor tile for rows [row_start, row_start+R), or
              None with ``row_ids`` (rows are then read from ``ell_all``)
    ell_all:  (n_all, W) full neighbor table (hop-2 source), n_all >= n
    colors:   (n,) global colors;  pri: (n,) priorities;  U_rows: (R,) bool
    returns (new row colors (R,), recolored (R,) bool, overflow (R,) bool)
    """
    n = colors.shape[0]
    R = ell_rows.shape[0] if row_ids is None else row_ids.shape[0]
    W = ell_all.shape[1]
    vid = _row_ids(row_ids, row_start, R, n, ell_all.device)
    step = max(1, TWOHOP_BLOCK_SLOTS // (W + W * W))
    mex, ovf, defect = [], [], []
    for lo in range(0, R, step):
        v = vid[lo:lo + step]
        e1 = ell_all[v] if row_ids is not None else ell_rows[lo:lo + step]
        # columns past the block's last live one add nothing: drop them
        # (ELL rows are left-packed, so on real tables this is the block's
        # largest degree instead of W)
        w1 = int((e1 >= 0).any(dim=0).cumsum(0).argmax()) + 1
        allc, allp = twohop_panels(e1[:, :w1], ell_all, colors, pri, v, n,
                                   detect)
        m, o = _scatter_mex(allc, C, impl)
        mex.append(m)
        ovf.append(o)
        if detect:
            c_r, p_r = colors[v][:, None], pri[v][:, None]
            defect.append(((allc == c_r) & (c_r >= 0)
                           & (allp > p_r)).any(dim=1))
    cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs)
    work = _work(U_rows, cat(defect) if detect else None, force, valid)
    return bitset.apply_recolor(work, cat(mex), cat(ovf), colors[vid])


# --------------------------------------------------------------------------
# ELL aggregation (GNN message passing over padded neighbor tiles)
# --------------------------------------------------------------------------

def ell_spmm_ref(ell, feats, op: str = "sum"):
    """out[v] = op over feats[nbr] for nbr in ell[v], FILL ignored — the
    plain version of the CUDA kernel ``ell_spmm`` (``csrc/ell_spmm.cu``).

    ell:   (R, W) int32 (an id >= n reads row n - 1, as the reference's
           clipped gather does)
    feats: (n, d) float32 or bfloat16
    op in {sum, mean, max}; an all-FILL row gives 0 for every op.  The sum
    is taken in float32 and rounded once to the feature type (the
    reference's jnp version sums in the feature type; equal for float32).
    Returns (R, d) in the feature type.
    """
    if op not in ("sum", "mean", "max"):
        raise ValueError(op)
    n = feats.shape[0]
    valid = (ell >= 0)[..., None]
    rows = feats[ell.clamp(0, n - 1).long()].float()          # (R, W, d)
    if op == "max":
        out = torch.where(valid, rows, -torch.inf).amax(dim=1)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        out = torch.where(valid, rows, 0.0).sum(dim=1)
        if op == "mean":
            out = out / valid.sum(dim=1).clamp(min=1)
    return out.to(feats.dtype)


# --------------------------------------------------------------------------
# blockwise (flash) attention
# --------------------------------------------------------------------------

def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain softmax attention — the plain version of the CUDA kernel
    ``attn_flash_forward`` (``csrc/flash_attention.cu``).

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D); GQA: Hq % Hkv == 0; query i
    sees keys <= i + (Lk - Lq) when causal.  Computed in float32 from the
    inputs and rounded once to q's type (the reference's jnp version works
    in the input type; equal for float32).
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    kr = k.float().repeat_interleave(G, dim=1)
    vr = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal:
        mask = (torch.arange(Lk, device=q.device)[None, :]
                <= torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq))
        s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
