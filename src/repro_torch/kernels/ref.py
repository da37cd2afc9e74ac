"""Plain PyTorch versions of the coloring kernels (the bit-equality oracle).

Each ``<name>_ref`` computes exactly what the CUDA kernel of the same name
in ``csrc/coloring.cu`` computes; the wrappers take these for tensors that
lie on the CPU, the CPU tests hold them against the reference package, and
``chip_smoke.py`` holds each kernel against them on the card.

The refs take ``impl``: "bitset" (default) runs the packed forbidden-set +
branch-free mex of ``core/bitset.py``, "dense" keeps the (R, W, C) one-hot +
first-zero formulation as the independent oracle.  All corners agree
bit-for-bit.

Beyond the reference package's refs, both take the optional inputs that the
engine's chunk pass needs (``core/coloring._chunked_pass``): ``forb0``
(R, n_words(C)) int32 packed words OR-ed into the forbidden set before the
mex (the overflow-COO snapshot slice), and for ``detect_recolor_ref``
``extra_defect`` (R,) bool OR-ed into the defect flags, and ``force`` /
``valid`` (R,) bool so that ``work = valid & ((U & defect) | force)``.  With
all of them absent the outputs are the reference's.
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

def detect_recolor_ref(ell, colors, pri, row_start: int, U_rows, C: int,
                       impl: str = "bitset", forb0=None, extra_defect=None,
                       force=None, valid=None):
    """For rows [row_start, row_start+R): if in U and defective (same color as
    a higher-priority neighbor), re-color with first-fit; else keep.

    returns (new row colors (R,), recolored (R,) bool, overflow (R,) bool)
    """
    R = ell.shape[0]
    c_r = colors[row_start:row_start + R]
    p_r = pri[row_start:row_start + R]
    nbrc = _gather(ell, colors)
    nbrp = _gather(ell, pri)
    defect = ((nbrc == c_r[:, None]) & (c_r[:, None] >= 0)
              & (nbrp > p_r[:, None])).any(dim=1)
    if extra_defect is not None:
        defect = defect | extra_defect
    work = U_rows & defect
    if force is not None:
        work = work | force
    if valid is not None:
        work = work & valid
    mex, ovf = _forbidden_mex(nbrc, C, impl, forb0)
    return bitset.apply_recolor(work, mex, ovf, c_r)
