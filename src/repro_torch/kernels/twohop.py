"""Fused two-hop detect-and-recolor (native distance-2): CUDA kernel + plain
version.

Replaces the Pallas kernel ``src/repro/kernels/twohop.py::
twohop_detect_recolor`` (body ``_twohop_kernel``): for each row, hop 1
gathers its neighbours' colours and hop 2 re-gathers every neighbour's own
row of the full table ``ell_all``, skipping the row's own id; both feed one
packed forbidden set and the defect test, then the recolor epilogue.  G²'s
adjacency is consumed on the fly and never materialized.  The kernel is
``coloring_twohop_detect_recolor`` in ``csrc/twohop.cu``; the plain PyTorch
version is ``twohop_ref`` (``kernels/ref.py``).

The reference pages ``ell_all`` through VMEM (``page_rows`` rows per page)
because a whole table does not fit there.  The card reads the table from
device memory through L2 with no size limit, so nothing is paged:
``page_rows`` is accepted and checked, and the result does not depend on it.
``default_page_rows`` is kept with the reference's rule.

The optional inputs carry what the distance-2 engine's passes do beyond the
reference kernel (``core/distance2.py``): ``force`` / ``valid`` (R,) bool so
that ``work = valid & ((U & defect) | force)``; ``row_ids`` (R,) int32 makes
row r the vertex ``row_ids[r]`` (clamped to [0, n-1]) read from ``ell_all``
(then ``ell_rows`` is None and ``row_start`` unused: the compacted-frontier
pass); ``detect=False`` is round 0, ``work = valid & (U | force)``, and reads
no priority (``pri`` may be None).  With all of them absent the outputs are
bit-identical to the reference's.

Bound on the card: bytes.  A row that can work reads its W ids, one hop-2
row of W ids per live neighbour (at most the whole table once over a
launch) and one 4-byte colour per live slot of either hop (at most the whole
vector once), a priority only where a colour equals the row's own; every row
writes 6 bytes.  Integer work only.  The design aims at the reads: ``lanes``
lanes share a row and read consecutive words of each row, the forbidden
words stay in registers (see the note in ``csrc/twohop.cu``).

``twohop_detect_recolor`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — for those only: on a CUDA tensor it launches
or raises.  ``twohop_detect_recolor.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.firstfit import (check_common, check_launch,
                                          check_row_ids, check_tensor, ptr)
# the plain version, as a module attribute: importing kernels.ref
# first (it imports core, which imports these wrappers) must not cycle
from repro_torch.kernels import ref

# Target bytes of one hop-2 table page in the reference's VMEM paging.
PAGE_TARGET_BYTES = 2 * 2**20


def default_page_rows(n_all: int, W: int,
                      page_bytes: int = PAGE_TARGET_BYTES) -> int:
    """The reference's rows per hop-2 table page: ~page_bytes worth of (W,)
    int32 rows, a multiple of 128, never more than the table.  The kernel
    here does not page; the rule is kept so that callers of the reference
    signature get the same value."""
    rows = max(page_bytes // max(W * 4, 1), 128)
    rows = max(rows // 128, 1) * 128
    return min(rows, max(n_all, 1))


def twohop_detect_recolor(ell_rows, ell_all, colors, pri, U_rows,
                          row_start: int, C: int,
                          page_rows: Optional[int] = None, *, force=None,
                          valid=None, row_ids=None, detect: bool = True,
                          lanes: Optional[int] = None,
                          window: Optional[int] = None):
    """Fused two-hop pass for rows [row_start, row_start + R), or for the
    vertices ``row_ids``.

    ell_rows (R, W) int32 tile of those rows (None with ``row_ids``);
    ell_all (n_all, W) int32, n_all >= n; colors, pri (n,) int32; U_rows
    (R,) bool; optional force / valid (R,) bool.  Returns (new row colors
    (R,) int32, recolored (R,) bool, overflow (R,) bool).  ``page_rows``,
    ``lanes`` and ``window`` do not change the result.
    """
    n_all, W, n, lanes, window = check_common(ell_all, colors, C, None,
                                              lanes, window)
    device = ell_all.device
    if n_all < n:
        raise ValueError(f"ell_all has {n_all} rows, fewer than the "
                         f"(n={n},) color vector")
    if page_rows is not None and int(page_rows) < 1:
        raise ValueError(f"page_rows must be >= 1 or None (got {page_rows})")
    row_start = int(row_start)
    if row_ids is None:
        if ell_rows is None:
            raise ValueError("ell_rows is needed when row_ids is not given")
        if ell_rows.dim() != 2 or ell_rows.shape[0] < 1:
            raise ValueError("ell_rows must be a 2-D tensor (R, W), R >= 1")
        R = ell_rows.shape[0]
        check_tensor("ell_rows", ell_rows, torch.int32, (R, W), device)
        if row_start < 0 or row_start + R > n:
            raise ValueError(f"rows [{row_start}, {row_start + R}) lie "
                             f"outside the (n={n},) color vector")
    else:
        if ell_rows is not None:
            raise ValueError("pass ell_rows=None with row_ids: the rows are "
                             "read from ell_all")
        R = check_row_ids(row_ids, device)
    if detect or pri is not None:
        check_tensor("pri", pri, torch.int32, (n,), device)
    check_tensor("U_rows", U_rows, torch.bool, (R,), device)
    for name, t in (("force", force), ("valid", valid)):
        if t is not None:
            check_tensor(name, t, torch.bool, (R,), device)
    if device.type != "cuda":
        return ref.twohop_ref(ell_rows, ell_all, colors, pri, row_start,
                              U_rows, C, force=force, valid=valid,
                              row_ids=row_ids, detect=detect)
    lib = _build.library()
    newc = torch.empty((R,), dtype=torch.int32, device=device)
    rec = torch.empty((R,), dtype=torch.bool, device=device)
    ovf = torch.empty((R,), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coloring_twohop_detect_recolor(
            ptr(ell_rows), ptr(ell_all), ptr(colors), ptr(pri), ptr(U_rows),
            ptr(force), ptr(valid), ptr(row_ids), ptr(newc), ptr(rec),
            ptr(ovf), R, W, n, n_all, int(C), row_start, int(bool(detect)),
            lanes, window, stream)
    check_launch("twohop_detect_recolor", err)
    twohop_detect_recolor.launches += 1
    return newc, rec, ovf


twohop_detect_recolor.launches = 0
