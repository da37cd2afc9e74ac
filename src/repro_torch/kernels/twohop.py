"""Fused two-hop detect-and-recolor (native distance-2): CUDA kernel + plain
version.

Replaces the Pallas kernel ``src/repro/kernels/twohop.py::
twohop_detect_recolor`` (body ``_twohop_kernel``): for each row, hop 1
gathers its neighbours' colours and hop 2 re-gathers every neighbour's own
row of the full table ``ell_all``, skipping the row's own id; both feed one
packed forbidden set and the defect test, then the recolor epilogue.  G²'s
adjacency is consumed on the fly and never materialized.  The entry point
is ``coloring_twohop_detect_recolor`` in ``csrc/twohop.cu``; the plain
PyTorch version is ``twohop_ref`` (``kernels/ref.py``).

The reference pages ``ell_all`` through VMEM (``page_rows`` rows per page)
because a whole table does not fit there.  The card reads the table from
device memory through L2 with no size limit, and a row stages exactly its
own hop-2 rows: ``page_rows`` is accepted and checked, and the result does
not depend on it.  ``default_page_rows`` is kept with the reference's rule.

Designs on the card, picked by shape (``design``), each launch counted in
``launches`` and in ``launches_<design>``:

* ``"staged16"`` / ``"staged4"`` — ``csrc/twohop_staged.cu`` on the
  template of ``csrc/staged_pass.cuh``: a row's live hop-1 ids packed into
  shared memory, all of its hop-2 rows copied into a shared-memory stage
  with ``cp.async`` (16-B copies where W*4 is a multiple of 16 and
  ``ell_all`` is 16-B aligned, else 4-B copies) before any is used, a row
  ahead, colours gathered eight at a time a lane into shared-memory words.
  Rows wider than ``DIRECT_MAX_W`` whose stage holds a row
  (``staged_fits(lanes, W)``, which asks the library: every W <= 512 at the
  default lanes).
* ``"direct"`` — ``csrc/twohop.cu``'s kernel: hop-2 rows read straight from
  device memory one neighbour after another; rows of at most
  ``DIRECT_MAX_W`` ids (the meshes, where it takes less device time than
  the staged pass: a short row cannot pay for the staging) and the shapes
  the stage does not hold.

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
writes 6 bytes.  Integer work only.  The designs aim at the reads (see the
notes in ``csrc/staged_pass.cuh`` and ``csrc/twohop.cu``).  Beyond the
bytes, a pass must make one hop-2
row fetch per live neighbour of a working row (a random W*4-byte read from
device memory) and one L2 colour lookup per live slot: at RMAT-ER's chunk
that is millions of fetches and tens of millions of lookups, which set its
floor above the bytes bound.

``twohop_detect_recolor`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — for those only: on a CUDA tensor it launches
or raises (no fallback from one design to another either).
``twohop_detect_recolor.launches`` counts the launches, ``launches_staged16``
/ ``launches_staged4`` / ``launches_direct`` those of each design.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.firstfit import (DIRECT_MAX_W, check_common,
                                          check_launch, check_row_ids,
                                          check_tensor, ptr)
# the plain version, as a module attribute: importing kernels.ref
# first (it imports core, which imports these wrappers) must not cycle
from repro_torch.kernels import ref

# Target bytes of one hop-2 table page in the reference's VMEM paging.
PAGE_TARGET_BYTES = 2 * 2**20

DESIGNS = ("direct", "staged16", "staged4")   # the C entry point's ids


def staged_fits(lanes: int, W: int) -> bool:
    """Whether the staged designs hold rows of W ids at ``lanes`` lanes a
    row: a group's stage slice holds one table row and a warp's id buffer
    its groups' rows.  The rule lives with the kernel; this asks the
    library (``coloring_twohop_staged_fits``), so it needs the card's
    build."""
    return bool(_build.library().coloring_twohop_staged_fits(int(lanes),
                                                             int(W)))


def design(W: int, fits: bool, aligned: bool = True) -> str:
    """The kernel that serves a call on the card: ``"direct"`` for rows of
    at most ``DIRECT_MAX_W`` ids or a shape the staged designs do not hold
    (``fits``: ``staged_fits``); else ``"staged16"`` where W*4 is a
    multiple of 16 and the table 16-B aligned (``aligned``), ``"staged4"``
    otherwise."""
    if W <= DIRECT_MAX_W or not fits:
        return "direct"
    return "staged16" if W % 4 == 0 and aligned else "staged4"


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
    route = design(W, staged_fits(lanes, W), ell_all.data_ptr() % 16 == 0)
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
            lanes, window, DESIGNS.index(route), stream)
    check_launch(f"twohop_detect_recolor ({route})", err)
    twohop_detect_recolor.launches += 1
    setattr(twohop_detect_recolor, f"launches_{route}",
            getattr(twohop_detect_recolor, f"launches_{route}") + 1)
    return newc, rec, ovf


twohop_detect_recolor.launches = 0
twohop_detect_recolor.launches_direct = 0
twohop_detect_recolor.launches_staged16 = 0
twohop_detect_recolor.launches_staged4 = 0
