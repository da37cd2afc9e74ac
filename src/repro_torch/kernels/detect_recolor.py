"""RSOC's fused detect-and-recolor over one chunk: CUDA kernel + plain version.

Replaces the Pallas kernel
``src/repro/kernels/detect_recolor.py::detect_recolor`` (body
``_detect_recolor_kernel``): for rows ``[row_start, row_start + R)`` one
gather of the neighbours' colours and priorities feeds both the defect test
(same colour as a higher-priority neighbour) and the packed forbidden
bitset; rows that must work take their mex, all others keep their colour.
The kernel is ``coloring_detect_recolor`` in ``csrc/detect_recolor.cu``; the
plain PyTorch version is ``detect_recolor_ref`` (``kernels/ref.py``).

The optional inputs carry what the engines' chunk passes do beyond the
reference kernel: ``forb0`` (R, n_words(C)) int32 is OR-ed into the initial
forbidden words (the overflow-COO snapshot slice), ``extra_defect`` (R,) bool
into the defect flags (overflow-edge conflicts), ``work = valid & ((U &
defect) | force)``, and ``row_ids`` (R,) int32 makes row r the vertex
``row_ids[r]`` (clamped to [0, n-1]) of the full table ``ell`` — colour,
priority and ELL row — for ``core/frontier._slot_pass``; ``forb0``,
``extra_defect`` and the flags stay indexed by r.  With all of them absent
the outputs are bit-identical to the reference's.  The colour table may be
longer than ``ell`` (a shard's table with its ghost tail, the sharded
repair): the kernel reads the ELL row of a row that can work only, so the
caller keeps those rows' ids below ``ell``'s row count, and the plain
version clamps the ELL row of every other row to ``ell``'s last, as the
reference's gather does.  The slot-stride form needs the whole stacked
table.

Bound on the card: bytes.  Rows outside ``valid & (U | force)`` cost their
O(1) vector entries only; each other row costs its ``W*4`` bytes of ELL plus
a 4-byte colour and a 4-byte priority per live slot (at most the two whole
``n*4``-byte vectors once), and every row writes 6 bytes.  No floating point.
Rows of more than ``DIRECT_MAX_W`` ids that are whole 16-B chunks (W*4 a
multiple of 16, ``ell`` 16-B aligned) take the design ``"vec16"``, the
staged pass (``csrc/staged_pass.cuh``), which streams the tile: persistent
groups of ``lanes`` lanes (by default ``default_lanes``) skip the rows that
cannot work ``lanes`` at a time, copy each working row's W ids into a
shared-memory stage with 16-B ``cp.async`` copies while the previous row's
colours are gathered, load the colours of the live slots eight at a time a
lane, a priority only where a colour equals the row's, and keep the
forbidden words (``window`` of them at a time) in shared memory.  Every
other shape — rows of at most ``DIRECT_MAX_W`` ids (the meshes) and rows
that are not whole 16-B chunks — takes the design ``"direct"``:
``csrc/coloring.cu``'s one-row-at-a-time ``pass_body`` (firstfit's
``"direct"``, with the defect test), which took less device time at the
meshes on an H100.  The rule (``design``) is first fit's, in
``kernels/firstfit.py``: the two kernels pick their designs alike.
The kernel writes ``newc`` and never ``colors``: every row of a launch sees
the pre-launch colours whatever the block order; the caller commits.

``detect_only=True`` is CAT's separate detect pass (phase B,
``core/coloring._detect_pass``) on the same kernel: the defect test alone,
with the forbidden set, the mex and the ``newc`` / ``ovf`` writes switched
off (null output pointers).  It returns the ``(R,)`` flags that the full
pass returns as ``recolored`` — ``valid & ((U & (defect | extra_defect)) |
force)`` — and takes no ``forb0``.  Its bytes bound drops the 5 output bytes
of ``newc`` / ``ovf`` a row; it reads what the full pass reads minus
``forb0``.

``slot_rows > 0`` is the slot-stride form, the megabatched repair's pass
(``core/frontier._repair_mega_loop``): ``ell``, ``colors`` and ``pri`` are
the stacked tables of S = n / slot_rows slots, flattened to (S*slot_rows,
...), and ``row_ids`` are global ids ``s*slot_rows + v``.  Row r reads its
neighbour j at ``base + min(j, slot_rows - 1)``, base the first row of its
slot: ELL ids stay local to their slot, and one launch over the rows of many
slots computes what one launch a slot over that slot's own tables computes.
``slot_rows = 0`` is the one-table pass, unchanged.  Its bytes bound is the
one-table pass's: each working row reads its own row, colours and
priorities.

``detect_recolor`` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors — for those only: on a CUDA tensor it launches or
raises.  ``detect_recolor.launches`` counts the launches of the full
one-table pass, ``launches_vec16`` / ``launches_direct`` those of each
design; ``launches_detect`` (and ``launches_detect_vec16`` / ``_direct``)
count the detect-only launches and ``launches_slots`` (and
``launches_slots_vec16`` / ``_direct``) those of the slot-stride form,
which the first three do not.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitset
from repro_torch.kernels import _build
# the shape rule (``design``, ``default_lanes``) and the design ids are
# first fit's: the two wrappers pick their designs alike
from repro_torch.kernels.firstfit import (  # noqa: F401
    DESIGNS, DIRECT_MAX_W, check_common, check_launch, check_row_ids,
    check_tensor, count_launch, default_lanes, design, ptr)
# the plain version, as a module attribute: importing kernels.ref
# first (it imports core, which imports these wrappers) must not cycle
from repro_torch.kernels import ref


def check_detect_only(forb0) -> None:
    """``detect_only`` computes no forbidden set: it takes no ``forb0``."""
    if forb0 is not None:
        raise ValueError("detect_only computes no forbidden set: forb0 must "
                         "be None")


def check_slot_rows(slot_rows: int, row_ids, n: int,
                    detect_only: bool) -> int:
    """The slot-stride form needs ``row_ids`` and a table of whole slots,
    and is a full pass; returns ``slot_rows`` as an int."""
    slot_rows = int(slot_rows)
    if slot_rows < 0:
        raise ValueError(f"slot_rows must be >= 0 (got {slot_rows})")
    if slot_rows:
        if row_ids is None:
            raise ValueError("slot_rows needs row_ids (global ids "
                             "s*slot_rows + v)")
        if n % slot_rows:
            raise ValueError(f"slot_rows={slot_rows} must divide the "
                             f"stacked tables' n={n}")
        if detect_only:
            raise ValueError("the slot-stride form is a full pass: "
                             "detect_only must be False")
    return slot_rows


def detect_recolor(ell, colors, pri, U_rows, row_start: int, C: int,
                   forb0=None, extra_defect=None, force=None, valid=None, *,
                   row_ids=None, lanes: Optional[int] = None,
                   window: Optional[int] = None, detect_only: bool = False,
                   slot_rows: int = 0):
    """Fused RSOC pass for rows [row_start, row_start + R), or for the
    vertices ``row_ids``.

    ell (R, W) int32 tile of those rows — with ``row_ids`` (R,) int32, the
    full (>= n, W) table instead, and ``row_start`` unused; colors, pri (n,)
    int32; U_rows (R,) bool; optional forb0 (R, n_words(C)) int32 and
    extra_defect / force / valid (R,) bool.  Returns (new row colors (R,)
    int32, recolored (R,) bool, overflow (R,) bool); with ``detect_only``
    the recolored flags alone (no ``forb0``).  ``slot_rows > 0``: the
    slot-stride form (module docstring).  ``lanes`` / ``window`` override
    the launch shape (the result does not depend on them).
    """
    if detect_only:
        check_detect_only(forb0)
    lanes_given = lanes is not None
    if row_ids is None:
        R, W, n, lanes, window = check_common(ell, colors, C, forb0, lanes,
                                              window)
    else:
        n_ell, W, n, lanes, window = check_common(ell, colors, C, None,
                                                  lanes, window)
        R = check_row_ids(row_ids, ell.device)
        if n_ell < n and int(slot_rows):
            raise ValueError(f"with slot_rows, ell must be the stacked "
                             f"table of >= n={n} rows (got {n_ell})")
        if forb0 is not None:
            check_tensor("forb0", forb0, torch.int32,
                         (R, bitset.n_words(C)), ell.device)
    device = ell.device
    check_tensor("pri", pri, torch.int32, (n,), device)
    check_tensor("U_rows", U_rows, torch.bool, (R,), device)
    for name, t in (("extra_defect", extra_defect), ("force", force),
                    ("valid", valid)):
        if t is not None:
            check_tensor(name, t, torch.bool, (R,), device)
    row_start = int(row_start)
    if row_ids is None and (row_start < 0 or row_start + R > n):
        raise ValueError(f"rows [{row_start}, {row_start + R}) lie outside "
                         f"the (n={n},) color vector")
    slot_rows = check_slot_rows(slot_rows, row_ids, n, detect_only)
    if device.type != "cuda":
        return ref.detect_recolor_ref(
            ell, colors, pri, row_start, U_rows, C, forb0=forb0,
            extra_defect=extra_defect, force=force, valid=valid,
            row_ids=row_ids, detect_only=detect_only, slot_rows=slot_rows)
    aligned = ell.data_ptr() % 16 == 0
    route = design(W, aligned)
    if not lanes_given:
        lanes = default_lanes(W, aligned)
    lib = _build.library()
    rec = torch.empty((R,), dtype=torch.bool, device=device)
    newc = ovf = None                    # detect only: null output pointers
    if not detect_only:
        newc = torch.empty((R,), dtype=torch.int32, device=device)
        ovf = torch.empty((R,), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coloring_detect_recolor(
            ptr(ell), ptr(colors), ptr(pri), ptr(U_rows), ptr(forb0),
            ptr(extra_defect), ptr(force), ptr(valid), ptr(row_ids),
            ptr(newc), ptr(rec), ptr(ovf), R, W, n, int(C), row_start, lanes,
            window, DESIGNS.index(route), slot_rows, stream)
    if detect_only:
        check_launch(f"detect_recolor ({route}, detect only)", err)
        count_launch(detect_recolor, route, "launches_detect")
        return rec
    if slot_rows:
        check_launch(f"detect_recolor ({route}, slot stride)", err)
        count_launch(detect_recolor, route, "launches_slots")
        return newc, rec, ovf
    check_launch(f"detect_recolor ({route})", err)
    count_launch(detect_recolor, route)
    return newc, rec, ovf


detect_recolor.launches = 0
detect_recolor.launches_vec16 = 0
detect_recolor.launches_direct = 0
detect_recolor.launches_detect = 0
detect_recolor.launches_detect_vec16 = 0
detect_recolor.launches_detect_direct = 0
detect_recolor.launches_slots = 0
detect_recolor.launches_slots_vec16 = 0
detect_recolor.launches_slots_direct = 0
