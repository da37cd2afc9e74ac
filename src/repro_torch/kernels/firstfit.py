"""First-fit tentative coloring over an ELL tile: CUDA kernel + plain version.

Replaces the Pallas kernel ``src/repro/kernels/firstfit.py::firstfit`` (body
``_firstfit_kernel``): per ELL row, gather the neighbours' colours, OR them
into a packed forbidden bitset (tail bits >= C pre-forbidden) and return the
smallest free colour ``mex`` and the all-forbidden flag ``ovf`` (``mex=0`` on
an all-ones row).  The entry is ``coloring_firstfit`` in
``csrc/coloring.cu``; the plain PyTorch version of the same function is
``firstfit_ref`` (``kernels/ref.py``).

Bound on the card: bytes.  It must read the ``R*W*4`` bytes of the ELL tile
and one 4-byte colour per distinct live id (at most the whole ``n*4``-byte
vector once), optionally the ``R*nW*4`` bytes of ``forb0``, and write ``R*5``
bytes; it does a handful of integer operations per slot and no floating
point.  Two designs, picked by shape (``design``; the rule is shared with
``detect_recolor``), each launch counted in ``launches`` and in
``launches_<design>``:

* ``"vec16"`` for rows of more than ``DIRECT_MAX_W`` ids that are whole 16-B
  chunks of a 16-B aligned tile (the RMATs' W 44 and 512): the staged pass
  of ``csrc/staged_pass.cuh``, the repair pass's kernel with no candidate
  set (every row works), no defect test and no ``recolored`` output.
  Persistent groups of ``lanes`` lanes (8 by default) copy each row's W ids
  into a shared-memory stage with 16-B ``cp.async`` copies (L2 evict-first)
  while the previous row's colours are gathered, eight loads a lane at a
  time, into forbidden words in shared memory.
* ``"direct"`` everywhere else (the meshes' W 8 and 14, and rows that are
  not whole 16-B chunks): ``pass_body`` in ``csrc/coloring.cu``, one row a
  group of ``lanes`` lanes (one slot a lane), the forbidden words in
  registers, where a row is a few loads and the staged pass's fixed per-row
  work costs more than it saves.

``firstfit`` launches the kernel for CUDA tensors and takes the plain version
for CPU tensors — for those only: on a CUDA tensor it launches or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, cost

LANES = (1, 2, 4, 8, 16, 32)     # lanes per row compiled into the library
WINDOWS = (2, 8, 16)             # register-resident forbidden words
# Rows of at most this many ids take the one-row-at-a-time kernels of
# firstfit, detect_recolor and twohop_detect_recolor (design "direct"): at
# the meshes' W 8 and 14 they took less device time on an H100 than the
# staged pass, which took less at W 26, 44 and 512.
DIRECT_MAX_W = 16
DESIGNS = ("vec16", "direct")   # the C entry points' design ids (B1, B2)

# core.bitset and the plain versions (kernels.ref) are imported where they
# are used: both import the core package, whose engines import the wrappers,
# which import this module's names, so it imports nothing of core itself


def n_words(C: int) -> int:
    from repro_torch.core import bitset
    return bitset.n_words(C)


def design(W: int, aligned: bool = True) -> str:
    """The kernel of a ``firstfit`` or ``detect_recolor`` call on the card:
    the staged pass with 16-B copies (``"vec16"``) for rows of more than
    ``DIRECT_MAX_W`` ids that are whole 16-B chunks of a 16-B aligned table
    (``aligned``), ``"direct"`` for every other shape."""
    if W > DIRECT_MAX_W and W % 4 == 0 and aligned:
        return "vec16"
    return "direct"


def default_lanes(W: int, aligned: bool = True) -> int:
    """Lanes per row: 8 for the staged pass — more rows in flight beat
    wider rows (measured on an H100 at W 44 and 512); the direct design's
    (one slot a lane, a warp at most) elsewhere."""
    return 8 if design(W, aligned) == "vec16" else pick_lanes(W)


def pick_lanes(W: int) -> int:
    """Smallest compiled group size that covers a row of W slots in one
    stride (a warp at most)."""
    return next((g for g in LANES if g >= W), LANES[-1])


def pick_window(C: int) -> int:
    """Smallest compiled window that holds all ``n_words(C)`` words; the
    widest one (swept repeatedly by the kernel) for larger caps."""
    nW = n_words(C)
    return next((w for w in WINDOWS if w >= nW), WINDOWS[-1])


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device, *,
                 views: bool = False) -> None:
    """Type, device, dtype and shape of a kernel input, and its layout:
    contiguous, or with ``views`` any view whose last dimension is
    contiguous and whose other strides and address are 16-byte multiples
    (what a TMA tensor map reads)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor "
                        f"(got {type(t).__name__})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if views:
        outer = [st * t.element_size() for n, st in
                 zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
        if t.stride(-1) != 1 or any(st % 16 for st in outer) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be contiguous in its last dimension, with its "
                f"other strides and its address 16-byte multiples (got "
                f"strides {tuple(t.stride())})")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_common(ell, colors, C, forb0, lanes, window):
    """Checks shared by both wrappers; returns (R, W, n, lanes, window)."""
    if not isinstance(ell, torch.Tensor) or ell.dim() != 2:
        raise ValueError("ell must be a 2-D tensor (R, W)")
    R, W = ell.shape
    if R < 1 or W < 1:
        raise ValueError(f"ell must have R >= 1 and W >= 1 (got {R}x{W})")
    if int(C) < 1:
        raise ValueError(f"C must be >= 1 (got {C})")
    device = ell.device
    check_tensor("ell", ell, torch.int32, (R, W), device)
    if not isinstance(colors, torch.Tensor) or colors.dim() != 1 \
            or colors.shape[0] < 1:
        raise ValueError("colors must be a non-empty 1-D tensor (n,)")
    n = colors.shape[0]
    check_tensor("colors", colors, torch.int32, (n,), device)
    if forb0 is not None:
        check_tensor("forb0", forb0, torch.int32, (R, n_words(C)), device)
    lanes = pick_lanes(W) if lanes is None else int(lanes)
    window = pick_window(C) if window is None else int(window)
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES} (got {lanes})")
    if window not in WINDOWS:
        raise ValueError(f"window must be one of {WINDOWS} (got {window})")
    return R, W, n, lanes, window


def check_row_ids(row_ids, device) -> int:
    """Checks a (R,) int32 row-id vector; returns R."""
    if not isinstance(row_ids, torch.Tensor) or row_ids.dim() != 1 \
            or row_ids.shape[0] < 1:
        raise ValueError("row_ids must be a non-empty 1-D tensor (R,)")
    R = row_ids.shape[0]
    check_tensor("row_ids", row_ids, torch.int32, (R,), device)
    return R


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed "
                           f"(cudaError {err})")


def count_launch(wrapper, route: str, counter: str = "launches") -> None:
    """One launch of ``wrapper``'s kernel, on the design ``route``: in
    ``wrapper.<counter>`` and ``wrapper.<counter>_<route>``."""
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    setattr(wrapper, f"{counter}_{route}",
            getattr(wrapper, f"{counter}_{route}") + 1)


def firstfit(ell, colors, C: int, forb0=None, *, lanes: Optional[int] = None,
             window: Optional[int] = None, route: Optional[str] = None):
    """First-fit colours for every ELL row.

    ell (R, W) int32 (FILL = -1), colors (n,) int32, optional forb0
    (R, n_words(C)) int32 OR-ed into the forbidden words.  Returns
    (mex (R,) int32, overflow (R,) bool).  ``lanes`` / ``window`` override
    the kernel's launch shape and ``route`` its design (``design``'s by
    default; tuning, tests and same-run comparisons: the result depends on
    none of them).
    """
    lanes_given = lanes is not None
    R, W, n, lanes, window = check_common(ell, colors, C, forb0, lanes,
                                          window)
    if route is not None and route not in DESIGNS:
        raise ValueError(f"route must be one of {DESIGNS} (got {route!r})")
    aligned = ell.data_ptr() % 16 == 0
    if route == "vec16" and (W % 4 or not aligned):
        raise ValueError(f"the vec16 design needs W % 4 == 0 and a 16-B "
                         f"aligned ell (got W={W})")
    if not cost.on_card(ell):
        from repro_torch.kernels import ref
        return ref.firstfit_ref(ell, colors, C, forb0=forb0)
    if cost.listening() or ell.device.type == "meta":
        cost.record_kernel("firstfit", 0, cost.firstfit_bytes(
            cost.gather_bytes_bound(R, W, n, own=False), R,
            n_words(C), forb0 is not None), (ell, colors))
    if ell.device.type == "meta":        # the dry run: the outputs' shapes
        return (torch.empty((R,), dtype=torch.int32, device=ell.device),
                torch.empty((R,), dtype=torch.bool, device=ell.device))
    route = design(W, aligned) if route is None else route
    if not lanes_given and route == "vec16":
        lanes = default_lanes(W, aligned)
    lib = _build.library()
    mex = torch.empty((R,), dtype=torch.int32, device=ell.device)
    ovf = torch.empty((R,), dtype=torch.bool, device=ell.device)
    with torch.cuda.device(ell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coloring_firstfit(
            ptr(ell), ptr(colors), ptr(forb0), ptr(mex), ptr(ovf),
            R, W, n, int(C), lanes, window, DESIGNS.index(route), stream)
    check_launch(f"firstfit ({route})", err)
    count_launch(firstfit, route)
    return mex, ovf


firstfit.launches = 0
firstfit.launches_vec16 = 0
firstfit.launches_direct = 0
