"""ELL neighbour aggregation (GNN message passing): CUDA kernel + plain
version.

Replaces the Pallas kernel ``src/repro/kernels/ell_spmm.py::ell_spmm`` (body
``_ell_spmm_kernel``): ``out[v] = op_j feats[ell[v, j]]`` for op in {sum,
mean, max} over an (R, W) int32 ELL table and (n, d) float32 or bfloat16
features; FILL (< 0) slots are ignored, an id >= n reads row n - 1 (the
reference's clipped gather), ``mean`` divides by max(count, 1), ``max`` maps
a non-finite result to 0, so an all-FILL row gives 0.  Sums run in float32
in ascending j and are rounded once.  The kernel is ``ell_spmm`` in
``csrc/ell_spmm.cu``; the plain PyTorch version is ``ell_spmm_ref``
(``kernels/ref.py``).

The reference holds an (n, block_feats) feature panel in VMEM and falls back
to jnp when that does not fit; the card reads the features from device
memory through L2 with no size limit, so there is no panel, no budget and no
fallback.  Any R, W, d >= 1 runs.

Bound on the card: bytes — the R * W * 4 bytes of the table, each distinct
feature row a live slot names, once, and the R * d output; one add or
compare per gathered value.  On a graph without locality the feature rows
miss L2 whatever the order, so ``gather_floor_bytes`` (the table, the 32-B
sectors of every live slot's row, the output) is the bytes a call really
moves.  The design keeps feature rows in flight: ``lanes`` lanes own a row
and read each feature row as consecutive vectors of ``vec`` elements; the
row's live ids, found by a ballot, are gathered four at a time a lane
before any is folded, in ascending j (see the note in
``csrc/ell_spmm.cu``).

``ell_spmm`` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors — for those only: on a CUDA tensor it launches or
raises.  ``ell_spmm.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.firstfit import check_launch, check_tensor, ptr
# the plain version, as a module attribute (see kernels/firstfit.py)
from repro_torch.kernels import ref

OPS = {"sum": 0, "mean": 1, "max": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LANES = (1, 2, 4, 8, 16, 32)             # lanes per row compiled in
SECTOR = 32                              # bytes of an L2 / DRAM sector


def gather_floor_bytes(ell: torch.Tensor, n: int, d: int,
                       elem_size: int) -> int:
    """Bytes an aggregation moves when no feature row is found in L2: the
    table (``R*W*4``), every 32-byte sector that each live slot's feature
    row spans (row ``min(id, n-1)`` of a 32-B aligned ``(n, d)`` table of
    ``elem_size``-byte values; a row that straddles a sector boundary costs
    the sectors it touches), and the ``(R, d)`` output.  Counted on the
    slots of this ``ell``, on its device."""
    R, W = ell.shape
    row_bytes = d * elem_size
    ids = ell[ell >= 0].clamp(max=n - 1).long()
    first = ids * row_bytes // SECTOR
    last = (ids * row_bytes + row_bytes - 1) // SECTOR
    sectors = int((last - first + 1).sum())
    return R * W * 4 + sectors * SECTOR + R * d * elem_size


def pick_vec(d: int, feats: torch.Tensor, out: torch.Tensor) -> int:
    """Widest vector (elements per load, at most 16 bytes) that divides d
    and to whose size both feature pointers are aligned."""
    size = feats.element_size()
    v = 16 // size
    while v > 1 and (d % v or feats.data_ptr() % (v * size)
                     or out.data_ptr() % (v * size)):
        v //= 2
    return v


def pick_lanes(d: int, vec: int) -> int:
    """Smallest compiled group that covers a feature row in one chunk of
    ``lanes * vec`` elements (a warp at most; wider rows take chunks)."""
    need = -(-d // vec)
    return next((g for g in LANES if g >= need), LANES[-1])


def check_spmm(ell, feats, op: str):
    """Checks shared by the wrapper and ``ops.ell_aggregate``; returns
    (R, W, n, d)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {tuple(OPS)} (got {op!r})")
    if not isinstance(ell, torch.Tensor) or ell.dim() != 2:
        raise ValueError("ell must be a 2-D tensor (R, W)")
    if not isinstance(feats, torch.Tensor) or feats.dim() != 2:
        raise ValueError("feats must be a 2-D tensor (n, d)")
    R, W = ell.shape
    n, d = feats.shape
    if min(R, W, n, d) < 1:
        raise ValueError(f"ell {R}x{W} and feats {n}x{d} must be non-empty")
    if feats.dtype not in DTYPES:
        raise TypeError(f"feats must be float32 or bfloat16 "
                        f"(got {feats.dtype})")
    check_tensor("ell", ell, torch.int32, (R, W), ell.device)
    check_tensor("feats", feats, feats.dtype, (n, d), ell.device)
    return R, W, n, d


def ell_spmm(ell, feats, op: str = "sum", *, lanes: Optional[int] = None):
    """Aggregate neighbour features over an ELL table: ell (R, W) int32,
    feats (n, d) float32 / bfloat16, both contiguous and on one device.
    Returns (R, d) in the feature type.  ``lanes`` overrides the group size
    (tests; the result does not depend on it)."""
    R, W, n, d = check_spmm(ell, feats, op)
    if not cost.on_card(ell):
        return ref.ell_spmm_ref(ell, feats, op)
    if cost.listening() or ell.device.type == "meta":
        cost.record_kernel("ell_spmm", 0, cost.ell_spmm_bytes(
            R, W, min(n, R * W), d, feats.element_size()), (ell, feats))
    if ell.device.type == "meta":        # the dry run: the output's shape
        return torch.empty((R, d), dtype=feats.dtype, device=feats.device)
    lib = _build.library()
    out = torch.empty((R, d), dtype=feats.dtype, device=feats.device)
    vec = pick_vec(d, feats, out)
    lanes = pick_lanes(d, vec) if lanes is None else int(lanes)
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES} (got {lanes})")
    with torch.cuda.device(ell.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ell_spmm(ptr(ell), ptr(feats), ptr(out), R, W, n, d,
                           OPS[op], DTYPES[feats.dtype], lanes, vec, stream)
    check_launch("ell_spmm", err)
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
