"""Meshes for the models, and the hardware constants of one NVIDIA H100 SXM
(the port's counterpart of the reference's ``launch/mesh.py``, which holds
TPU v5e numbers).

The meshes are ``core.mesh.Mesh``es over the axes the sharding rules name
(``launch/sharding.py``): ``data`` and ``model``, and ``pod`` in front of
them on the multi-pod mesh.  Functions, not module-level meshes: importing
this module touches no device.

The rates are NVIDIA's data sheet for the SXM part at its 700 W power
limit, dense (no sparsity); a card set to a lower limit runs slower under
load.
"""
from __future__ import annotations

import torch

from repro_torch.core.mesh import Mesh, make_mesh

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
ICI_BW = 450e9                  # bytes/s a direction, NVLink 4 (900 GB/s both)


def make_production_mesh(*, multi_pod: bool = False, device) -> Mesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``.  No host holds 256 or 512 cards,
    so every shard sits on ``device``, which must be given (``"cpu"`` in
    the tests: the rules and the placement at the production shape)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=torch.device(device))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over this host's CUDA devices, one shard a card,
    clamped as the reference clamps to the devices there are: ``data`` to
    the count, ``model`` to what is left.  Raises where there is no CUDA
    device (a mesh whose shards share one device: ``core.mesh.make_mesh``
    with ``device=``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_host_mesh needs a CUDA device and there is "
                           "none (core.mesh.make_mesh(..., device='cpu') "
                           "builds a mesh on the CPU)")
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh((data, model), ("data", "model"),
                     devices=[f"cuda:{i}" for i in range(data * model)])


def n_chips(mesh: Mesh) -> int:
    return mesh.size


def batch_axes(mesh: Mesh) -> tuple:
    """Axes a global-batch dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
