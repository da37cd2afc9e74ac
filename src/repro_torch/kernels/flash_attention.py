"""Blockwise-softmax (flash) attention, forward: CUDA kernel + plain version.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (body ``_flash_kernel``): q (B, Hq, Lq, D), k and v
(B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's type; GQA (query head h reads KV
head h // (Hq // Hkv)), causal with the decode offset Lk - Lq, running max
and sum with f32 accumulation, p cast to v's type before P.V, output
acc / max(l, 1e-30).  The kernel is ``attn_flash_forward`` in
``csrc/flash_attention.cu``; the plain PyTorch version of the same function
is ``flash_attention_ref`` (``kernels/ref.py``).

Unlike the TPU kernel, any Lq, Lk >= 1 runs (the kernel masks its ragged
tiles: serving prompts are no multiple of a tile).  ``causal`` with
Lk < Lq is refused: there the first Lq - Lk rows see no key at all, and the
TPU kernel (a uniform average over its -1e30 scores) and the plain version
(NaN) disagree about them.

Bound on the card: operations at prefill shapes, 4 * B * Hq * Lq * Lk * D
FLOPs (about half of it when causal) against the card's bf16 tensor-core
rate; the kernel is the simple f32-FMA design and leaves most of that rate
unused (see the note in ``csrc/flash_attention.cu``).

``flash_attention`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors — for those only: on a CUDA tensor it
launches or raises.  ``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.firstfit import check_launch, check_tensor, ptr
# the plain version, as a module attribute (see kernels/firstfit.py)
from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 128)            # compiled into the library
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_attention(q, k, v, causal: bool):
    """Checks shared by the wrapper and ``ops.attention``; returns
    (B, Hq, Hkv, Lq, Lk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, H, L, D)")
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    if min(B, Hq, Hkv, Lq, Lk) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16 (got {q.dtype})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if causal and Lk < Lq:
        raise ValueError(
            f"causal attention needs Lk >= Lq (got Lq={Lq}, Lk={Lk}): the "
            f"first {Lq - Lk} query rows would see no key")
    check_tensor("q", q, q.dtype, (B, Hq, Lq, D), q.device)
    check_tensor("k", k, q.dtype, (B, Hkv, Lk, D), q.device)
    check_tensor("v", v, q.dtype, (B, Hkv, Lk, D), q.device)
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must be <= 65535 (grid limit)")
    return B, Hq, Hkv, Lq, Lk, D


def flash_attention(q, k, v, *, causal: bool = True):
    """Forward attention; q (B, Hq, Lq, D), k / v (B, Hkv, Lk, D), one type
    (float32 or bfloat16), contiguous.  Returns (B, Hq, Lq, D) in q's type.
    The scale is 1 / sqrt(D), as in the reference."""
    B, Hq, Hkv, Lq, Lk, D = check_attention(q, k, v, causal)
    if q.device.type != "cuda":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attn_flash_forward(
            ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Lq, Lk, D,
            int(bool(causal)), DTYPES[q.dtype], 1.0 / (D ** 0.5), stream)
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
