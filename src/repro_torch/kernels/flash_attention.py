"""Blockwise-softmax (flash) attention, forward: CUDA kernels + plain version.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (body ``_flash_kernel``): q (B, Hq, Lq, D), k and v
(B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's type; GQA (query head h reads KV
head h // (Hq // Hkv)), causal with the decode offset Lk - Lq, running max
and sum with f32 accumulation, p cast to v's type before P.V, output
acc / max(l, 1e-30).  The entry point is ``attn_flash_forward`` in
``csrc/flash_attention.cu``; the plain PyTorch version of the same function
is ``flash_attention_ref`` (``kernels/ref.py``).

Unlike the TPU kernel, any Lq, Lk >= 1 runs (the kernels mask their ragged
tiles: serving prompts are no multiple of a tile).  ``causal`` with
Lk < Lq is refused: there the first Lq - Lk rows see no key at all, and the
TPU kernel (a uniform average over its -1e30 scores) and the plain version
(NaN) disagree about them.

Two designs on the card, chosen by dtype and head dim (``design``):

* ``"sm90"`` — every bfloat16 call with D in {64, 80, 96, 128}:
  ``csrc/flash_attention_sm90.cu``, wgmma on the tensor cores, TMA loads
  of 128-key tiles into a ring of stages, a producer warp and two consumer
  warpgroups (see the note there).  D 80 (qwen3-32b's head dim) and D 96
  (minicpm3-4b's MLA head dim 64 + 32) add a tail panel of 16 / 32
  columns to the 64-column panels.  It reads q, k and v through tensor
  maps over their own strides: any view whose last dimension is contiguous
  and whose other strides and address are 16-byte multiples runs without a
  copy (the serving prefill's (B, L, H, D)-ordered projections, for one).
* ``"fma"`` — float32 at every D, and bfloat16 with D in {12, 16, 32}:
  the CUDA-core kernel of ``csrc/flash_attention.cu`` (wgmma on float32
  is TF32, which would break the float32 tolerance; D 12 / 16 / 32 are the
  smoke configs' head dims, narrower than one of the sm90 design's
  64-column panels).  It reads contiguous rows: the wrapper copies a
  strided view first.  D 12 (the MLA head dim 8 + 4 of minicpm3-4b's
  smoke config) is no multiple of the kernel's 16-column thread grid: the
  wrapper zero-pads q, k and v to 16 columns, passes the scale
  1 / sqrt(12), and slices the output back to 12.  The zero columns add
  exact zeros to every score, and the padded output columns are zeros: the
  same function, one launch of the kernel.

Bound on the card: operations at prefill shapes, 4 * B * Hq * Lq * Lk * D
FLOPs (about half of it when causal) against the card's bf16 tensor-core
rate.

``flash_attention`` launches a kernel for CUDA tensors, returns an empty
output of the kernel's shape for meta tensors (the dry run: the call's
work goes to ``kernels/cost.py``) and takes the plain version for CPU
tensors — for those only: on a CUDA tensor it launches or
raises (no fallback from one design to the other either).  The kernels are
forward only: on a CUDA tensor, under grad mode with an input that
requires grad, the wrapper raises rather than return a tensor with no
gradient (training takes ``models.layers.chunked_attention``).
``flash_attention.launches`` counts the launches, ``launches_sm90`` and
``launches_fma`` those of each design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.firstfit import check_launch, check_tensor, ptr
# the plain version, as a module attribute (see kernels/firstfit.py)
from repro_torch.kernels import ref

HEAD_DIMS = (12, 16, 32, 64, 80, 96, 128)    # D 12 is padded to 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = ("fma", "sm90")                # the C entry point's design ids
SM90_HEAD_DIMS = (64, 80, 96, 128)


def design(dtype, D: int) -> str:
    """The kernel that serves a call on the card: ``"sm90"`` for bfloat16
    with D in {64, 80, 96, 128}, else ``"fma"``."""
    return "sm90" if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS \
        else "fma"


def check_attention(q, k, v, causal: bool):
    """Checks shared by the wrapper and ``ops.attention``; returns the
    tensors the kernel reads (q, k, v, or at D 12 their zero-padded
    copies, whose layout is the one checked) and (B, Hq, Hkv, Lq, Lk,
    D)."""
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
    if D == 12:     # zero columns: exact zeros in every q . k and p . v
        q, k, v = (torch.nn.functional.pad(t, (0, 4)) for t in (q, k, v))
    Dk = q.shape[-1]
    check_tensor("q", q, q.dtype, (B, Hq, Lq, Dk), q.device, views=True)
    check_tensor("k", k, q.dtype, (B, Hkv, Lk, Dk), q.device, views=True)
    check_tensor("v", v, q.dtype, (B, Hkv, Lk, Dk), q.device, views=True)
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must be <= 65535 (grid limit)")
    return (q, k, v), (B, Hq, Hkv, Lq, Lk, D)


def row_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) strides in elements of a (B, H, L, D) tensor; a
    dimension of size 1 gets the stride of the dimension inside it times
    that one's size (its own stride is never used, and may be anything,
    where a tensor map wants a positive multiple of 16 bytes)."""
    B, H, L, D = t.shape
    sb, sh, sl, _ = t.stride()
    sl = D if L == 1 else sl
    sh = sl * L if H == 1 else sh
    sb = sh * H if B == 1 else sb
    return sb, sh, sl


def flash_attention(q, k, v, *, causal: bool = True):
    """Forward attention; q (B, Hq, Lq, D), k / v (B, Hkv, Lk, D), one type
    (float32 or bfloat16), each contiguous or a view that ``check_tensor``
    admits (last dimension contiguous, 16-byte strides; any layout at
    D 12, which is padded into new tensors).  Returns a contiguous (B, Hq,
    Lq, D) in q's type.  The scale is 1 / sqrt(D), as in the reference."""
    (qk, kk, vk), (B, Hq, Hkv, Lq, Lk, D) = check_attention(q, k, v, causal)
    if not cost.on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    q, k, v = qk, kk, vk
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is a forward-only kernel: its inputs require "
            "grad under grad mode, and its output would carry no gradient "
            "(train through models.layers.chunked_attention, or call it "
            "under torch.no_grad)")
    if cost.listening() or q.device.type == "meta":
        cost.record_kernel("flash_attention", *cost.attention_work(
            B, Hq, Hkv, Lq, Lk, D, causal, q.element_size()), (q, k, v))
    if q.device.type == "meta":          # the dry run: the output's shape
        return torch.empty((B, Hq, Lq, D), dtype=q.dtype, device=q.device)
    route = design(q.dtype, D)
    Dk = q.shape[-1]
    if route == "fma":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = _build.library()
    out = torch.empty((B, Hq, Lq, Dk), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attn_flash_forward(
            ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Lq, Lk, Dk,
            int(bool(causal)), DTYPES[q.dtype], DESIGNS.index(route),
            *row_strides(q), *row_strides(k), *row_strides(v),
            1.0 / (D ** 0.5), stream)
    check_launch(f"flash_attention ({route})", err)
    flash_attention.launches += 1
    if route == "sm90":
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_fma += 1
    return out if Dk == D else out[..., :D].contiguous()


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_fma = 0
