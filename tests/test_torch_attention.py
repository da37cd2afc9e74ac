"""Port vs reference: the plain PyTorch version of the flash-attention kernel
(B5), ``ops.attention`` and the plain attention of the model layer.

The port's ``flash_attention_ref``, the wrapper ``flash_attention`` and
``ops.attention`` on CPU tensors are held against the reference's jnp
``flash_attention_ref`` and its Pallas kernel in interpret mode, on the
shapes of ``tests/test_kernels.py`` (float32, tolerance 2e-5, that file's:
the same float32 softmax computed in another order).  Ragged lengths, which
the Pallas kernel does not admit, are held against the jnp ref and the
reference's ``chunked_attention`` (the serving path's plain attention).

The wrapper's routing rule (dtype and head dim -> design) and its input
checks (strided views with a contiguous last dimension and 16-byte strides
are admitted, others refused) are tested here on CPU tensors; strided views
go through the plain version and are held against the reference.

The CUDA kernels have no CPU mode: the ``cuda``-marked cases at the end
hold them against the plain version on a GPU, as ``chip_smoke.py`` does —
the sm90 design at the edges of its tiles (128 query rows, 64 / 128 keys)
among them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (design, flash_attention,
                                                 row_strides)
from repro_torch.models import layers as TL
from repro_torch.obs import metrics as obs_metrics

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's chunked attention, jitted (eager jnp compiles op by op)
_j_chunked = jax.jit(JL.chunked_attention,
                     static_argnames=("causal", "q_offset", "chunk_q",
                                      "chunk_k"))


def _qkv(seed, B, Hq, Hkv, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32))


def _port_routes(q, k, v, causal):
    """The three CPU routes of the port to the plain version."""
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return {"flash_attention_ref": ref.flash_attention_ref(*t, causal=causal),
            "flash_attention (wrapper, CPU)": flash_attention(*t,
                                                              causal=causal),
            "ops.attention": ops.attention(*t, causal=causal)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D", [
    (1, 4, 4, 128, 128, 64),
    (2, 8, 2, 128, 256, 64),    # GQA + decode-style Lk > Lq
    (1, 2, 1, 256, 256, 128),   # MQA
])
def test_plain_matches_reference_kernel_and_ref(causal, B, Hq, Hkv, Lq, Lk,
                                                D):
    q, k, v = _qkv(Lq + D, B, Hq, Hkv, Lq, Lk, D)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_kernel = np.asarray(j_flash(jq, jk, jv, causal=causal,
                                     interpret=True))
    want_ref = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    for name, got in _port_routes(q, k, v, causal).items():
        assert got.dtype == torch.float32 and got.shape == (B, Hq, Lq, D)
        np.testing.assert_allclose(got.numpy(), want_kernel, err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D", [
    (1, 16, 8, 17, 17, 128),    # qwen3's heads, a serving-like prompt
    (1, 4, 2, 1, 1, 16),        # one token
    (2, 4, 2, 45, 70, 32),      # ragged, Lk > Lq
    (1, 2, 2, 100, 100, 64),    # ragged across two chunks of 64
])
def test_plain_matches_reference_on_ragged_lengths(causal, B, Hq, Hkv, Lq,
                                                   Lk, D):
    q, k, v = _qkv(Lq * 7 + Lk, B, Hq, Hkv, Lq, Lk, D)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    for name, got in _port_routes(q, k, v, causal).items():
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
    # the model layer's plain attention (the CPU route of the prefill),
    # chunked as the smoke config chunks it, against the reference's
    got = TL.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal, q_offset=Lk - Lq, chunk_q=64,
                               chunk_k=64)
    want_c = np.asarray(_j_chunked(jq, jk, jv, causal=causal,
                                   q_offset=Lk - Lq, chunk_q=64, chunk_k=64))
    np.testing.assert_allclose(got.numpy(), want_c, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(4)
    B, Hq, Hkv, S, D = 3, 4, 2, 20, 16
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    length = np.array([5, 19, 0], np.int32)
    want = JL.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               length=jnp.asarray(length))
    got = TL.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              length=torch.from_numpy(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refusals():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 2, 1, 8, 4, 16))
    # causal with Lk < Lq: the first rows would see no key
    with pytest.raises(ValueError, match="Lk >= Lq"):
        ops.attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Lk >= Lq"):
        flash_attention(q, k, v, causal=True)
    ops.attention(q, k, v, causal=False)        # fine without the mask
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(
            1, 3, 1, 1))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                        v[..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Hq,Hkv", [(80, 8, 1), (96, 8, 8)])
def test_head_dim_80_matches_reference(D, Hq, Hkv, causal):
    """qwen3-32b's head dim 80 (GQA 64 / 8 cut to 8 / 1) and minicpm3-4b's
    MLA head dim 96 (40 / 40 heads cut to 8 / 8): the wrapper admits both
    and, on CPU tensors, gives the reference's ``flash_attention_ref`` at a
    ragged length."""
    q, k, v = _qkv(D, 1, Hq, Hkv, 45, 70, D)
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    for name, got in _port_routes(q, k, v, causal).items():
        assert got.shape == (1, Hq, 45, D)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


def test_dispatch_is_counted_on_the_cpu():
    obs_metrics.reset()
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 2, 1, 8, 8, 16))
    before = flash_attention.launches
    ops.attention(q, k, v)
    ops.attention(q, k, v, backend="torch")
    assert flash_attention.launches == before        # no kernel on a CPU
    got = obs_metrics.counters_matching("kernels.dispatch")
    assert got == {"kernels.dispatch{backend=torch,kernel=attention}": 2}
    obs_metrics.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, dtype, causal):
    dt = getattr(torch, dtype)
    for B, Hq, Hkv, Lq, Lk, D in [(2, 8, 2, 128, 256, 64),
                                  (1, 16, 8, 300, 300, 128),
                                  (1, 4, 2, 1, 7, 16)]:
        q, k, v = (torch.from_numpy(x).to(cuda_device).to(dt)
                   for x in _qkv(Lq, B, Hq, Hkv, Lq, Lk, D))
        before = flash_attention.launches
        got = ops.attention(q, k, v, causal=causal)
        assert flash_attention.launches == before + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        # bfloat16: p is rounded to bf16 before P.V in the kernel, not in
        # the plain version, and both round the output (see PERF.md)
        tol = TOL if dt == torch.float32 else dict(rtol=1e-2, atol=2e-2)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,Hq,Hkv", [(80, 64, 8), (96, 40, 40)])
def test_cuda_head_dims_80_96(cuda_device, D, Hq, Hkv, dtype):
    """qwen3-32b's heads at D 80 and minicpm3-4b's MLA heads at D 96:
    bfloat16 on the sm90 design (its tail panel), float32 on fma."""
    dt = getattr(torch, dtype)
    route = "sm90" if dt == torch.bfloat16 else "fma"
    assert design(dt, D) == route
    for causal in (True, False):
        q, k, v = (torch.from_numpy(x).to(cuda_device).to(dt)
                   for x in _qkv(7, 1, Hq, Hkv, 129, 257, D))
        before = getattr(flash_attention, f"launches_{route}")
        got = ops.attention(q, k, v, causal=causal)
        assert getattr(flash_attention, f"launches_{route}") == before + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        tol = TOL if dt == torch.float32 else dict(rtol=1e-2, atol=2e-2)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_inputs_that_require_grad(cuda_device):
    """A forward-only kernel never returns a tensor that silently drops the
    gradient: under grad mode it raises, under no_grad it runs."""
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(3, 1, 4, 2, 64, 64, 64))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.attention(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        assert ops.attention(q, k, v, causal=True).shape == q.shape


# --------------------------------------------------------------------------
# the routing rule and the input checks of the wrapper (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,D,want", [
    ("bfloat16", 64, "sm90"), ("bfloat16", 128, "sm90"),
    ("bfloat16", 16, "fma"), ("bfloat16", 32, "fma"),
    ("float32", 16, "fma"), ("float32", 32, "fma"),
    ("float32", 64, "fma"), ("float32", 128, "fma"),
    ("bfloat16", 80, "sm90"), ("float32", 80, "fma"),
    ("bfloat16", 96, "sm90"), ("float32", 96, "fma"),
])
def test_design_by_dtype_and_head_dim(dtype, D, want):
    # bfloat16 at D 64 / 80 / 96 / 128 on the tensor cores; float32 stays
    # on the CUDA-core kernel (TF32 would miss the float32 tolerance)
    assert design(getattr(torch, dtype), D) == want


def _bl_hd(x):
    """A (B, H, L, D) view of a (B, L, H, D) array: the serving prefill's
    layout of q, k and v."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                            ).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D", [
    (1, 16, 8, 17, 17, 128),
    (2, 4, 2, 45, 70, 32),
    (2, 4, 1, 33, 33, 64),
])
def test_strided_views_match_reference(causal, B, Hq, Hkv, Lq, Lk, D):
    """Views in the prefill's (B, L, H, D) layout, no copy: admitted by
    every route and equal to the reference."""
    q, k, v = _qkv(Lq * 3 + Lk + D, B, Hq, Hkv, Lq, Lk, D)
    views = [_bl_hd(x) for x in (q, k, v)]
    assert not views[0].is_contiguous() or Hq == 1
    want = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    for name, got in (
            ("flash_attention", flash_attention(*views, causal=causal)),
            ("ops.attention", ops.attention(*views, causal=causal))):
        assert got.shape == (B, Hq, Lq, D)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


def test_strided_view_checks():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 2, 8, 8, 16))
    # a slice along the head dim: last dimension contiguous, rows 32
    # elements (128 bytes) apart -> admitted
    wide = torch.from_numpy(_qkv(6, 1, 2, 2, 8, 8, 32)[0])
    got = flash_attention(wide[..., :16], k, v, causal=False)
    want = ref.flash_attention_ref(wide[..., :16].contiguous(), k, v,
                                   causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # rows 17 float32 (68 bytes) apart: no tensor map can read it
    odd = torch.zeros((1, 2, 8, 17))[..., :16]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(odd, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        ops.attention(q, odd, v, causal=False)
    # an address 4 bytes past a 16-byte boundary
    flat = torch.zeros(q.numel() + 1)
    shifted = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k, v)
    # the last dimension strided
    with pytest.raises(ValueError, match="contiguous in its last"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 4, 8, 64), (2048, 512, 64, 1), (2048, 512, 64)),     # contiguous
    ((2, 4, 8, 64), (2048, 64, 256, 1), (2048, 64, 256)),     # (B, L, H, D)
    ((1, 4, 8, 64), (7, 64, 256, 1), (4 * 64, 64, 256)),      # B = 1
    ((2, 1, 8, 64), (512, 3, 64, 1), (512, 512, 64)),         # one head
    ((2, 4, 1, 64), (256, 64, 5, 1), (256, 64, 64)),          # one row
])
def test_row_strides_of_size_one_dims(shape, strides, want):
    """A dimension of size 1 gets the stride of the dimension inside it
    times that one's size (a tensor map wants a positive multiple of 16
    bytes; the value is never used)."""
    t = torch.empty(0).set_(torch.empty(4096).untyped_storage(), 0, shape,
                            strides)
    assert row_strides(t) == want


def test_prefill_attention_on_views_matches_reference():
    """The model layer hands the (B, L, H, D)-ordered projections to the
    attention as views (no copy); on a CPU its chunked plain attention
    runs, equal to the reference's."""
    q, k, v = _qkv(9, 1, 4, 2, 40, 40, 32)
    got = TL.prefill_attention(*(_bl_hd(x) for x in (q, k, v)), causal=True,
                               chunk_q=16, chunk_k=16)
    want = np.asarray(_j_chunked(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal=True, q_offset=0, chunk_q=16,
                                 chunk_k=16))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------
# the sm90 design on the card: the edges of its tiles
# --------------------------------------------------------------------------

# (B, Hq, Hkv, Lq, Lk, D): L across the 64 / 128-row tile edges; Lk > Lq
# with a ragged offset at GQA ratios 1, 2 and 8; B = 2; D 64 and 128, and
# D 80 / 96 (the tail panel) at qwen3-32b's and minicpm3-4b's head ratios
SM90_EDGES = [(1, 16, 8, L, L, 128)
              for L in (1, 63, 64, 65, 127, 128, 129, 255, 257, 2049)]
SM90_EDGES += [(2, 8, 8, 129, 257, 64), (2, 8, 4, 65, 300, 128),
               (2, 16, 2, 255, 383, 64), (2, 8, 1, 257, 257, 128),
               (2, 16, 2, 63, 191, 128), (2, 4, 4, 200, 200, 64)]
SM90_EDGES += [(1, 16, 2, L, L, D) for D in (80, 96) for L in (127, 128, 129)]
SM90_EDGES += [(2, 16, 2, 129, 257, 80), (2, 8, 8, 65, 300, 96),
               (2, 8, 1, 255, 383, 96), (2, 8, 8, 63, 191, 80)]


def _row_rel_err(got, want):
    """Per query row, the RMS of the error over the RMS of the plain
    output; the largest.  Scales with the row, where a late row of a long
    causal attention averages many keys and its outputs are small."""
    g, w = got.double(), want.double()
    return float(((g - w).pow(2).mean(-1).sqrt()
                  / w.pow(2).mean(-1).sqrt().clamp_min(1e-30)).max())


# bfloat16: below one bfloat16 step of every element (2^-7 relative) even if
# each rounded the other way; a wrong or stale key tile moves a row by its
# share of the keys
ROW_TOL_BF16 = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D", SM90_EDGES)
def test_cuda_sm90_tile_edges(cuda_device, B, Hq, Hkv, Lq, Lk, D, causal):
    q, k, v = (torch.from_numpy(x).to(cuda_device).to(torch.bfloat16)
               for x in _qkv(Lq * 5 + Lk, B, Hq, Hkv, Lq, Lk, D))
    before = flash_attention.launches_sm90
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_sm90 == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=1e-2,
                               atol=2e-2)
    assert _row_rel_err(got, want) <= ROW_TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 80, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_strided_views(cuda_device, dtype, D):
    """The prefill's (B, L, H, D) views: read in place by the sm90 design
    (D 80 / 96 through its tail panel's maps too), copied by the wrapper
    for the CUDA-core design (float32)."""
    dt = getattr(torch, dtype)
    q, k, v = (_bl_hd(x).to(cuda_device).to(dt)
               for x in _qkv(11, 2, 16, 8, 300, 300, D))
    before = dict(sm90=flash_attention.launches_sm90,
                  fma=flash_attention.launches_fma)
    got = ops.attention(q, k, v, causal=True)
    route = design(dt, D)
    assert getattr(flash_attention, f"launches_{route}") == before[route] + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = TOL if dt == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def test_sm90_ab_variant_edits_match_the_source():
    """``benchmarks/attention_sm90_ab.py`` builds its variants by editing a
    copy of the sm90 source: each edit must match it exactly once, or the
    variant would silently be the committed kernel."""
    from repro_torch.benchmarks import attention_sm90_ab as ab
    text = open(ab.CU).read()
    assert "base" in ab.VARIANTS and "padded_128" in ab.VARIANTS
    for name, edits in ab.VARIANTS.items():
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert new not in text, (name, new)
