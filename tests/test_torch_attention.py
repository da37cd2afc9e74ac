"""Port vs reference: the plain PyTorch version of the flash-attention kernel
(B5), ``ops.attention`` and the plain attention of the model layer.

The port's ``flash_attention_ref``, the wrapper ``flash_attention`` and
``ops.attention`` on CPU tensors are held against the reference's jnp
``flash_attention_ref`` and its Pallas kernel in interpret mode, on the
shapes of ``tests/test_kernels.py`` (float32, tolerance 2e-5, that file's:
the same float32 softmax computed in another order).  Ragged lengths, which
the Pallas kernel does not admit, are held against the jnp ref and the
reference's ``chunked_attention`` (the serving path's plain attention).

The CUDA kernel has no CPU mode: the ``cuda``-marked case at the end holds
it against the plain version on a GPU, as ``chip_smoke.py`` does.
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
from repro_torch.kernels.flash_attention import flash_attention
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
