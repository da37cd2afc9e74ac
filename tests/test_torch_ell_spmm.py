"""Port vs reference: the plain PyTorch version of the ELL-aggregation kernel
(B4) and ``ops.ell_aggregate``.

The port's ``ell_spmm_ref``, the wrapper ``ell_spmm`` and
``ops.ell_aggregate`` on CPU tensors are held against the reference's jnp
``ell_spmm_ref`` and its Pallas kernel in interpret mode, on the shapes of
``tests/test_kernels.py`` with that file's tolerances (float32: 1e-5, the
same sums in another order; bfloat16: rtol 2e-2 / atol 1e-1 — the port sums
in float32 and rounds once, the reference sums in bfloat16).  The traps:
all-FILL rows (0 for every op), ids >= n (clamped to row n - 1, never out of
bounds), ragged R and d.

The CUDA kernel has no CPU mode: the ``cuda``-marked case at the end holds
it against the plain version on a GPU, as ``chip_smoke.py`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ell_spmm import ell_spmm as j_ell_spmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ell_spmm import (ell_spmm, gather_floor_bytes,
                                          pick_lanes, pick_vec)

torch.set_num_threads(1)

OPS = ("sum", "mean", "max")


def _tol(dtype):
    return (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
            else dict(rtol=2e-2, atol=1e-1))


def _case(seed, R, W, n, d, fill=0.3, hi=None):
    rng = np.random.default_rng(seed)
    ell = rng.integers(0, n if hi is None else hi, size=(R, W)).astype(
        np.int32)
    ell[rng.random((R, W)) < fill] = -1
    return ell, rng.standard_normal((n, d)).astype(np.float32)


def _both(ell, feats, dtype):
    """The same inputs for both packages: (jnp pair, torch pair)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    return ((jnp.asarray(ell), jnp.asarray(feats).astype(jd)),
            (torch.from_numpy(ell), torch.from_numpy(feats).to(td)))


def _port_routes(ell, feats, op):
    return {"ell_spmm_ref": ref.ell_spmm_ref(ell, feats, op),
            "ell_spmm (wrapper, CPU)": ell_spmm(ell, feats, op),
            "ops.ell_aggregate": ops.ell_aggregate(ell, feats, op)}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("R,W,n,d,dtype", [
    (128, 8, 256, 128, "float32"),
    (256, 16, 1024, 256, "float32"),
    (128, 4, 512, 128, "bfloat16"),
])
def test_plain_matches_reference_kernel_and_ref(op, R, W, n, d, dtype):
    ell, feats = _case(R + d, R, W, n, d)
    (je, jf), (te, tf) = _both(ell, feats, dtype)
    want_kernel = np.asarray(j_ell_spmm(je, jf, op=op, interpret=True),
                             np.float32)
    want_ref = np.asarray(jref.ell_spmm_ref(je, jf, op), np.float32)
    for name, got in _port_routes(te, tf, op).items():
        assert got.dtype == tf.dtype and got.shape == (R, d), name
        np.testing.assert_allclose(got.float().numpy(), want_kernel,
                                   err_msg=name, **_tol(dtype))
        np.testing.assert_allclose(got.float().numpy(), want_ref,
                                   err_msg=name, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_fill_rows_and_ids_past_n(dtype):
    """All-FILL rows give 0 for every op; ids >= n read row n - 1."""
    R, W, n, d = 128, 8, 64, 128
    ell, feats = _case(7, R, W, n, d, hi=n + 40)     # ~40 % of ids >= n
    ell[::5] = -1                                   # every fifth row empty
    assert (ell >= n).any()
    (je, jf), (te, tf) = _both(ell, feats, dtype)
    for op in OPS:
        want = np.asarray(j_ell_spmm(je, jf, op=op, interpret=True),
                          np.float32)
        np.testing.assert_allclose(
            np.asarray(jref.ell_spmm_ref(je, jf, op), np.float32), want,
            **_tol(dtype))
        for name, got in _port_routes(te, tf, op).items():
            got = got.float().numpy()
            assert np.isfinite(got).all(), name
            np.testing.assert_array_equal(got[::5], 0.0, err_msg=name)
            np.testing.assert_allclose(got, want, err_msg=name,
                                       **_tol(dtype))


@pytest.mark.parametrize("R,W,n,d", [(1000, 7, 300, 100), (77, 40, 50, 3),
                                     (5, 1, 5, 1), (33, 44, 4000, 100)])
def test_plain_matches_reference_on_ragged_shapes(R, W, n, d):
    """R and d that no Pallas block divides: the jnp ref is the oracle."""
    ell, feats = _case(R * d, R, W, n, d, hi=n + 2)
    for dtype in ("float32", "bfloat16"):
        (je, jf), (te, tf) = _both(ell, feats, dtype)
        for op in OPS:
            want = np.asarray(jref.ell_spmm_ref(je, jf, op), np.float32)
            for name, got in _port_routes(te, tf, op).items():
                np.testing.assert_allclose(got.float().numpy(), want,
                                           err_msg=f"{name} {op} {dtype}",
                                           **_tol(dtype))


def test_non_finite_max_is_zero():
    """max over only -inf features is 0; a NaN propagates to the max and
    becomes 0 too (where(isfinite(acc), acc, 0))."""
    feats = np.array([[-np.inf, 1.0], [np.nan, 2.0], [3.0, -np.inf]],
                     np.float32)
    ell = np.array([[0, -1], [0, 1], [2, 0]], np.int32)
    want = np.asarray(jref.ell_spmm_ref(jnp.asarray(ell), jnp.asarray(feats),
                                        "max"))
    got = ref.ell_spmm_ref(torch.from_numpy(ell), torch.from_numpy(feats),
                           "max")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[0.0, 1.0], [0.0, 2.0], [3.0, 1.0]])


def test_launch_shape_choice():
    f32 = torch.zeros((4, 100))
    assert pick_vec(100, f32, f32) == 4 and pick_lanes(100, 4) == 32
    assert pick_vec(3, f32, f32) == 1 and pick_lanes(3, 1) == 4
    b16 = torch.zeros((4, 100), dtype=torch.bfloat16)
    assert pick_vec(100, b16, b16) == 4
    assert pick_vec(256, b16, b16) == 8 and pick_lanes(256, 8) == 32
    # a view that starts 4 bytes in is aligned to no wider vector
    off = torch.zeros(401)[1:].reshape(4, 100)
    assert pick_vec(100, off, f32) == 1


@pytest.mark.parametrize("d,elem,want", [
    # f32, d 3: 12-B rows; row 2 ([24, 36)) straddles sectors 0 and 1
    (3, 4, 36 + 7 * 32 + 3 * 3 * 4),
    # bf16, d 12: 24-B rows; rows 1 ([24, 48)) and 2 ([48, 72)) straddle
    (12, 2, 36 + 8 * 32 + 3 * 12 * 2)])
def test_gather_floor_bytes_hand_counted(d, elem, want):
    """The gather floor of a 3 x 3 table over n = 4 feature rows: the
    table's 36 bytes, 32 bytes for each sector a live slot's row touches
    (FILL slots none; id 7 >= n reads row 3), and the (3, d) output."""
    ell = torch.tensor([[0, 2, -1], [-1, -1, -1], [7, 2, 1]],
                       dtype=torch.int32)
    # sectors per live slot: f32 d 3: 0 -> 1, 2 -> 2, 7 (row 3) -> 1,
    # 2 -> 2, 1 -> 1 (7); bf16 d 12: 1, 2, 1, 2, 2 (8)
    assert gather_floor_bytes(ell, 4, d, elem) == want


def test_refusals():
    ell = torch.zeros((4, 3), dtype=torch.int32)
    feats = torch.zeros((5, 8))
    with pytest.raises(ValueError, match="op must be"):
        ops.ell_aggregate(ell, feats, "min")
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.ell_aggregate(ell, feats, backend="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ell_spmm(ell, feats.double())
    with pytest.raises(TypeError, match="int32"):
        ell_spmm(ell.long(), feats)
    with pytest.raises(ValueError, match="non-empty"):
        ell_spmm(ell[:, :0].contiguous(), feats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    for R, W, n, d in [(256, 16, 1024, 256), (1000, 7, 300, 100),
                       (77, 40, 50, 3)]:
        ell, feats = _case(R + W, R, W, n, d, hi=n + 5)
        ell[::7] = -1
        te = torch.from_numpy(ell).to(cuda_device)
        tf = torch.from_numpy(feats).to(cuda_device).to(getattr(torch, dtype))
        for op in OPS:
            before = ell_spmm.launches
            got = ops.ell_aggregate(te, tf, op)
            assert ell_spmm.launches == before + 1
            want = ref.ell_spmm_ref(te, tf, op)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 3, 100, 128, 129, 300])
def test_cuda_kernel_shape_edges(cuda_device, d, dtype):
    """The kernel at its edges, within the stated tolerances: every lane
    count and vector width the wrapper picks for d (1 and 3: one element a
    load; 129: a second feature chunk; 300: three), rows of 1 id and around
    a warp's 32 (31, 32, 33; a second ballot of ids) and RMAT-ER's 44;
    all-FILL rows, ids >= n (row n - 1), and +-inf / NaN features under max
    (a non-finite result is 0)."""
    for W in (1, 31, 32, 33, 44):
        ell, feats = _case(d * 100 + W, 300, W, 200, d, fill=0.5, hi=205)
        ell[::7] = -1
        feats[3, 0], feats[4, 0], feats[5, -1] = np.inf, -np.inf, np.nan
        te = torch.from_numpy(ell).to(cuda_device)
        tf = torch.from_numpy(feats).to(cuda_device).to(getattr(torch, dtype))
        for op in OPS:
            before = ell_spmm.launches
            got = ops.ell_aggregate(te, tf, op)
            assert ell_spmm.launches == before + 1
            want = ref.ell_spmm_ref(te, tf, op)
            got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
            np.testing.assert_allclose(got, want, err_msg=f"W{W} {op}",
                                       equal_nan=True, **_tol(dtype))
            np.testing.assert_array_equal(got[::7], 0.0)
            if op == "max":
                assert np.isfinite(got).all()

