"""Port vs reference: every helper of ``core/bitset.py``.

Integer arithmetic on int32 words: the bar is bit-equality (tolerance
zero), including the int32 wraparound cases (bit 31, ``w + 1`` on
0x7FFFFFFF) that Python ints would get wrong.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jb
from repro_torch.core import bitset as tb

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

CAPS = [1, 4, 31, 32, 33, 64, 100, 256, 512]
SPECIAL = np.array([-1, 0, 0x7FFFFFFF, -0x80000000, 1, -2, 0x55555555,
                    -0x55555556, 0x0000FFFF, -0x10000], dtype=np.int64)


def _eq(t, j, name=""):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype, (name, t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j, err_msg=name)


def _words(rng, rows, C):
    """Random int32 words salted with the special patterns; the tail of the
    last word is left as it falls (helpers must cope)."""
    nW = jb.n_words(C)
    w = rng.integers(-2**31, 2**31, size=(rows, nW), dtype=np.int64)
    hit = rng.random((rows, nW)) < 0.5
    w[hit] = rng.choice(SPECIAL, size=int(hit.sum()))
    w[0, :] = -1                       # a saturated row
    w[1, :] = 0                        # an empty row
    return w.astype(np.int32)


def test_constants():
    assert tb.WORD == jb.WORD == 32 and tb.IMPLS == jb.IMPLS


@pytest.mark.parametrize("C", CAPS)
def test_n_words_tail_mask_init_words(C):
    assert tb.n_words(C) == jb.n_words(C)
    _eq(tb.tail_mask(C), jb.tail_mask(C), "tail_mask")
    _eq(tb.init_words(5, C), jb.init_words(5, C), "init_words")
    for impl in tb.IMPLS:
        assert tb.ws_bytes(77, C, impl) == jb.ws_bytes(77, C, impl)
        assert tb.ws_mb(77, C, impl) == jb.ws_mb(77, C, impl)
    with pytest.raises(ValueError):
        tb.ws_bytes(1, C, "sparse")


@pytest.mark.parametrize("C", CAPS)
def test_pack_from_nbrc_and_or_color(C):
    rng = np.random.default_rng(C)
    # colours below 0, inside and beyond the cap
    nbrc = rng.integers(-2, C + 3, size=(37, 9)).astype(np.int32)
    _eq(tb.pack_from_nbrc(torch.from_numpy(nbrc), C),
        jb.pack_from_nbrc(jnp.asarray(nbrc), C), "pack_from_nbrc")
    tf, jf = tb.init_words(37, C), jb.init_words(37, C)
    for j in range(nbrc.shape[1]):
        tf = tb.or_color(tf, torch.from_numpy(nbrc[:, j].copy()), C)
        jf = jb.or_color(jf, jnp.asarray(nbrc[:, j]), C)
    _eq(tf, jf, "or_color")
    _eq(tf, jb.pack_from_nbrc(jnp.asarray(nbrc), C), "or_color == pack")


def test_pack_from_nbrc_bit31_and_width_one():
    nbrc = np.array([[31], [63], [0], [-1]], np.int32)
    got = tb.pack_from_nbrc(torch.from_numpy(nbrc), 64)
    _eq(got, jb.pack_from_nbrc(jnp.asarray(nbrc), 64))
    assert got[0, 0].item() == -2**31 and got[1, 1].item() == -2**31


@pytest.mark.parametrize("C", CAPS)
def test_pack_dense_to_dense_roundtrip(C):
    rng = np.random.default_rng(100 + C)
    dense = (rng.random((23, C)) < 0.4).astype(np.uint8)
    dense[0] = 1
    tw = tb.pack_dense(torch.from_numpy(dense), C)
    _eq(tw, jb.pack_dense(jnp.asarray(dense), C), "pack_dense")
    _eq(tb.to_dense(tw, C), jb.to_dense(jnp.asarray(tw.numpy()), C),
        "to_dense")
    np.testing.assert_array_equal(tb.to_dense(tw, C).numpy(), dense)


@pytest.mark.parametrize("C", CAPS)
def test_mex_words_matches_reference_and_dense_argmin(C):
    rng = np.random.default_rng(200 + C)
    w = _words(rng, 64, C)
    # as every producer does, pre-forbid the out-of-cap tail
    w = w | np.asarray(jb.tail_mask(C))
    tm, to = tb.mex_words(torch.from_numpy(w), C)
    jm, jo = jb.mex_words(jnp.asarray(w), C)
    _eq(tm, jm, "mex")
    _eq(to, jo, "ovf")
    dense = np.asarray(jb.to_dense(jnp.asarray(w), C))
    np.testing.assert_array_equal(tm.numpy(), np.argmin(dense, axis=1))
    np.testing.assert_array_equal(to.numpy(), dense.all(axis=1))
    assert to[0].item() and tm[0].item() == 0          # saturated row
    assert not to[1].item() and tm[1].item() == 0      # empty row


def test_mex_words_every_single_zero_bit():
    """A word with exactly one zero bit, for each of the 32 positions (bit
    31 is the one a signed conversion would get wrong)."""
    w = (0xFFFFFFFF ^ (np.int64(1) << np.arange(32))).astype(np.uint32)
    w = w.view(np.int32).reshape(32, 1)
    tm, to = tb.mex_words(torch.from_numpy(w), 32)
    jm, jo = jb.mex_words(jnp.asarray(w), 32)
    _eq(tm, jm)
    _eq(to, jo)
    np.testing.assert_array_equal(tm.numpy(), np.arange(32))


@pytest.mark.parametrize("C", [4, 33, 64, 256])
def test_recolor_epilogue_and_apply_recolor(C):
    rng = np.random.default_rng(300 + C)
    rows = 48
    w = _words(rng, rows, C) | np.asarray(jb.tail_mask(C))
    defect, U = rng.random(rows) < 0.6, rng.random(rows) < 0.6
    defect[0] = U[0] = True            # the saturated row does work
    c_r = rng.integers(-1, C, size=rows).astype(np.int32)
    tg = tb.recolor_epilogue(torch.from_numpy(w), torch.from_numpy(defect),
                             torch.from_numpy(U), torch.from_numpy(c_r), C)
    jg = jb.recolor_epilogue(jnp.asarray(w), jnp.asarray(defect),
                             jnp.asarray(U), jnp.asarray(c_r), C)
    for t, j, nm in zip(tg, jg, ("newc", "recolored", "ovf")):
        _eq(t, j, nm)
    assert tg[2][0].item()
    mex = rng.integers(0, C, size=rows).astype(np.int32)
    ovf = rng.random(rows) < 0.3
    ta = tb.apply_recolor(torch.from_numpy(U), torch.from_numpy(mex),
                          torch.from_numpy(ovf), torch.from_numpy(c_r))
    ja = jb.apply_recolor(jnp.asarray(U), jnp.asarray(mex), jnp.asarray(ovf),
                          jnp.asarray(c_r))
    for t, j, nm in zip(ta, ja, ("newc", "recolored", "ovf")):
        _eq(t, j, nm)
