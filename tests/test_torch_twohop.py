"""Port vs reference: the two-hop kernel's plain version, the ``ops.twohop``
dispatcher, and ``detect_recolor`` with ``row_ids``.

The port's ``twohop_ref`` (both ``impl``s) is held against the reference's
jnp ``ref.twohop_ref`` on the shape sweep of ``tests/test_kernels.py`` and
against its Pallas kernel in interpret mode (with a ragged ``page_rows``,
which must not change the result); the optional inputs (``force``,
``valid``, ``row_ids``, ``detect=False``) against jnp expressions equal to
the chunk bodies of ``repro.core.distance2._d2_chunked_pass`` and
``_d2_compact_pass``, and ``detect_recolor`` with ``row_ids`` against the
chunk body of ``repro.core.frontier._compact_pass``.  Integer arithmetic:
the bar is bit-equality (tolerance zero).

The CUDA kernel has no CPU mode: ``chip_smoke.py`` holds it against the
plain version on a GPU, and the ``cuda``-marked tests at the end do the same
under pytest on a machine that has one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jb
from repro.core import coloring as jcol
from repro.core import distance2 as jd2
from repro.kernels import ref as jref
from repro.kernels.twohop import default_page_rows as j_default_page_rows
from repro.kernels.twohop import twohop_detect_recolor as j_twohop
from repro_torch.core import bitset as tb
from repro_torch.kernels import ops, ref
from repro_torch.kernels.detect_recolor import detect_recolor
from repro_torch.kernels import twohop as th_mod
from repro_torch.kernels.firstfit import pick_lanes
from repro_torch.kernels.twohop import default_page_rows, twohop_detect_recolor
from repro_torch.obs import metrics as obs_metrics

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

IMPLS = ("bitset", "dense")
NAMES3 = ("newc", "recolored", "ovf")
# the reference's jnp functions, jitted: one compile per shape instead of
# one per jnp operation (seconds per new shape when run eagerly)
j_twohop_ref = jax.jit(jref.twohop_ref, static_argnames=("row_start", "C",
                                                         "impl"))
j_twohop_gather = jax.jit(jd2._twohop_gather, static_argnames=("n_pad",))
# (R, W, n, C, row_start): tests/test_kernels.py::test_twohop_matches_ref
SHAPES = [(128, 4, 512, 32, 0), (128, 8, 512, 64, 128),
          (256, 2, 1024, 32, 256), (128, 6, 128, 32, 0)]


def _rand_ell(rng, R, W, n, frac_fill=0.3):
    ell = rng.integers(0, n, size=(R, W)).astype(np.int32)
    ell[rng.random((R, W)) < frac_fill] = -1
    return ell


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, names):
    for g, w, nm in zip(got, want, names):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (nm, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=nm)


def _case(R, W, n, C, seed, top=None):
    rng = np.random.default_rng(seed)
    ell_all = _rand_ell(rng, n, W, n)
    colors = rng.integers(0, top or max(C // 2, 2), size=(n,)).astype(
        np.int32)
    pri = rng.permutation(n).astype(np.int32)
    U = rng.random(R) < 0.7
    return rng, ell_all, colors, pri, U


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("R,W,n,C,row_start", SHAPES)
def test_twohop_ref_matches_reference(R, W, n, C, row_start, impl):
    _, ell_all, colors, pri, U = _case(R, W, n, C, R * W + C)
    rows = ell_all[row_start:row_start + R]
    got = ref.twohop_ref(_t(rows), _t(ell_all), _t(colors), _t(pri),
                         row_start, _t(U), C, impl=impl)
    _eq(got, j_twohop_ref(jnp.asarray(rows), jnp.asarray(ell_all),
                          jnp.asarray(colors), jnp.asarray(pri), row_start,
                          jnp.asarray(U), C, impl=impl), NAMES3)


@pytest.mark.parametrize("R,W,n,C,row_start,page_rows", [
    (128, 4, 512, 32, 0, None), (128, 8, 512, 64, 128, None),
    (128, 8, 1000, 32, 128, 100),          # ragged last page, offset rows
])
def test_twohop_matches_pallas_kernel(R, W, n, C, row_start, page_rows):
    """The wrapper (plain version on CPU tensors) equals the reference's
    Pallas kernel in interpret mode; ``page_rows`` changes neither."""
    _, ell_all, colors, pri, U = _case(R, W, n, C, R + W + n)
    rows = ell_all[row_start:row_start + R]
    want = j_twohop(jnp.asarray(rows), jnp.asarray(ell_all),
                    jnp.asarray(colors), jnp.asarray(pri), jnp.asarray(U),
                    row_start=row_start, C=C, page_rows=page_rows,
                    interpret=True)
    for pr in (page_rows, 1, 77):
        _eq(twohop_detect_recolor(_t(rows), _t(ell_all), _t(colors), _t(pri),
                                  _t(U), row_start, C, page_rows=pr),
            want, NAMES3)


@pytest.mark.parametrize("impl", IMPLS)
def test_saturation_c4_through_ops(impl):
    """C=4 (not a multiple of 32) on rows dense enough to saturate it: the
    reference's Pallas kernel and the port agree, and ovf fires."""
    rng = np.random.default_rng(33)
    n, W, R, C = 512, 16, 256, 4
    ell_all = _rand_ell(rng, n, W, n, frac_fill=0.05)
    colors = rng.integers(0, C, size=(n,)).astype(np.int32)
    pri = rng.permutation(n).astype(np.int32)
    U = np.ones(R, bool)
    got = ops.twohop(_t(ell_all[:R]), _t(ell_all), _t(colors), _t(pri),
                     _t(U), 0, C=C, impl=impl)
    want = j_twohop(jnp.asarray(ell_all[:R]), jnp.asarray(ell_all),
                    jnp.asarray(colors), jnp.asarray(pri), jnp.asarray(U),
                    row_start=0, C=C, interpret=True)
    _eq(got, want, NAMES3)
    assert got[2].numpy().any(), "saturation case must trip ovf flags"


# ---- the engine's optional inputs against its jnp chunk bodies -----------

@functools.partial(jax.jit, static_argnames=("lo", "cs", "C", "impl",
                                             "detect"))
def _d2_chunk_body(ell, colors, pri, rows_mask, U, force, lo, cs, C, impl,
                   detect):
    """One chunk of ``repro.core.distance2._d2_chunked_pass`` (its
    ``chunk_body``), with the reference's own helpers: (newc, work,
    ovf & work, n_def)."""
    n_pad = colors.shape[0]
    row_ids = lo + jnp.arange(cs, dtype=jnp.int32)
    U_k, force_k = U[lo:lo + cs], force[lo:lo + cs]
    valid_k, c_k, pri_k = rows_mask[lo:lo + cs], colors[lo:lo + cs], \
        pri[lo:lo + cs]
    allc, allp = jd2._twohop_gather(ell, colors, pri, row_ids, n_pad)
    n_def = jnp.int32(0)
    if detect:
        defect = ((allc == c_k[:, None]) & (c_k[:, None] >= 0)
                  & (allp > pri_k[:, None])).any(axis=1)
        work = valid_k & ((U_k & defect) | force_k)
        n_def = (valid_k & U_k & defect).sum(dtype=jnp.int32)
    else:
        work = valid_k & (U_k | force_k)
    mex, ovf_k = jcol._mex_of(jcol._forbidden(allc, C, impl), C, impl)
    return jnp.where(work, mex, c_k), work, ovf_k & work, n_def


@functools.partial(jax.jit, static_argnames=("C", "impl"))
def _d2_compact_body(ell, colors, pri, ids, live, C, impl):
    """One chunk of ``repro.core.distance2._d2_compact_pass``: per-slot
    (newc, work, ovf & work) before the scatter, and n_def."""
    n_pad = colors.shape[0]
    ids_c = jnp.clip(ids, 0, n_pad - 1)
    c_k, pri_k = colors[ids_c], pri[ids_c]
    allc, allp = jd2._twohop_gather(ell, colors, pri, ids_c, n_pad)
    defect = ((allc == c_k[:, None]) & (c_k[:, None] >= 0)
              & (allp > pri_k[:, None])).any(axis=1) & live
    work = defect | (live & (c_k < 0))
    mex, o = jcol._mex_of(jcol._forbidden(allc, C, impl), C, impl)
    return (jnp.where(work, mex, c_k), work, o & work,
            defect.sum(dtype=jnp.int32))


CORNERS = [("force",), ("valid",), ("detect=False",), ("force", "valid"),
           ("force", "valid", "detect=False"), ("row_ids",)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("corner", CORNERS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("n_pad,W,C,n_chunks", [(512, 6, 32, 8),
                                                (256, 9, 33, 4)])
def test_optional_inputs_match_chunk_bodies(n_pad, W, C, n_chunks, corner,
                                            impl):
    rng = np.random.default_rng(n_pad + W + len(corner))
    ell = _rand_ell(rng, n_pad, W, n_pad)
    colors = rng.integers(0, C // 2, size=(n_pad,)).astype(np.int32)
    colors[rng.random(n_pad) < 0.15] = -1
    pri = rng.permutation(n_pad).astype(np.int32)
    U = rng.random(n_pad) < 0.6
    cs = n_pad // n_chunks
    lo = cs * (n_chunks // 2)
    J = jnp.asarray
    if corner == ("row_ids",):
        # a compacted frontier: ascending ids, dead slots = n_pad (clamped)
        live_n = cs - 5
        ids = np.full(cs, n_pad, np.int32)
        ids[:live_n] = np.sort(rng.choice(n_pad, live_n, replace=False))
        live = ids < n_pad
        want = _d2_compact_body(J(ell), J(colors), J(pri), J(ids), J(live),
                                C, impl)
        ids_c = _t(np.minimum(ids, n_pad - 1))
        force = _t(live & (colors[np.minimum(ids, n_pad - 1)] < 0))
        got = ops.twohop(None, _t(ell), _t(colors), _t(pri), _t(live), 0, C,
                         impl=impl, force=force, row_ids=ids_c)
    else:
        detect = "detect=False" not in corner
        rows_mask = (rng.random(n_pad) < 0.8 if "valid" in corner
                     else np.ones(n_pad, bool))
        force = (rng.random(n_pad) < 0.2 if "force" in corner
                 else np.zeros(n_pad, bool))
        if detect and "force" in corner:
            # the engine forces only uncolored rows of U (_compact_repair)
            force = U & (colors < 0)
        want = _d2_chunk_body(J(ell), J(colors), J(pri), J(rows_mask), J(U),
                              J(force), lo, cs, C, impl, detect)
        got = ops.twohop(_t(ell[lo:lo + cs]), _t(ell), _t(colors), _t(pri),
                         _t(U[lo:lo + cs]), lo, C, impl=impl,
                         force=_t(force[lo:lo + cs]),
                         valid=_t(rows_mask[lo:lo + cs]), detect=detect)
        force = _t(force[lo:lo + cs])
    _eq(got, want[:3], NAMES3)
    if corner != ("detect=False",) and "detect=False" not in corner:
        # the engine's defect count, read off the kernel's output: exact
        # because a forced row is uncolored and so never defective
        assert int((got[1] & ~force).sum()) == int(want[3])


@functools.partial(jax.jit, static_argnames=("C", "impl"))
def _compact_pass_body(ell, colors, pri, ids, live, C, impl, snap_words,
                       ovf_defect):
    """One chunk of ``repro.core.frontier._compact_pass`` (its
    ``chunk_body``) before the scatter, with the chunk's slices of the
    frontier-local snapshot tables."""
    n_pad = colors.shape[0]
    ids_c = jnp.clip(ids, 0, n_pad - 1)
    c_k, pri_k = colors[ids_c], pri[ids_c]
    nbrc, nbrp = jcol._gather_nbr(ell[ids_c], colors, pri)
    defect = ((nbrc == c_k[:, None]) & (c_k[:, None] >= 0)
              & (nbrp > pri_k[:, None])).any(axis=1)
    if ovf_defect is not None:
        defect = defect | ovf_defect
    defect = defect & live
    work = defect | (live & (c_k < 0))
    forb = jcol._forbidden(nbrc, C, impl)
    if snap_words is not None:
        snap = snap_words if impl == "bitset" else jb.to_dense(snap_words, C)
        forb = jcol._merge_forbidden(forb, snap, impl)
    mex, o = jcol._mex_of(forb, C, impl)
    return (jnp.where(work, mex, c_k), work, o & work,
            defect.sum(dtype=jnp.int32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("with_ovf", [False, True])
@pytest.mark.parametrize("n_pad,W,C,cs", [(512, 7, 32, 64), (300, 12, 4, 40)])
def test_detect_recolor_row_ids_matches_compact_pass(n_pad, W, C, cs,
                                                     with_ovf, impl):
    rng = np.random.default_rng(n_pad + C + with_ovf)
    ell = _rand_ell(rng, n_pad, W, n_pad, 0.1 if C == 4 else 0.3)
    colors = rng.integers(0, max(C // 2, 3), size=(n_pad,)).astype(np.int32)
    colors[rng.random(n_pad) < 0.15] = -1
    pri = rng.permutation(n_pad).astype(np.int32)
    ids = np.full(cs, n_pad, np.int32)
    ids[:cs - 7] = np.sort(rng.choice(n_pad, cs - 7, replace=False))
    live = ids < n_pad
    snap = xd = None
    if with_ovf:
        dense = (rng.random((cs, C)) < 0.3).astype(np.uint8)
        snap = np.array(jb.pack_dense(jnp.asarray(dense), C))
        xd = rng.random(cs) < 0.3
        xd &= colors[np.minimum(ids, n_pad - 1)] >= 0   # as conf requires
    J = lambda a: None if a is None else jnp.asarray(a)
    want = _compact_pass_body(J(ell), J(colors), J(pri), J(ids), J(live), C,
                              impl, J(snap), J(xd))
    ids_c = np.minimum(ids, n_pad - 1)
    force = live & (colors[ids_c] < 0)
    T = lambda a: None if a is None else _t(a)
    got = ops.detect_recolor(_t(ell), _t(colors), _t(pri), _t(live), 0, C,
                             impl=impl, forb0=T(snap), extra_defect=T(xd),
                             force=_t(force), row_ids=_t(ids_c))
    _eq(got, want[:3], NAMES3)
    assert int((got[1] & ~_t(force)).sum()) == int(want[3])
    direct = detect_recolor(_t(ell), _t(colors), _t(pri), _t(live), 0, C,
                            T(snap), T(xd), _t(force), row_ids=_t(ids_c))
    _eq(direct, want[:3], NAMES3)


def test_twohop_gather_matches_reference():
    from repro_torch.core import distance2 as td2
    rng = np.random.default_rng(4)
    n_pad, W = 200, 5
    ell = _rand_ell(rng, n_pad, W, n_pad)
    colors = rng.integers(-1, 20, size=n_pad).astype(np.int32)
    pri = rng.permutation(n_pad).astype(np.int32)
    ids = rng.integers(0, n_pad + 3, size=40).astype(np.int32)
    want = j_twohop_gather(jnp.asarray(ell), jnp.asarray(colors),
                           jnp.asarray(pri), jnp.asarray(ids), n_pad)
    got = td2._twohop_gather(_t(ell), _t(colors), _t(pri), _t(ids), n_pad)
    _eq(got, want, ("allc", "allp"))


def test_dispatch_counters_and_wrapper_checks():
    _, ell_all, colors, pri, U = _case(32, 4, 64, 32, 1)
    ea, c, p, u = _t(ell_all), _t(colors), _t(pri), _t(U)
    obs_metrics.reset()
    before = twohop_detect_recolor.launches
    a = ops.twohop(ea[:32], ea, c, p, u, 0, C=32)
    b = ops.twohop(ea[:32], ea, c, p, u, 0, C=32, backend="torch",
                   impl="dense", page_rows=5)
    _eq(a, [x.numpy() for x in b], NAMES3)
    assert obs_metrics.counter_value("kernels.dispatch", kernel="twohop",
                                     backend="torch") == 2
    assert obs_metrics.total_matching("kernels.fallback") == 0
    assert twohop_detect_recolor.launches == before   # CPU: never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.twohop(ea[:32], ea, c, p, u, 0, C=32, backend="cuda")
    obs_metrics.reset()
    with pytest.raises(ValueError, match="page_rows must be >= 1"):
        twohop_detect_recolor(ea[:32], ea, c, p, u, 0, 32, page_rows=0)
    with pytest.raises(ValueError, match="ell_rows is needed"):
        twohop_detect_recolor(None, ea, c, p, u, 0, 32)
    ids = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="ell_rows=None with row_ids"):
        twohop_detect_recolor(ea[:32], ea, c, p, u, 0, 32, row_ids=ids)
    with pytest.raises(ValueError, match="fewer than"):
        twohop_detect_recolor(ea[:32], ea[:40], c, p, u, 0, 32)
    with pytest.raises(ValueError, match="lie outside"):
        twohop_detect_recolor(ea[:32], ea, c, p, u, 40, 32)
    with pytest.raises(TypeError, match="pri must be a torch.Tensor"):
        twohop_detect_recolor(ea[:32], ea, c, None, u, 0, 32)
    with pytest.raises(TypeError, match="row_ids must be torch.int32"):
        twohop_detect_recolor(None, ea, c, p, u, 0, 32, row_ids=ids.long())
    # row_ids into a table longer than ell (a shard's ghost tail) are
    # taken; the slot-stride form still needs the whole stacked table
    with pytest.raises(ValueError, match="with slot_rows, ell must be"):
        detect_recolor(ea[:40], c, p, u, 0, 32, row_ids=ids, slot_rows=32)
    short = detect_recolor(ea[:40], c, p, u, 0, 32, row_ids=ids)
    _eq(short, [x.numpy() for x in ref.detect_recolor_ref(
        ea, c, p, 0, u, 32, row_ids=ids)], NAMES3)
    # round 0 reads no priority: pri may be None
    r0 = twohop_detect_recolor(ea[:32], ea, c, None, u, 0, 32, detect=False)
    _eq(r0, ref.twohop_ref(ea[:32], ea, c, p, 0, u, 32, detect=False),
        NAMES3)
    for n_all, W in ((10, 4), (5000, 1), (10**6, 44), (300000, 14)):
        assert default_page_rows(n_all, W) == j_default_page_rows(n_all, W)


@pytest.mark.parametrize("W,fits,aligned,want", [
    (1, True, True, "direct"), (3, True, True, "direct"),
    (8, True, True, "direct"), (14, True, True, "direct"),
    (16, True, True, "direct"), (17, True, True, "staged4"),
    (20, True, True, "staged16"), (44, True, True, "staged16"),
    (44, True, False, "staged4"), (45, True, True, "staged4"),
    (512, True, True, "staged16"), (513, False, True, "direct"),
    (45, False, True, "direct"), (45, False, False, "direct"),
    (45, True, False, "staged4"), (44, False, True, "direct")])
def test_twohop_design_picker(W, fits, aligned, want):
    """The direct design for rows of at most DIRECT_MAX_W ids and for the
    shapes the staged designs do not hold (``fits``, the kernel's rule);
    the staged designs for the rest, 16-B copies where the rows are 16-B
    chunks on a 16-B aligned table."""
    assert th_mod.DIRECT_MAX_W == 16
    assert th_mod.design(W, fits, aligned) == want
    assert want in th_mod.DESIGNS


def test_twohop_knobs_leave_the_result_alone():
    """``lanes`` / ``window`` / ``page_rows`` are checked and, on a CPU
    tensor (the plain version), change nothing; no launch is counted."""
    _, ell_all, colors, pri, U = _case(40, 6, 120, 33, 4)
    ea, c, p, u = _t(ell_all), _t(colors), _t(pri), _t(U)
    want = ref.twohop_ref(ea[:40], ea, c, p, 0, u, 33)
    counts = [getattr(twohop_detect_recolor, f"launches_{d}")
              for d in th_mod.DESIGNS]
    for kw in (dict(), dict(lanes=1, window=2), dict(lanes=32, window=16),
               dict(page_rows=7)):
        _eq(twohop_detect_recolor(ea[:40], ea, c, p, u, 0, 33, **kw),
            [w.numpy() for w in want], NAMES3)
    assert counts == [getattr(twohop_detect_recolor, f"launches_{d}")
                      for d in th_mod.DESIGNS]
    with pytest.raises(ValueError, match="lanes must be one of"):
        twohop_detect_recolor(ea[:40], ea, c, p, u, 0, 33, lanes=6)
    with pytest.raises(ValueError, match="window must be one of"):
        twohop_detect_recolor(ea[:40], ea, c, p, u, 0, 33, window=3)


# ---- on a GPU: the kernel against the plain version -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,W,n,C,row_start", [(128, 8, 512, 64, 128),
                                               (333, 20, 2000, 33, 1),
                                               (64, 64, 4096, 1024, 100)])
def test_cuda_twohop_matches_plain(cuda_device, R, W, n, C, row_start):
    rng, ell_all, colors, pri, U = _case(R, W, n, C, R + W,
                                         top=560 if C > 512 else None)
    d = cuda_device
    args = [_t(x).to(d) for x in (ell_all[row_start:row_start + R], ell_all,
                                  colors, pri, U)]
    ids = _t(rng.permutation(n)[:R].astype(np.int32)).to(d)
    force = _t(rng.random(R) < 0.2).to(d)
    for kw in (dict(), dict(force=force, detect=False),
               dict(row_ids=ids, force=force)):
        rows = None if "row_ids" in kw else args[0]
        before = twohop_detect_recolor.launches
        got = ops.twohop(rows, args[1], args[2], args[3], args[4], row_start,
                         C, **kw)
        assert twohop_detect_recolor.launches == before + 1
        want = ref.twohop_ref(rows, args[1], args[2], args[3], row_start,
                              args[4], C, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_detect_recolor_row_ids_matches_plain(cuda_device):
    rng = np.random.default_rng(9)
    d = cuda_device
    n, W, R, C = 2000, 30, 300, 256
    ell = _t(_rand_ell(rng, n, W, n)).to(d)
    colors = _t(rng.integers(-1, 100, size=n).astype(np.int32)).to(d)
    pri = _t(rng.permutation(n).astype(np.int32)).to(d)
    ids = _t(rng.permutation(n)[:R].astype(np.int32)).to(d)
    U = _t(rng.random(R) < 0.7).to(d)
    kw = dict(forb0=tb.pack_dense(_t((rng.random((R, C)) < 0.2)
                                     .astype(np.uint8)).to(d), C),
              force=_t(rng.random(R) < 0.2).to(d), row_ids=ids)
    got = ops.detect_recolor(ell, colors, pri, U, 0, C, **kw)
    want = ref.detect_recolor_ref(ell, colors, pri, 0, U, C, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)



@pytest.mark.cuda
@pytest.mark.parametrize("W,lanes,want", [
    (1, None, "direct"), (3, None, "direct"), (4, None, "direct"),
    (16, None, "direct"), (17, None, "staged4"), (44, None, "staged16"),
    (45, None, "staged4"), (44, 16, "staged16"), (45, 4, "staged4"),
    (45, 1, "direct"), (513, None, "direct")])
def test_cuda_twohop_designs_match_plain(cuda_device, W, lanes, want):
    """Each design (staged16, staged4, direct) at its tile edges, picked by
    the kernel's own shape rule: rows with one fewer, as many and one more
    live neighbours than a stage batch holds, scattered row_ids,
    detect=False, a cap past one window."""
    rng = np.random.default_rng(W + 7)
    d = cuda_device
    n, C = 1200, 700
    R = 300 if W < 100 else 12
    g = pick_lanes(W) if lanes is None else lanes
    batch = max(1, 32 * g // W)
    deg = rng.integers(0, W + 1, size=n)
    deg[:4] = np.clip([batch - 1, batch, batch + 1, W], 0, W)
    ell_all = rng.integers(0, n, size=(n, W)).astype(np.int32)
    ell_all[np.arange(W)[None, :] >= deg[:, None]] = -1
    ea = _t(ell_all).to(d)
    colors = _t(rng.integers(-1, 560, size=n).astype(np.int32)).to(d)
    pri = _t(rng.permutation(n).astype(np.int32)).to(d)
    U = _t(rng.random(R) < 0.7).to(d)
    ids = _t(rng.integers(0, n + 3, size=R).astype(np.int32)).to(d)
    force = _t(rng.random(R) < 0.2).to(d)
    route = th_mod.design(W, th_mod.staged_fits(g, W))
    assert route == want
    for kw in (dict(), dict(force=force, detect=False),
               dict(row_ids=ids, force=force)):
        rows = None if "row_ids" in kw else ea[:R]
        before = getattr(twohop_detect_recolor, f"launches_{route}")
        got = ops.twohop(rows, ea, colors, pri, U, 0, C, lanes=lanes, **kw)
        assert getattr(twohop_detect_recolor, f"launches_{route}") == \
            before + 1
        want = ref.twohop_ref(rows, ea, colors, pri, 0, U, C, **kw)
        for got_t, want_t in zip(got, want):
            assert torch.equal(got_t, want_t)


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
