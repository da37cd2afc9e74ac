"""Port vs reference: the plain PyTorch versions of the two coloring kernels
and the ``ops`` dispatchers.

The port's ``firstfit_ref`` / ``detect_recolor_ref`` (both ``impl``s) are
held against the reference's Pallas kernels run in interpret mode AND the
reference's jnp refs, on the shape sweeps of ``tests/test_kernels.py`` plus
W=1 and the C=4 saturation case; the optional inputs (``forb0``,
``extra_defect``, ``force``, ``valid``) against jnp expressions equal to what
``repro.core.coloring._chunked_pass`` computes.  Integer arithmetic: the bar
is bit-equality (tolerance zero).

The CUDA kernels themselves have no CPU mode: ``chip_smoke.py`` holds them
against these plain versions on a GPU, and the ``cuda``-marked tests at the
end do the same under pytest on a machine that has one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jb
from repro.core import coloring as jcol
from repro.kernels import ref as jref
from repro.kernels.detect_recolor import detect_recolor as j_detect_recolor
from repro.kernels.firstfit import firstfit as j_firstfit
from repro_torch.core import bitset as tb
from repro_torch.kernels import ops, ref
from repro_torch.kernels import detect_recolor as dr_mod
from repro_torch.kernels import firstfit as ff_mod
from repro_torch.kernels.detect_recolor import detect_recolor
from repro_torch.kernels.firstfit import (firstfit, pick_lanes, pick_window)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import faults

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

IMPLS = ("bitset", "dense")
NAMES3 = ("newc", "recolored", "ovf")


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


# block_rows of the interpret-mode Pallas call must divide R
def _block_rows(R):
    return 256 if R % 256 == 0 else R


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("R,W,n,C", [
    (256, 8, 1024, 32), (512, 32, 512, 64), (256, 1, 64, 32),
    (1024, 16, 4096, 128), (64, 1, 16, 32), (96, 5, 300, 4),
])
def test_firstfit_ref_matches_reference(R, W, n, C, impl):
    rng = np.random.default_rng(R + W)
    ell = _rand_ell(rng, R, W, n)
    colors = rng.integers(-1, max(C - 1, 1), size=(n,)).astype(np.int32)
    got = ref.firstfit_ref(_t(ell), _t(colors), C, impl=impl)
    pallas = j_firstfit(jnp.asarray(ell), jnp.asarray(colors), C=C,
                        block_rows=_block_rows(R), interpret=True)
    _eq(got, pallas, ("mex", "ovf"))
    for jimpl in IMPLS:
        _eq(got, jref.firstfit_ref(jnp.asarray(ell), jnp.asarray(colors), C,
                                   impl=jimpl), ("mex", "ovf"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("R,W,n,C,row_start", [
    (256, 8, 1024, 32, 0), (256, 16, 1024, 64, 256), (512, 4, 2048, 32, 1024),
    (128, 1, 512, 32, 37), (96, 5, 300, 4, 100),
])
def test_detect_recolor_ref_matches_reference(R, W, n, C, row_start, impl):
    rng = np.random.default_rng(R * W)
    ell = _rand_ell(rng, R, W, n)
    colors = rng.integers(-1, max(C // 2, 2), size=(n,)).astype(np.int32)
    pri = rng.permutation(n).astype(np.int32)
    U = rng.random(R) < 0.7
    got = ref.detect_recolor_ref(_t(ell), _t(colors), _t(pri), row_start,
                                 _t(U), C, impl=impl)
    jargs = (jnp.asarray(ell), jnp.asarray(colors), jnp.asarray(pri),
             jnp.asarray(U))
    pallas = j_detect_recolor(*jargs, row_start=row_start, C=C,
                              block_rows=_block_rows(R), interpret=True)
    _eq(got, pallas, NAMES3)
    for jimpl in IMPLS:
        _eq(got, jref.detect_recolor_ref(jargs[0], jargs[1], jargs[2],
                                         row_start, jargs[3], C, impl=jimpl),
            NAMES3)


def _saturated(seed):
    rng = np.random.default_rng(seed)
    n, W, R, C = 512, 16, 256, 4
    ell = _rand_ell(rng, n, W, n, frac_fill=0.05)[:R]
    colors = rng.integers(0, C, size=(n,)).astype(np.int32)
    pri = rng.permutation(n).astype(np.int32)
    return ell, colors, pri, np.ones(R, bool), C


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kernel", ["firstfit", "detect_recolor"])
def test_saturation_c4_through_ops(kernel, impl):
    """C=4 is not a multiple of 32 (tail masking is load-bearing) and the
    rows are dense enough to saturate it: the overflow flags must match the
    reference's Pallas kernel, and fire."""
    ell, colors, pri, U, C = _saturated({"firstfit": 11,
                                         "detect_recolor": 22}[kernel])
    if kernel == "firstfit":
        got = ops.firstfit(_t(ell), _t(colors), C=C, impl=impl)
        want = j_firstfit(jnp.asarray(ell), jnp.asarray(colors), C=C,
                          interpret=True)
        _eq(got, want, ("mex", "ovf"))
    else:
        got = ops.detect_recolor(_t(ell), _t(colors), _t(pri), _t(U), 0, C=C,
                                 impl=impl)
        want = j_detect_recolor(jnp.asarray(ell), jnp.asarray(colors),
                                jnp.asarray(pri), jnp.asarray(U),
                                row_start=0, C=C, interpret=True)
        _eq(got, want, NAMES3)
    assert got[-1].numpy().any(), "saturation case must trip ovf flags"


def _chunk_pass_jnp(ell, colors, pri, U, row_start, C, impl, forb0_words,
                    extra_defect, force, valid):
    """What ``repro.core.coloring._chunked_pass`` computes for one chunk
    (its ``chunk_body``, detect=True), written with the reference's own
    helpers."""
    R = ell.shape[0]
    c_k = colors[row_start:row_start + R]
    pri_k = pri[row_start:row_start + R]
    nbrc, nbrp = jcol._gather_nbr(ell, colors, pri)
    defect = ((nbrc == c_k[:, None]) & (c_k[:, None] >= 0)
              & (nbrp > pri_k[:, None])).any(axis=1)
    if extra_defect is not None:
        defect = defect | extra_defect
    work = U & defect
    if force is not None:
        work = work | force
    if valid is not None:
        work = work & valid
    forb = jcol._forbidden(nbrc, C, impl)
    if forb0_words is not None:
        sf = (forb0_words if impl == "bitset"
              else jb.to_dense(forb0_words, C))
        forb = jcol._merge_forbidden(forb, sf, impl)
    mex, ovf_k = jcol._mex_of(forb, C, impl)
    return jnp.where(work, mex, c_k), work, ovf_k & work


OPTIONALS = [("forb0",), ("extra_defect",), ("force",), ("valid",),
             ("forb0", "extra_defect", "force", "valid")]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("keys", OPTIONALS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("R,W,n,C,row_start", [
    (128, 6, 512, 32, 64), (96, 9, 400, 33, 0), (64, 12, 256, 4, 100),
])
def test_optional_inputs_match_chunk_pass(R, W, n, C, row_start, keys, impl):
    rng = np.random.default_rng(R + C + len(keys))
    ell = _rand_ell(rng, R, W, n, 0.1 if C == 4 else 0.3)
    colors = rng.integers(-1, max(C // 2, 3), size=(n,)).astype(np.int32)
    pri = rng.permutation(n).astype(np.int32)
    U = rng.random(R) < 0.7
    dense0 = (rng.random((R, C)) < 0.3).astype(np.uint8)
    opt = {"forb0": np.asarray(jb.pack_dense(jnp.asarray(dense0), C)),
           "extra_defect": rng.random(R) < 0.3,
           "force": rng.random(R) < 0.2,
           "valid": rng.random(R) < 0.8}
    kw = {k: opt[k] for k in keys}
    got = ops.detect_recolor(_t(ell), _t(colors), _t(pri), _t(U), row_start,
                             C, impl=impl, **{k: _t(v) for k, v in kw.items()})
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want = _chunk_pass_jnp(
        jnp.asarray(ell), jnp.asarray(colors), jnp.asarray(pri),
        jnp.asarray(U), row_start, C, impl, jkw.get("forb0"),
        jkw.get("extra_defect"), jkw.get("force"), jkw.get("valid"))
    _eq(got, want, NAMES3)
    # the wrapper itself, on CPU tensors, takes the same plain version
    direct = detect_recolor(_t(ell), _t(colors), _t(pri), _t(U), row_start, C,
                            **{k: _t(v) for k, v in kw.items()})
    _eq(direct, want, NAMES3)
    if keys == ("forb0",):
        ff = ops.firstfit(_t(ell), _t(colors), C, impl=impl,
                          forb0=_t(opt["forb0"]))
        nbrc, _ = jcol._gather_nbr(jnp.asarray(ell), jnp.asarray(colors),
                                   jnp.asarray(pri))
        words = jb.pack_from_nbrc(nbrc, C) | jkw["forb0"]
        _eq(ff, jb.mex_words(words, C), ("mex", "ovf"))
        _eq(firstfit(_t(ell), _t(colors), C, _t(opt["forb0"])),
            jb.mex_words(words, C), ("mex", "ovf"))


def test_ops_counters_and_backends():
    rng = np.random.default_rng(0)
    ell = _t(_rand_ell(rng, 64, 8, 128))
    colors = _t(rng.integers(-1, 16, size=(128,)).astype(np.int32))
    pri = _t(rng.permutation(128).astype(np.int32))
    U = torch.ones(64, dtype=torch.bool)
    obs_metrics.reset()
    before = (firstfit.launches, detect_recolor.launches)
    a = ops.firstfit(ell, colors, C=32, backend="auto")
    b = ops.firstfit(ell, colors, C=32, backend="torch", impl="dense")
    _eq(a, [x.numpy() for x in b], ("mex", "ovf"))
    ops.detect_recolor(ell, colors, pri, U, 0, C=32)
    assert obs_metrics.counter_value("kernels.dispatch", kernel="firstfit",
                                     backend="torch") == 2
    assert obs_metrics.counter_value("kernels.dispatch",
                                     kernel="detect_recolor",
                                     backend="torch") == 1
    assert obs_metrics.total_matching("kernels.fallback") == 0
    # a CPU tensor never launches (and never counts as a launch)
    assert (firstfit.launches, detect_recolor.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.firstfit(ell, colors, C=32, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.detect_recolor(ell, colors, pri, U, 0, C=32, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.firstfit(ell, colors, C=32, backend="pallas")
    obs_metrics.reset()


def test_forced_fallback_site_only_bites_kernel_dispatches():
    """``kernel.fallback`` reroutes a kernel dispatch to the plain version
    and counts it; a dispatch that already is the plain version (a CPU
    tensor) neither draws from the site nor counts."""
    obs_metrics.reset()
    with faults.inject("kernel.fallback"):
        assert ops._forced_fallback("firstfit", "cuda") == "torch"
        assert ops._forced_fallback("detect_recolor", "torch") == "torch"
    assert obs_metrics.counter_value("kernels.fallback", kernel="firstfit",
                                     reason="forced") == 1
    assert obs_metrics.total_matching("kernels.fallback") == 1
    assert ops._forced_fallback("firstfit", "cuda") == "cuda"   # disarmed
    obs_metrics.reset()


def test_wrappers_check_their_arguments():
    rng = np.random.default_rng(1)
    ell = _t(_rand_ell(rng, 32, 4, 64))
    colors = _t(rng.integers(-1, 8, size=(64,)).astype(np.int32))
    pri = _t(rng.permutation(64).astype(np.int32))
    U = torch.ones(32, dtype=torch.bool)
    with pytest.raises(TypeError, match="ell must be torch.int32"):
        firstfit(ell.long(), colors, 32)
    with pytest.raises(ValueError, match="contiguous"):
        firstfit(ell.t().contiguous().t(), colors, 32)
    with pytest.raises(ValueError, match="C must be >= 1"):
        firstfit(ell, colors, 0)
    with pytest.raises(ValueError, match="forb0 must have shape"):
        firstfit(ell, colors, 64, torch.zeros((32, 1), dtype=torch.int32))
    with pytest.raises(TypeError, match="U_rows must be torch.bool"):
        detect_recolor(ell, colors, pri, U.to(torch.uint8), 0, 32)
    with pytest.raises(ValueError, match="lie outside"):
        detect_recolor(ell, colors, pri, U, 40, 32)
    with pytest.raises(ValueError, match="lanes must be one of"):
        firstfit(ell, colors, 32, lanes=3)
    assert [pick_lanes(w) for w in (1, 2, 3, 8, 9, 32, 33, 512)] == \
        [1, 2, 4, 8, 16, 32, 32, 32]
    assert [pick_window(c) for c in (1, 64, 65, 256, 257, 512, 4096)] == \
        [2, 2, 8, 8, 16, 16, 16]


_PICKS = [(1, True, "direct"), (3, True, "direct"), (4, True, "direct"),
          (8, True, "direct"), (14, True, "direct"), (16, True, "direct"),
          (17, True, "direct"), (48, False, "direct"),
          (20, True, "vec16"), (44, True, "vec16"), (45, True, "direct"),
          (512, True, "vec16"), (512, False, "direct"), (600, True, "vec16")]


# both wrappers' pickers; detect_recolor's cases keep their earlier ids
@pytest.mark.parametrize("mod,W,aligned,want", [
    pytest.param(m, *p, id=("" if m is dr_mod else "firstfit-")
                 + "-".join(map(str, p)))
    for m in (dr_mod, ff_mod) for p in _PICKS])
def test_detect_recolor_design_picker(mod, W, aligned, want):
    """Rows of more than DIRECT_MAX_W ids that are whole 16-B chunks of a
    16-B aligned table take the staged pass (16-B copies); every other
    shape the direct design.  One rule, one home (``kernels/firstfit.py``):
    first fit and detect_recolor pick alike."""
    assert mod.DIRECT_MAX_W == 16
    assert mod.design(W, aligned) == want
    assert want in mod.DESIGNS
    assert mod.design is ff_mod.design and mod.DESIGNS == ff_mod.DESIGNS


def test_detect_recolor_default_lanes_and_knobs():
    """The direct design's lanes (one slot a lane, a warp at most) wherever
    it serves, 8 lanes for the staged pass; the kept knobs are still
    checked, and on a CPU tensor they leave the result alone."""
    assert [dr_mod.default_lanes(w) for w in (1, 2, 3, 8, 9, 16, 17, 44,
                                              45, 512)] == \
        [1, 2, 4, 8, 16, 16, 32, 8, 32, 8]
    assert dr_mod.default_lanes(512, aligned=False) == 32
    rng = np.random.default_rng(3)
    ell = _t(_rand_ell(rng, 40, 12, 90))
    colors = _t(rng.integers(-1, 20, size=(90,)).astype(np.int32))
    pri = _t(rng.permutation(90).astype(np.int32))
    U = _t(rng.random(40) < 0.7)
    want = ref.detect_recolor_ref(ell, colors, pri, 0, U, 40)
    for lanes, window in ((None, None), (1, 2), (32, 16), (8, 8)):
        _eq(detect_recolor(ell, colors, pri, U, 0, 40, lanes=lanes,
                           window=window), [w.numpy() for w in want], NAMES3)
    with pytest.raises(ValueError, match="lanes must be one of"):
        detect_recolor(ell, colors, pri, U, 0, 40, lanes=3)
    with pytest.raises(ValueError, match="window must be one of"):
        detect_recolor(ell, colors, pri, U, 0, 40, window=4)
    counts = lambda: [detect_recolor.launches] + [
        getattr(detect_recolor, f"launches_{d}") for d in dr_mod.DESIGNS]
    before = counts()
    detect_recolor(ell, colors, pri, U, 0, 40)
    assert counts() == before                   # CPU: never launches


def test_firstfit_design_knobs():
    """First fit's ``route`` override is checked (a name of ``DESIGNS``, and
    ``vec16`` only on whole 16-B rows), and on a CPU tensor it, like
    ``lanes`` / ``window``, leaves the result alone and launches nothing."""
    assert [ff_mod.default_lanes(w) for w in (8, 14, 16, 17, 44, 45, 512)] \
        == [8, 16, 16, 32, 8, 32, 8]
    rng = np.random.default_rng(4)
    ell = _t(_rand_ell(rng, 40, 44, 90))
    colors = _t(rng.integers(-1, 20, size=(30,)).astype(np.int32))   # R > n
    want = [w.numpy() for w in ref.firstfit_ref(ell, colors, 40)]
    counts = lambda: [firstfit.launches] + [
        getattr(firstfit, f"launches_{d}") for d in ff_mod.DESIGNS]
    before = counts()
    for kw in ({}, dict(route="vec16"), dict(route="direct", lanes=4),
               dict(route="vec16", lanes=32, window=16)):
        _eq(firstfit(ell, colors, 40, **kw), want, ("mex", "ovf"))
    assert counts() == before                   # CPU: never launches
    with pytest.raises(ValueError, match="route must be one of"):
        firstfit(ell, colors, 40, route="vec4")
    with pytest.raises(ValueError, match="vec16 design needs"):
        firstfit(ell[:, :42].contiguous(), colors, 40, route="vec16")


# ---- on a GPU: the kernels against the plain versions ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,W,n,C", [(256, 8, 1024, 32), (1000, 7, 3000, 33),
                                     (333, 70, 2000, 1024)])
def test_cuda_firstfit_matches_plain(cuda_device, R, W, n, C):
    rng = np.random.default_rng(R + W)
    ell = _t(_rand_ell(rng, R, W, n)).to(cuda_device)
    colors = _t(rng.integers(-1, C, size=(n,)).astype(np.int32)).to(
        cuda_device)
    before = firstfit.launches
    got = ops.firstfit(ell, colors, C)
    assert firstfit.launches == before + 1
    want = ref.firstfit_ref(ell, colors, C)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,n,C,row_start", [(256, 16, 1024, 64, 256),
                                               (1000, 7, 3000, 33, 1500),
                                               (333, 70, 2000, 1024, 1)])
def test_cuda_detect_recolor_matches_plain(cuda_device, R, W, n, C,
                                           row_start):
    rng = np.random.default_rng(R * W)
    d = cuda_device
    ell = _t(_rand_ell(rng, R, W, n)).to(d)
    colors = _t(rng.integers(-1, C // 2, size=(n,)).astype(np.int32)).to(d)
    pri = _t(rng.permutation(n).astype(np.int32)).to(d)
    U = _t(rng.random(R) < 0.7).to(d)
    kw = dict(forb0=tb.pack_dense(_t((rng.random((R, C)) < 0.2)
                                     .astype(np.uint8)).to(d), C),
              extra_defect=_t(rng.random(R) < 0.2).to(d),
              force=_t(rng.random(R) < 0.2).to(d),
              valid=_t(rng.random(R) < 0.8).to(d))
    before = detect_recolor.launches
    got = ops.detect_recolor(ell, colors, pri, U, row_start, C, **kw)
    assert detect_recolor.launches == before + 1
    want = ref.detect_recolor_ref(ell, colors, pri, row_start, U, C, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("W,want", [
    (1, "direct"), (3, "direct"), (4, "direct"), (16, "direct"),
    (17, "direct"), (44, "vec16"), (45, "direct"), (256, "vec16"),
    (260, "vec16"), (512, "vec16")])
def test_cuda_detect_recolor_designs_match_plain(cuda_device, W, want):
    """Each design at its tile edges: direct (W <= 16, and rows that are
    not whole 16-B chunks), 16-B copies, rows staged in one and in two
    batches (W at and past 8 lanes' 256-int slice), scattered row_ids,
    forb0 and extra_defect on and off, a cap past one window."""
    rng = np.random.default_rng(W)
    d = cuda_device
    n, R, C = 3000, 1500, 700
    ell = _t(_rand_ell(rng, R, W, n, 0.5)).to(d)
    full = _t(_rand_ell(rng, n, W, n, 0.5)).to(d)
    colors = _t(rng.integers(-1, 560, size=n).astype(np.int32)).to(d)
    pri = _t(rng.permutation(n).astype(np.int32)).to(d)
    U = _t(rng.random(R) < 0.7).to(d)
    ids = _t(rng.integers(0, n + 5, size=R).astype(np.int32)).to(d)
    opt = dict(forb0=tb.pack_dense(_t((rng.random((R, C)) < 0.2)
                                      .astype(np.uint8)).to(d), C),
               extra_defect=_t(rng.random(R) < 0.2).to(d),
               force=_t(rng.random(R) < 0.2).to(d),
               valid=_t(rng.random(R) < 0.8).to(d))
    route = dr_mod.design(W)
    assert route == want
    for e, kw in ((ell, {}), (ell, opt), (full, dict(row_ids=ids)),
                  (full, dict(opt, row_ids=ids))):
        before = getattr(detect_recolor, f"launches_{route}")
        got = ops.detect_recolor(e, colors, pri, U, 0, C, **kw)
        assert getattr(detect_recolor, f"launches_{route}") == before + 1
        want = ref.detect_recolor_ref(e, colors, pri, 0, U, C, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _ff_design_case(rng, d, W, C, R=1500, n=3000):
    ell = _t(_rand_ell(rng, R, W, n, 0.5)).to(d)
    colors = _t(rng.integers(-1, min(C + 8, 560), size=n).astype(np.int32))
    if C == 4:
        colors = _t(rng.integers(0, 4, size=n).astype(np.int32))
    f0 = tb.pack_dense(_t((rng.random((R, C)) < 0.2).astype(np.uint8)).to(d),
                       C)
    return ell, colors.to(d), f0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [16, 17, 44, 45, 512])
@pytest.mark.parametrize("C", [4, 33, 256])
def test_cuda_firstfit_designs_match_plain(cuda_device, W, C):
    """Each design of first fit at its edges, bit-equal to the plain version:
    the direct design at W 16, 17 and 45 (not whole 16-B chunks), the
    staged pass at W 44 and 512 (rows staged in two batches at 8 lanes);
    caps 4 (saturated rows: ovf and mex 0), 33 (a tail word) and 256;
    forb0 on and off; more rows than colours (R > n); an unaligned view of
    the table takes the direct design."""
    rng = np.random.default_rng(W * 1000 + C)
    d = cuda_device
    ell, colors, f0 = _ff_design_case(rng, d, W, C)
    route = ff_mod.design(W)
    for kw in ({}, dict(forb0=f0)):
        before = getattr(firstfit, f"launches_{route}")
        got = ops.firstfit(ell, colors, C, **kw)
        assert getattr(firstfit, f"launches_{route}") == before + 1
        want = ref.firstfit_ref(ell, colors, C, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if C == 4:
            assert bool(got[1].any())
    short = colors[:ell.shape[0] // 3].contiguous()       # R > n
    assert all(torch.equal(g, w) for g, w in zip(
        ops.firstfit(ell, short, C), ref.firstfit_ref(ell, short, C)))
    if W % 4 == 0:
        # a view of the table one slot in: never 16-B aligned
        view = _t(_rand_ell(rng, 1501, W, 3000, 0.5)).to(d).view(-1)[1:]
        view = view[:1500 * W].view(1500, W)
        assert ff_mod.design(W, view.data_ptr() % 16 == 0) == "direct"
        before = firstfit.launches_direct
        got = ops.firstfit(view, colors, C, forb0=f0)
        assert firstfit.launches_direct == before + 1
        want = ref.firstfit_ref(view, colors, C, forb0=f0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        for lanes in (4, 8, 16, 32):
            for window in (2, 8, 16):
                got = firstfit(ell, colors, C, f0, lanes=lanes, window=window,
                               route="vec16" if W > 16 else "direct")
                want = ref.firstfit_ref(ell, colors, C, forb0=f0)
                assert all(torch.equal(g, w) for g, w in zip(got, want))

