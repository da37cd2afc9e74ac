"""The paper's baselines in the port: CAT, GM and JP through
``repro_torch.api.color(g, algorithm=..., device="cpu")`` against
``repro.api.color``, field by field; CAT's detect pass (``_detect_pass``, on
the detect-only form of the ``detect_recolor`` kernel) against the
reference's; CAT's phase A after round 0 (through ``detect_recolor`` with
``force`` the work mask) against first fit; the legacy shims, the
``ALGORITHMS`` view, ``color_distance_d`` and ``core/schedule.py``.

Seeds drive numpy on the host and everything downstream is integer
arithmetic, so the bar is bit-equality (tolerance zero).  The ``cuda`` tests
at the end run the engines on the card against the CPU and count the
launches exactly.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import registry as jregistry
from repro.core import coloring as jcol
from repro.core import distance2 as jd2
from repro.core import schedule as jsched
from repro.core.context import PassContext as JPassContext
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import registry as tregistry
from repro_torch.core import bitset as tb
from repro_torch.core import coloring as tcol
from repro_torch.core import distance2 as td2
from repro_torch.core import schedule as tsched
from repro_torch.core.context import PassContext as TPassContext
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import ops, ref
from repro_torch.kernels import detect_recolor as dr_mod
from repro_torch.kernels.detect_recolor import detect_recolor
from repro_torch.kernels.firstfit import firstfit

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

J_SUITE = jgen.paper_suite("tiny")
T_SUITE = tgen.paper_suite("tiny")
TINY = sorted(J_SUITE)
ALGOS = ("cat", "gm", "jp")

FIELDS = ("n_rounds", "total_conflicts", "n_colors", "overflow",
          "gather_passes", "final_C", "retries", "trace_truncated",
          "distance", "degrade_rung")


def assert_results_equal(jr, tr):
    assert tr.colors.dtype == np.int32 and jr.colors.dtype == np.int32
    np.testing.assert_array_equal(tr.colors, jr.colors, err_msg="colors")
    jc, tc = (np.asarray(jr.conflicts_per_round),
              np.asarray(tr.conflicts_per_round))
    assert tc.dtype == jc.dtype, "conflicts_per_round dtype"
    np.testing.assert_array_equal(tc, jc, err_msg="conflicts_per_round")
    for f in FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    if jr.spec is not None:
        assert tr.spec.spec_key() == jr.spec.spec_key()
    assert tr.summary() == jr.summary()


def both(jg, tg, **kw):
    jr = japi.color(jg, **kw)
    tr = tapi.color(tg, device="cpu", **kw)
    assert_results_equal(jr, tr)
    assert tcol.is_proper(tg, tr.colors)
    return jr, tr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the engines against the reference --------------------------------------

@pytest.mark.parametrize("seed,impl", [(0, "bitset"), (1, "bitset"),
                                       (2, "bitset"), (0, "dense")],
                         ids=["0-bitset", "1-bitset", "2-bitset", "0-dense"])
@pytest.mark.parametrize("name", TINY)
@pytest.mark.parametrize("algo", ALGOS)
def test_baseline_equals_reference(algo, name, seed, impl):
    both(J_SUITE[name], T_SUITE[name], algorithm=algo, seed=seed,
         forbidden_impl=impl)


@pytest.mark.parametrize("name", ["mesh2d", "rmat_b"])
@pytest.mark.parametrize("algo", ["cat", "jp"])
def test_forced_cap_doubling(algo, name):
    """C=4 cannot hold these graphs: the cap doubles until it fits."""
    kw = dict(max_rounds=12, n_chunks=4) if algo == "cat" else {}
    jr, tr = both(J_SUITE[name], T_SUITE[name], algorithm=algo, C=4, **kw)
    assert tr.retries > 0 and tr.overflow and tr.final_C == 4 << tr.retries


@pytest.mark.parametrize("name,ell_cap", [("rmat_b", 4), ("rmat_g", 4),
                                          ("bmw3_2", 3)])
@pytest.mark.parametrize("algo", ["cat", "gm"])
def test_overflow_coo(algo, name, ell_cap):
    """``ell_cap`` below the max degree: hub rows spill into the COO side
    channel — CAT's snapshot table and overflow-edge defects, GM's detect
    pass and its serial repair's overflow neighbours."""
    both(J_SUITE[name], T_SUITE[name], algorithm=algo, ell_cap=ell_cap)


@pytest.mark.parametrize("algo", ["cat", "gm"])
def test_repair_includes_overflow_edges(algo):
    """The reference's ``test_gm_repair_includes_overflow_edges`` graph and
    cap (ell_cap 8 on a 2^9 RMAT-B with edge factor 16)."""
    jg = jgen.rmat_b(9, edge_factor=16)
    tg = tgen.rmat_b(9, edge_factor=16)
    assert tg.max_degree > 8
    both(jg, tg, algorithm=algo, seed=1, ell_cap=8)


@pytest.mark.parametrize("n_chunks", [1, 64])
@pytest.mark.parametrize("name", ["pwtk", "rmat_er"])
@pytest.mark.parametrize("algo", ["cat", "gm"])
def test_n_chunks(algo, name, n_chunks):
    both(J_SUITE[name], T_SUITE[name], algorithm=algo, n_chunks=n_chunks)


@pytest.mark.parametrize("name", ["bmw3_2", "rmat_g"])
@pytest.mark.parametrize("algo", ALGOS)
def test_relabel_false(algo, name):
    both(J_SUITE[name], T_SUITE[name], algorithm=algo, relabel=False, seed=1)


def test_jp_round_bound_raises_as_the_reference():
    with pytest.raises(RuntimeError) as je:
        japi.color(J_SUITE["rmat_b"], algorithm="jp", max_rounds=3)
    with pytest.raises(RuntimeError) as te:
        tapi.color(T_SUITE["rmat_b"], device="cpu", algorithm="jp",
                   max_rounds=3)
    assert str(te.value) == str(je.value)
    assert "JP left" in str(te.value)


def test_traced_cat_run_matches():
    jr, tr = both(J_SUITE["rmat_g"], T_SUITE["rmat_g"], algorithm="cat",
                  trace=True, ell_cap=4)
    jt, tt = jr.trace, tr.trace
    assert [dataclasses.astuple(e) for e in tt.rounds] == \
        [dataclasses.astuple(e) for e in jt.rounds]
    for f in ("spec_key", "engine", "n_rounds", "gather_passes",
              "total_conflicts", "n_colors"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert [p.name for p in tt.phases] == [p.name for p in jt.phases]
    assert [p.meta for p in tt.phases] == [p.meta for p in jt.phases]


@pytest.mark.parametrize("algo", ["gm", "jp"])
def test_traced_gm_and_jp_phases(algo):
    jr, tr = both(J_SUITE["bmw3_2"], T_SUITE["bmw3_2"], algorithm=algo,
                  trace=True)
    assert [(p.name, p.meta) for p in tr.trace.phases] == \
        [(p.name, p.meta) for p in jr.trace.phases]


def test_dispatches_on_the_cpu():
    """On CPU tensors CAT's and GM's kernel calls take the plain versions
    (counted as ``backend=torch`` dispatches, never as launches); JP
    dispatches nothing at all."""
    g = T_SUITE["pwtk"]
    counts = (firstfit.launches, detect_recolor.launches,
              detect_recolor.launches_detect)
    for algo, want in (("cat", True), ("gm", True), ("jp", False)):
        tobs.metrics.reset()
        tapi.color(g, device="cpu", algorithm=algo)
        disp = tobs.metrics.total_matching("kernels.dispatch")
        assert (disp > 0) == want, (algo, disp)
        assert tobs.metrics.total_matching("kernels.fallback") == 0
    tobs.metrics.reset()
    assert counts == (firstfit.launches, detect_recolor.launches,
                      detect_recolor.launches_detect)


# ---- CAT's passes against the reference's ------------------------------------

@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("name,ell_cap", [("mesh2d", 512), ("rmat_b", 6),
                                          ("rmat_g", 512)])
def test_detect_pass_matches_reference(name, ell_cap, impl):
    """The port's ``_detect_pass`` (one detect-only launch of B2 over every
    row) against the reference's jnp one, on damaged colorings: uncolored
    rows, rows given a neighbour's color, out-of-cap colors, a random U."""
    jp = jcol.prepare(J_SUITE[name], seed=1, n_chunks=8, ell_cap=ell_cap)
    tp = tcol.problem_from_numpy(
        np.asarray(jp.ell), np.asarray(jp.ovf_src), np.asarray(jp.ovf_dst),
        np.asarray(jp.pri), jp.n, jp.n_pad, jp.perm, jp.C, "cpu")
    jctx = JPassContext.for_problem(jp, n_chunks=8, forbidden_impl=impl)
    tctx = TPassContext.for_problem(tp, n_chunks=8, forbidden_impl=impl)
    jdetect = jax.jit(jcol._detect_pass, static_argnums=(0,))
    rng = np.random.default_rng(len(name) + ell_cap)
    ell = np.asarray(jp.ell)
    for trial in range(3):
        colors = rng.integers(-1, 6, size=jp.n_pad).astype(np.int32)
        clash = rng.permutation(jp.n)[:jp.n // 3]
        clash = clash[ell[clash, 0] >= 0]
        colors[clash] = colors[ell[clash, 0]]
        colors[rng.integers(0, jp.n_pad, size=3)] = jp.C + 5
        U = rng.random(jp.n_pad) < (0.5, 0.9, 1.0)[trial]
        want = jdetect(jctx, jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri,
                       jnp.asarray(colors), jnp.asarray(U))
        got = tcol._detect_pass(tctx, tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri,
                                _t(colors), _t(U))
        assert got.dtype == torch.bool and got.shape == (jp.n_pad,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert trial or bool(got.any())


@pytest.mark.parametrize("R,W,n,C,row_start", [
    (128, 6, 512, 32, 64), (96, 9, 400, 33, 0), (64, 12, 256, 4, 100),
    (77, 40, 500, 512, 423)])
def test_sparse_phase_a_equals_firstfit(R, W, n, C, row_start):
    """CAT's phase A after round 0 goes through ``detect_recolor`` with U
    all false and ``force`` the work mask: the same (newc, recolored, ovf)
    as first fit followed by ``apply_recolor`` (the mex never reads the
    row's own color), with and without the snapshot words."""
    rng = np.random.default_rng(R + W)
    ell = rng.integers(0, n, size=(R, W)).astype(np.int32)
    ell[rng.random((R, W)) < (0.1 if C == 4 else 0.3)] = -1
    # C=4: every color drawn from [0, 4), so most rows saturate
    lo_c, hi_c = (0, C) if C == 4 else (-1, max(C // 2, 3))
    colors = _t(rng.integers(lo_c, hi_c, size=n).astype(np.int32))
    pri = _t(rng.permutation(n).astype(np.int32))
    work = _t(rng.random(R) < 0.4)
    no_u = torch.zeros(R, dtype=torch.bool)
    f0 = tb.pack_dense(_t((rng.random((R, C)) < 0.3).astype(np.uint8)), C)
    for kw in ({}, dict(forb0=f0)):
        got = ops.detect_recolor(_t(ell), colors, pri, no_u, row_start, C,
                                 force=work, **kw)
        mex, full = ops.firstfit(_t(ell), colors, C, **kw)
        want = tb.apply_recolor(work, mex, full,
                                colors[row_start:row_start + R])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if C == 4:
            assert bool(got[2].any())


@pytest.mark.parametrize("name,ell_cap", [("bmw3_2", 512), ("rmat_b", 6)])
def test_sparse_chunked_pass_equals_dense_route(name, ell_cap):
    """``_chunked_pass(sparse=True)`` and the first-fit route give the same
    colors, flags and overflow bit from a CAT round's state."""
    tp = tcol.prepare(T_SUITE[name], seed=2, n_chunks=8, ell_cap=ell_cap)
    ctx = TPassContext.for_problem(tp, n_chunks=8)
    valid = torch.arange(tp.n_pad) < tp.n
    zeros = torch.zeros(tp.n_pad, dtype=torch.bool)
    colors = torch.full((tp.n_pad,), -1, dtype=torch.int32)
    tcol._chunked_pass(ctx, tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri, colors,
                       zeros, valid, detect=False)
    U = tcol._detect_pass(ctx, tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri,
                          colors, valid)
    assert bool(U.any())
    outs = []
    for sparse in (False, True):
        outs.append(tcol._chunked_pass(ctx, tp.ell, tp.ovf_src, tp.ovf_dst,
                                       tp.pri, colors.clone(), U, zeros,
                                       detect=False, sparse=sparse))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


OPTIONALS = [(), ("extra_defect",), ("force",), ("valid",),
             ("extra_defect", "force", "valid")]


@pytest.mark.parametrize("keys", OPTIONALS,
                         ids=lambda k: "+".join(k) or "none")
@pytest.mark.parametrize("rows", [False, True], ids=["tile", "row_ids"])
def test_detect_only_is_the_full_pass_recolored(rows, keys):
    """``detect_only=True`` returns exactly the full pass's ``recolored``
    output (wrapper and ``ops``), takes no ``forb0``, and on CPU tensors
    counts no launch."""
    rng = np.random.default_rng(len(keys) + 10 * rows)
    R, W, n, C = 200, 9, 600, 33
    e = rng.integers(0, n, size=(n if rows else R, W)).astype(np.int32)
    e[rng.random(e.shape) < 0.3] = -1
    colors = rng.integers(0, 16, size=n).astype(np.int32)
    colors[rng.integers(0, n, size=n // 10)] = -1
    colors, pri, ell = (_t(colors), _t(rng.permutation(n).astype(np.int32)),
                        _t(e))
    U = _t(rng.random(R) < 0.7)
    opt = dict(extra_defect=_t(rng.random(R) < 0.2),
               force=_t(rng.random(R) < 0.2),
               valid=_t(rng.random(R) < 0.8))
    kw = {k: opt[k] for k in keys}
    if rows:
        kw["row_ids"] = _t(rng.permutation(n)[:R].astype(np.int32))
    rs = 0 if rows else 300
    before = (detect_recolor.launches, detect_recolor.launches_detect)
    full = ops.detect_recolor(ell, colors, pri, U, rs, C, **kw)
    for got in (ops.detect_recolor(ell, colors, pri, U, rs, C,
                                   detect_only=True, **kw),
                detect_recolor(ell, colors, pri, U, rs, C, detect_only=True,
                               **kw),
                ref.detect_recolor_ref(ell, colors, pri, rs, U, C,
                                       impl="dense", detect_only=True, **kw)):
        assert got.dtype == torch.bool and torch.equal(got, full[1])
    assert (detect_recolor.launches, detect_recolor.launches_detect) == before
    f0 = torch.zeros((R, 2), dtype=torch.int32)
    for fn in (ops.detect_recolor, detect_recolor):
        with pytest.raises(ValueError, match="forb0 must be None"):
            fn(ell, colors, pri, U, rs, C, forb0=f0, detect_only=True,
               **kw)


# ---- shims, ALGORITHMS, color_distance_d, schedules --------------------------

def test_legacy_shims_route_through_the_front_door():
    tregistry.reset_legacy_warnings()
    jregistry.reset_legacy_warnings()
    g_t, g_j = T_SUITE["rmat_g"], J_SUITE["rmat_g"]
    for shim, kw in (("color_rsoc", dict(seed=2, n_chunks=8)),
                     ("color_cat", dict(seed=2, ell_cap=4)),
                     ("color_gm", dict(seed=2, n_chunks=4)),
                     ("color_jp", dict(seed=2))):
        tfn, jfn = getattr(tcol, shim), getattr(jcol, shim)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr = tfn(g_t, device="cpu", **kw)
            tr2 = tfn(g_t, device="cpu", **kw)
        dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert len(dep) == 1 and shim in str(dep[0].message)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jr = jfn(g_j, **kw)
        assert_results_equal(jr, tr)
        np.testing.assert_array_equal(tr2.colors, tr.colors)
        assert tr.spec.algorithm == shim[len("color_"):]
    tregistry.reset_legacy_warnings()
    jregistry.reset_legacy_warnings()


def test_algorithms_view():
    assert list(tcol.ALGORITHMS) == list(jcol.ALGORITHMS) == \
        ["cat", "gm", "jp", "rsoc", "rsoc_compact"]
    assert len(tcol.ALGORITHMS) == len(jcol.ALGORITHMS) == 5
    assert repr(tcol.ALGORITHMS) == repr(jcol.ALGORITHMS)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for name in tcol.ALGORITHMS:
            fn = tcol.ALGORITHMS[name]
            assert fn.__name__ == jcol.ALGORITHMS[name].__name__
            assert_results_equal(jcol.ALGORITHMS[name](J_SUITE["pwtk"],
                                                       seed=3),
                                 fn(T_SUITE["pwtk"], seed=3, device="cpu"))
    with pytest.raises(KeyError):
        tcol.ALGORITHMS["luby"]
    assert "luby" not in tcol.ALGORITHMS and "cat" in tcol.ALGORITHMS


@pytest.mark.parametrize("algo", ALGOS)
def test_color_distance_d(algo):
    jr, jgd = jd2.color_distance_d(J_SUITE["mesh2d"], 2, algorithm=algo,
                                   seed=1)
    tr, tgd = td2.color_distance_d(T_SUITE["mesh2d"], 2, algorithm=algo,
                                   seed=1, device="cpu")
    np.testing.assert_array_equal(tgd.indices, jgd.indices)
    assert tr.distance == jr.distance == 2
    assert_results_equal(jr, tr)
    assert td2.is_distance_d_proper(T_SUITE["mesh2d"], tr.colors, 2)
    with pytest.raises(KeyError) as je:
        jd2.color_distance_d(J_SUITE["mesh2d"], 2, algorithm=algo + "x")
    with pytest.raises(KeyError) as te:
        td2.color_distance_d(T_SUITE["mesh2d"], 2, algorithm=algo + "x",
                             device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n_nodes,E", [(50, 400), (7, 0), (1, 9)])
def test_edge_color_by_dst(n_nodes, E):
    rng = np.random.default_rng(n_nodes + E)
    src = rng.integers(0, n_nodes, size=E).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=E).astype(np.int32)
    got, k = tsched.edge_color_by_dst(src, dst, n_nodes)
    want, kj = jsched.edge_color_by_dst(src, dst, n_nodes)
    assert k == kj and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for c in range(k):
        d = dst[got == c]
        assert len(np.unique(d)) == len(d)


@pytest.mark.parametrize("algo", ["rsoc", "cat", "jp"])
def test_vertex_schedule(algo):
    jsets, jr = jsched.vertex_schedule(J_SUITE["bmw3_2"], algo, seed=4)
    tsets, tr = tsched.vertex_schedule(T_SUITE["bmw3_2"], algo, seed=4,
                                       device="cpu")
    assert_results_equal(jr, tr)
    assert len(tsets) == len(jsets)
    for a, b in zip(tsets, jsets):
        np.testing.assert_array_equal(a, b)
    spec = tapi.ColoringSpec(algorithm=algo, seed=4, n_chunks=8)
    ssets, sr = tsched.vertex_schedule(T_SUITE["bmw3_2"], spec=spec,
                                       device="cpu")
    assert sr.spec == spec.resolved()
    assert sorted(np.concatenate(ssets).tolist()) == \
        list(range(T_SUITE["bmw3_2"].n_vertices))


def test_vertex_schedule_device_rule():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsched.vertex_schedule(T_SUITE["mesh2d"], "cat")


# ---- on a GPU: the kernel path against the plain path ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_cuda_baselines_match_cpu(cuda_device, algo):
    """CAT: first fit ``n_chunks`` launches (round 0), ``detect_recolor``
    ``n_chunks`` a round (phase A) and ``1 + n_rounds`` detect-only
    launches; GM: first fit ``n_chunks`` and one detect-only launch; JP: no
    launch and no dispatch."""
    for name, kw in (("mesh2d", {}), ("rmat_g", {}), ("rmat_b",
                                                      dict(ell_cap=6))):
        c0 = (firstfit.launches, detect_recolor.launches,
              detect_recolor.launches_detect)
        tobs.metrics.reset()
        gpu = tapi.color(T_SUITE[name], device=cuda_device, algorithm=algo,
                         **kw)
        disp = tobs.metrics.total_matching("kernels.dispatch")
        c1 = (firstfit.launches, detect_recolor.launches,
              detect_recolor.launches_detect)
        cpu = tapi.color(T_SUITE[name], device="cpu", algorithm=algo, **kw)
        assert_results_equal(cpu, gpu)
        d = tuple(b - a for a, b in zip(c0, c1))
        r = gpu.n_rounds
        want = {"cat": (16, 16 * r, 1 + r), "gm": (16, 0, 1),
                "jp": (0, 0, 0)}[algo]
        if gpu.retries == 0:
            assert d == want, (name, d, want)
        assert (disp == 0) == (algo == "jp")
    tobs.metrics.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 14, 17, 44, 45, 256, 260, 512])
def test_cuda_detect_only_matches_plain(cuda_device, W):
    """The detect-only form on both designs, bit-equal to the plain version,
    with and without ``extra_defect`` / ``valid``, a ragged R and row_ids;
    counted in ``launches_detect_<design>`` and not in ``launches``."""
    rng = np.random.default_rng(W)
    d = cuda_device
    n, R = 3000, 1500
    ell = torch.from_numpy(np.where(rng.random((R, W)) < 0.5, -1,
                                    rng.integers(0, n, size=(R, W)))
                           .astype(np.int32)).to(d)
    colors = _t(rng.integers(-1, 40, size=n).astype(np.int32)).to(d)
    pri = _t(rng.permutation(n).astype(np.int32)).to(d)
    U = _t(rng.random(R) < 0.7).to(d)
    opt = dict(extra_defect=_t(rng.random(R) < 0.2).to(d),
               valid=_t(rng.random(R) < 0.8).to(d))
    route = dr_mod.design(W)
    for kw in ({}, opt):
        b = (detect_recolor.launches,
             getattr(detect_recolor, f"launches_detect_{route}"))
        got = ops.detect_recolor(ell, colors, pri, U, 7, 64,
                                 detect_only=True, **kw)
        assert (detect_recolor.launches,
                getattr(detect_recolor, f"launches_detect_{route}")) == \
            (b[0], b[1] + 1)
        want = ref.detect_recolor_ref(ell, colors, pri, 7, U, 64,
                                      detect_only=True, **kw)
        assert torch.equal(got, want)
        assert torch.equal(got, ref.detect_recolor_ref(
            ell, colors, pri, 7, U, 64, **kw)[1])
