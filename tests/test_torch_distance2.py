"""The slice as a whole: distance-2, bipartite-partial and frontier-compacted
coloring through ``repro_torch.api.color(g, device="cpu")`` against
``repro.api.color(g)``, field by field, and the loops and oracles of
``core/distance2.py`` and ``core/frontier.py`` against the reference's.

Seeds drive numpy on the host and everything downstream is integer
arithmetic, so the bar is bit-equality (tolerance zero) on every
``ColoringResult`` field.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import registry as jregistry
from repro.core import coloring as jcol
from repro.core import distance2 as jd2
from repro.core import frontier as jfr
from repro.core.context import PassContext as JPassContext
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch import registry as tregistry
from repro_torch.core import coloring as tcol
from repro_torch.core import distance2 as td2
from repro_torch.core import frontier as tfr
from repro_torch.core.context import PassContext as TPassContext
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.twohop import twohop_detect_recolor

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

J_SUITE = jgen.paper_suite("tiny")
T_SUITE = tgen.paper_suite("tiny")
TINY = sorted(J_SUITE)
J_BIP = {"random": jgen.bipartite_random(80, 50, 3.0, seed=7),
         "banded": jgen.bipartite_banded(80, 50)}
T_BIP = {"random": tgen.bipartite_random(80, 50, 3.0, seed=7),
         "banded": tgen.bipartite_banded(80, 50)}

FIELDS = ("n_rounds", "total_conflicts", "n_colors", "overflow",
          "gather_passes", "final_C", "retries", "trace_truncated",
          "distance", "degrade_rung")


def assert_results_equal(jr, tr):
    assert tr.colors.dtype == np.int32 and jr.colors.dtype == np.int32
    np.testing.assert_array_equal(tr.colors, jr.colors, err_msg="colors")
    np.testing.assert_array_equal(np.asarray(tr.conflicts_per_round),
                                  np.asarray(jr.conflicts_per_round),
                                  err_msg="conflicts_per_round")
    for f in FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    if jr.spec is not None:
        assert tr.spec.spec_key() == jr.spec.spec_key()
    assert tr.summary() == jr.summary()


def both(jg, tg, **kw):
    jr = japi.color(jg, **kw)
    tr = tapi.color(tg, device="cpu", **kw)
    assert_results_equal(jr, tr)
    return jr, tr


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TINY)
def test_distance2_equals_reference(name, seed, impl):
    _, tr = both(J_SUITE[name], T_SUITE[name], distance=2, seed=seed,
                 forbidden_impl=impl)
    assert tr.distance == 2
    if name == "mesh2d":
        assert td2.is_distance_d_proper(T_SUITE[name], tr.colors, 2)


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("name", sorted(J_BIP))
def test_bipartite_partial_equals_reference(name, impl):
    _, tr = both(J_BIP[name], T_BIP[name], distance=2, mode="partial",
                 n_left=80, forbidden_impl=impl)
    assert tr.colors.shape == (80,)
    assert td2.is_bipartite_partial_proper(T_BIP[name], 80, tr.colors)
    assert jd2.is_bipartite_partial_proper(J_BIP[name], 80, tr.colors)


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("name", TINY)
def test_rsoc_compact_equals_reference(name, impl):
    _, tr = both(J_SUITE[name], T_SUITE[name], algorithm="rsoc_compact",
                 forbidden_impl=impl)
    assert tcol.is_proper(T_SUITE[name], tr.colors)


@pytest.mark.parametrize("name,kw", [
    ("rmat_b", dict(ell_cap=4)), ("rmat_b", dict(ell_cap=4, impl="dense")),
    ("rmat_g", dict(ell_cap=4, seed=1)),
    ("rmat_b", dict(ell_cap=6, C=8, n_chunks=7, max_rounds=10)),
    ("pwtk", dict(n_chunks=64, frontier_frac=0.5)),
])
def test_rsoc_compact_overflow_coo_and_options(name, kw):
    """``ell_cap`` below the max degree spills hubs into the overflow COO:
    the frontier-local snapshot and overflow-edge defects of
    ``_compact_pass``; plus cap doubling, odd chunk counts, a wide cap."""
    kw = dict(kw)
    _, tr = both(J_SUITE[name], T_SUITE[name], algorithm="rsoc_compact",
                 forbidden_impl=kw.pop("impl", "bitset"), **kw)
    assert tcol.is_proper(T_SUITE[name], tr.colors)


def test_rsoc_compact_rmat_b_2_13():
    """RMAT-B at 2^13 (hubs past ``ell_cap=512`` spill into the overflow COO)
    with the default spec: ``rsoc_compact`` equals the reference, and — as
    the reference does on this graph, and the card at 2^22 (PERF.md) — needs
    more rounds than ``rsoc``."""
    jg, tg = jgen.rmat_b(13), tgen.rmat_b(13)
    assert tg.max_degree > 512
    _, compact = both(jg, tg, algorithm="rsoc_compact")
    _, plain = both(jg, tg)
    assert compact.n_rounds > plain.n_rounds
    assert tcol.is_proper(tg, compact.colors)


@pytest.mark.parametrize("mode", ["static", "partial"])
def test_forced_cap_doubling_distance2(mode):
    """C=4 cannot hold a distance-2 coloring: the cap doubles until it fits,
    and the attempts that overflow run to ``max_rounds`` on both sides."""
    if mode == "static":
        jg, tg, extra = J_SUITE["mesh2d"], T_SUITE["mesh2d"], {}
    else:
        jg, tg = J_BIP["random"], T_BIP["random"]
        extra = dict(mode="partial", n_left=80)
    _, tr = both(jg, tg, distance=2, C=4, max_rounds=6, n_chunks=4, **extra)
    assert tr.retries > 0 and tr.overflow and tr.final_C == 4 << tr.retries


@pytest.mark.parametrize("name,kw", [
    ("bmw3_2", dict(distance=2)),
    ("random", dict(distance=2, mode="partial", n_left=80)),
    ("rmat_b", dict(algorithm="rsoc_compact", ell_cap=4)),
])
def test_traced_run_matches(name, kw):
    """The frontier trace (|U| per round) and the compaction cap reach the
    tracer as in the reference, and tracing changes no result."""
    jg = J_BIP.get(name, J_SUITE.get(name))
    tg = T_BIP.get(name, T_SUITE.get(name))
    jr, tr = both(jg, tg, trace=True, **kw)
    jt, tt = jr.trace, tr.trace
    assert [dataclasses.astuple(e) for e in tt.rounds] == \
        [dataclasses.astuple(e) for e in jt.rounds]
    assert any(e.compacted for e in tt.rounds)
    for f in ("spec_key", "engine", "n_vertices", "n_rounds", "retries",
              "final_C", "gather_passes", "total_conflicts", "n_colors",
              "truncated"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert [p.name for p in tt.phases] == [p.name for p in jt.phases]
    plain = tapi.color(tg, device="cpu", **kw)
    assert plain.trace is None
    np.testing.assert_array_equal(plain.colors, tr.colors)


def _problem(name, seed, n_chunks, ell_cap=512):
    """The reference's prepared problem, carried into the port through
    ``problem_from_numpy``, and both packages' contexts for it."""
    jp = jcol.prepare(J_SUITE[name], seed=seed, n_chunks=n_chunks,
                      ell_cap=ell_cap)
    tp = tcol.problem_from_numpy(
        np.asarray(jp.ell), np.asarray(jp.ovf_src), np.asarray(jp.ovf_dst),
        np.asarray(jp.pri), jp.n, jp.n_pad, jp.perm, jp.C, "cpu")
    jctx = JPassContext.for_problem(jp, n_chunks=n_chunks)
    tctx = TPassContext.for_problem(tp, n_chunks=n_chunks)
    return jp, tp, jctx, tctx


def _assert_loop_outputs_equal(jout, tout):
    assert len(jout) == len(tout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"out[{i}]")


@pytest.mark.parametrize("name,ell_cap,frac", [("mesh2d", 512, 0.125),
                                               ("rmat_b", 6, 0.25),
                                               ("pwtk", 512, 0.02)])
def test_externally_seeded_compact_repair_loop(name, ell_cap, frac):
    """``_repair_compact_loop`` from a damaged coloring: a fifth of the
    vertices uncolored (forced on their first pass), another fifth given a
    neighbour's color (defective), U = both sets; with a small cap the
    first rounds take the full-width pass."""
    jp, tp, jctx, tctx = _problem(name, 1, 8, ell_cap)
    cap = jfr.frontier_cap(jp.n_pad, 8, frac)
    assert cap == tfr.frontier_cap(tp.n_pad, 8, frac)
    rng = np.random.default_rng(3)
    base = np.asarray(jcol._rsoc_loop(jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri,
                                      jctx, 100)[0])
    colors = np.full(jp.n_pad, -1, np.int32)
    colors[:jp.n] = base
    ell = np.asarray(jp.ell)
    pick = rng.permutation(jp.n)
    wipe, clash = pick[:jp.n // 5], pick[jp.n // 5: 2 * jp.n // 5]
    clash = clash[ell[clash, 0] >= 0]
    colors[clash] = colors[ell[clash, 0]]
    colors[wipe] = -1
    U = np.zeros(jp.n_pad, bool)
    U[wipe] = U[clash] = True
    jout = jfr._repair_compact_loop(jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri,
                                    jnp.asarray(colors), jnp.asarray(U),
                                    jctx, cap, 100)
    t_colors = torch.from_numpy(colors.copy())
    tout = tfr._repair_compact_loop(tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri,
                                    t_colors, torch.from_numpy(U), tctx, cap,
                                    100)
    _assert_loop_outputs_equal(jout, tout)
    np.testing.assert_array_equal(t_colors.numpy(), colors)  # left as it was
    assert int(tout[1]) >= 2 and int(tout[3]) > 0


@pytest.mark.parametrize("trace", [False, True])
def test_d2_loop_runs_the_reference_problem(trace):
    """Same prepared arrays in, same ``_d2_loop`` outputs out, in the same
    tuple order (frontier trace spliced before (total, overflow))."""
    jp = jd2._prepare_native(J_SUITE["rmat_er"], 2, 8, None, True, 512)
    tp = tcol.problem_from_numpy(
        np.asarray(jp.ell), np.asarray(jp.ovf_src), np.asarray(jp.ovf_dst),
        np.asarray(jp.pri), jp.n, jp.n_pad, jp.perm, jp.C, "cpu")
    jctx = JPassContext.for_problem(jp, n_chunks=8, trace=trace)
    tctx = TPassContext.for_problem(tp, n_chunks=8, trace=trace)
    cap = jfr.frontier_cap(jp.n_pad, 8)
    mask = np.arange(jp.n_pad) < jp.n
    jout = jd2._d2_loop(jp.ell, jp.pri, jnp.asarray(mask), jctx, cap, 100)
    tout = td2._d2_loop(tp.ell, tp.pri, torch.from_numpy(mask), tctx, cap,
                        100)
    assert len(tout) == (6 if trace else 5)
    _assert_loop_outputs_equal(jout, tout)


def test_prepare_native_and_n_left_errors():
    g_j, g_t = J_SUITE["rmat_b"], T_SUITE["rmat_b"]
    with pytest.raises(ValueError) as je:
        jd2._prepare_native(g_j, 0, 16, None, True, 64)
    with pytest.raises(ValueError) as te:
        td2._prepare_native(g_t, 0, 16, None, True, 64)
    assert str(te.value) == str(je.value)
    assert "max_degree 125 > ell_cap 64" in str(te.value)
    with pytest.raises(ValueError) as te:
        tapi.color(g_t, device="cpu", distance=2, ell_cap=64)
    assert str(te.value) == str(je.value)
    for n_left in (0, 131, -1):
        with pytest.raises(ValueError) as je:
            japi.color(J_BIP["random"], distance=2, mode="partial",
                       n_left=n_left)
        with pytest.raises(ValueError) as te:
            tapi.color(T_BIP["random"], device="cpu", distance=2,
                       mode="partial", n_left=n_left)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        tapi.color(T_BIP["random"], device="cpu", distance=2, mode="partial")
    assert "requires n_left" in str(te.value)


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("n_chunks,C", [(16, None), (7, 100), (1, 33)])
def test_native_ws_mb_and_pick_C(n_chunks, C, impl):
    for name in TINY:
        assert td2.native_ws_mb(T_SUITE[name], n_chunks, C, impl) == \
            jd2.native_ws_mb(J_SUITE[name], n_chunks, C, impl)
        assert td2._pick_C_d2(T_SUITE[name], C) == \
            jd2._pick_C_d2(J_SUITE[name], C)


def test_oracles_and_materialized_path():
    g_j, g_t = J_SUITE["pwtk"], T_SUITE["pwtk"]
    jr, jgd = jd2.color_distance_d(g_j, 2, seed=1)
    tr, tgd = td2.color_distance_d(g_t, 2, seed=1, device="cpu")
    np.testing.assert_array_equal(tgd.indices, jgd.indices)
    assert tr.distance == jr.distance == 2
    np.testing.assert_array_equal(tr.colors, jr.colors)
    assert td2.is_distance_d_proper(g_t, tr.colors, 2)
    bad = tr.colors.copy()
    e = tgd.indices[0]
    bad[0] = bad[e]
    assert not td2.is_distance_d_proper(g_t, bad, 2)
    assert not jd2.is_distance_d_proper(g_j, bad, 2)
    # another distance-1 engine through ALGORITHMS, as the reference's
    jr_gm, _ = jd2.color_distance_d(g_j, 2, algorithm="gm", seed=1)
    tr_gm, _ = td2.color_distance_d(g_t, 2, algorithm="gm", seed=1,
                                    device="cpu")
    assert_results_equal(jr_gm, tr_gm)
    assert td2.is_distance_d_proper(g_t, tr_gm.colors, 2)
    with pytest.raises(KeyError) as je:
        jd2.color_distance_d(g_j, 2, algorithm="luby")
    with pytest.raises(KeyError) as te:
        td2.color_distance_d(g_t, 2, algorithm="luby", device="cpu")
    assert str(te.value) == str(je.value)
    for name in sorted(J_BIP):
        want = jd2.bipartite_partial_oracle(J_BIP[name], 80)
        got = td2.bipartite_partial_oracle(T_BIP[name], 80)
        np.testing.assert_array_equal(got, want)
        assert td2.is_bipartite_partial_proper(T_BIP[name], 80, got)
        clash = got.copy()
        clash[1:] = clash[0]
        assert td2.is_bipartite_partial_proper(T_BIP[name], 80, clash) == \
            jd2.is_bipartite_partial_proper(J_BIP[name], 80, clash)
        unc = got.copy()
        unc[3] = -1
        assert not td2.is_bipartite_partial_proper(T_BIP[name], 80, unc)


def test_legacy_shims_route_through_the_front_door():
    tregistry.reset_legacy_warnings()
    jregistry.reset_legacy_warnings()
    g_t, g_j = T_SUITE["mesh2d"], J_SUITE["mesh2d"]
    b_t, b_j = T_BIP["banded"], J_BIP["banded"]
    calls = [(td2.color_distance2, jd2.color_distance2, (g_t,), (g_j,), {}),
             (td2.color_bipartite_partial, jd2.color_bipartite_partial,
              (b_t, 80), (b_j, 80), {}),
             (tfr.color_rsoc_compact, jfr.color_rsoc_compact, (g_t,), (g_j,),
              dict(seed=2))]
    for tfn, jfn, targs, jargs, kw in calls:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr = tfn(*targs, device="cpu", **kw)
            tfn(*targs, device="cpu", **kw)
        assert sum(issubclass(x.category, DeprecationWarning)
                   for x in w) == 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jr = jfn(*jargs, **kw)
        assert_results_equal(jr, tr)
    tregistry.reset_legacy_warnings()
    jregistry.reset_legacy_warnings()


# ---- on a GPU: the kernel path against the plain path ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(distance=2),
                                dict(algorithm="rsoc_compact", ell_cap=4)],
                         ids=["distance2", "rsoc_compact"])
def test_cuda_engines_match_cpu(cuda_device, kw):
    for name in ("mesh2d", "rmat_g"):
        before = twohop_detect_recolor.launches
        gpu = tapi.color(T_SUITE[name], device=cuda_device, **kw)
        cpu = tapi.color(T_SUITE[name], device="cpu", **kw)
        assert_results_equal(cpu, gpu)
        if kw.get("distance") == 2 and gpu.retries == 0:
            assert twohop_detect_recolor.launches - before == \
                16 * (1 + gpu.n_rounds)
