"""The slice as a whole: ``repro_torch.api.color(g, device="cpu")`` against
``repro.api.color(g)``, field by field.

Both sides get the same graph and spec; seeds drive numpy on the host, and
everything downstream is integer arithmetic, so the bar is bit-equality
(tolerance zero) on every ``ColoringResult`` field.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import registry as jregistry
from repro.core import coloring as jcol
from repro.core.context import PassContext as JPassContext
from repro.graphs.generators import paper_suite as j_paper_suite
from repro.resilience.errors import CapRetryExhausted as JCapRetryExhausted
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import registry as tregistry
from repro_torch.core import coloring as tcol
from repro_torch.core.context import PassContext as TPassContext
from repro_torch.graphs.generators import paper_suite as t_paper_suite
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience.errors import CapRetryExhausted

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

J_SUITE = j_paper_suite("tiny")
T_SUITE = t_paper_suite("tiny")
TINY = sorted(J_SUITE)

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
    assert tr.spec.spec_key() == jr.spec.spec_key()
    assert tr.spec.asdict() == jr.spec.asdict()
    assert tr.summary() == jr.summary()


def both(name, **kw):
    jr = japi.color(J_SUITE[name], **kw)
    tr = tapi.color(T_SUITE[name], device="cpu", **kw)
    assert_results_equal(jr, tr)
    assert tcol.is_proper(T_SUITE[name], tr.colors)
    return jr, tr


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TINY)
def test_color_equals_reference(name, seed, impl):
    both(name, seed=seed, forbidden_impl=impl)


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("name", ["mesh2d", "rmat_b"])
def test_forced_cap_doubling(name, impl):
    """C=4 cannot hold these graphs: the cap doubles until it fits, and the
    attempts that overflow run to ``max_rounds`` on both sides."""
    jr, tr = both(name, C=4, max_rounds=12, n_chunks=4, forbidden_impl=impl)
    assert tr.retries > 0 and tr.overflow and tr.final_C == 4 << tr.retries


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("name,ell_cap", [("rmat_b", 4), ("rmat_g", 4),
                                          ("bmw3_2", 3)])
def test_overflow_coo(name, ell_cap, impl):
    """``ell_cap`` below the max degree: hub rows spill into the COO side
    channel, exercising the snapshot table and the overflow-edge defects."""
    both(name, ell_cap=ell_cap, forbidden_impl=impl)


@pytest.mark.parametrize("n_chunks", [1, 16, 64])
@pytest.mark.parametrize("name", ["pwtk", "rmat_er"])
def test_n_chunks(name, n_chunks):
    both(name, n_chunks=n_chunks)


@pytest.mark.parametrize("name", TINY)
def test_relabel_false(name):
    both(name, relabel=False, seed=1)


def test_overflow_coo_with_cap_doubling_and_odd_chunks():
    both("rmat_b", ell_cap=4, C=8, n_chunks=7, max_rounds=20)


@pytest.mark.parametrize("name", ["mesh2d", "rmat_g"])
def test_traced_run_matches(name):
    jr, tr = both(name, trace=True)
    jt, tt = jr.trace, tr.trace
    assert [dataclasses.astuple(e) for e in tt.rounds] == \
        [dataclasses.astuple(e) for e in jt.rounds]
    assert all(e.frontier >= e.conflicts >= 0 for e in tt.rounds)
    for f in ("spec_key", "engine", "n_vertices", "n_rounds", "retries",
              "final_C", "gather_passes", "total_conflicts", "n_colors",
              "truncated"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert [p.name for p in tt.phases] == [p.name for p in jt.phases]
    assert [p.meta for p in tt.phases] == [p.meta for p in jt.phases]
    np.testing.assert_array_equal(tt.conflicts_per_round,
                                  tr.conflicts_per_round)
    # an untraced call carries no trace and the same colors
    plain = tapi.color(T_SUITE[name], device="cpu")
    assert plain.trace is None
    np.testing.assert_array_equal(plain.colors, tr.colors)


def test_trace_scope_collects():
    with tobs.trace() as tc:
        res = tapi.color(T_SUITE["mesh2d"], device="cpu")
    assert len(tc) == 1 and res.trace is tc.traces[0]
    assert res.spec.trace is False
    assert tc.traces[0].summary_line().startswith("trace[algorithm='rsoc'")


def test_max_cap_retries_exhausted():
    kw = dict(C=4, max_rounds=6, n_chunks=4, max_cap_retries=0)
    with pytest.raises(JCapRetryExhausted) as je:
        japi.color(J_SUITE["rmat_b"], **kw)
    with pytest.raises(CapRetryExhausted) as te:
        tapi.color(T_SUITE["rmat_b"], device="cpu", **kw)
    assert str(te.value) == str(je.value)
    assert (te.value.engine, te.value.C, te.value.retries, te.value.budget,
            te.value.forced) == ("rsoc", 4, 0, 0, False)


def test_cap_exhaust_fault_site_and_retry_counter():
    with tfaults.inject("cap.exhaust"):
        with pytest.raises(CapRetryExhausted) as e:
            tapi.color(T_SUITE["mesh2d"], device="cpu")
    assert e.value.forced
    before = tobs.metrics.counter_value("engine.cap_retry", engine="rsoc")
    res = tapi.color(T_SUITE["mesh2d"], device="cpu", C=4, max_rounds=6,
                     n_chunks=4)
    assert tobs.metrics.counter_value("engine.cap_retry", engine="rsoc") \
        == before + res.retries > before


def _loops(name, seed, n_chunks, C=None, ell_cap=512, trace=False):
    """The reference's prepared problem, carried into the port through
    ``problem_from_numpy``, and both packages' contexts for it."""
    jp = jcol.prepare(J_SUITE[name], seed=seed, n_chunks=n_chunks,
                      ell_cap=ell_cap, C=C)
    tp = tcol.problem_from_numpy(
        np.asarray(jp.ell), np.asarray(jp.ovf_src), np.asarray(jp.ovf_dst),
        np.asarray(jp.pri), jp.n, jp.n_pad, jp.perm, jp.C, "cpu")
    jctx = JPassContext.for_problem(jp, n_chunks=n_chunks, trace=trace)
    tctx = TPassContext.for_problem(tp, n_chunks=n_chunks, trace=trace)
    assert dataclasses.asdict(jctx) == dataclasses.asdict(tctx)
    return jp, tp, jctx, tctx


def _assert_loop_outputs_equal(jout, tout):
    assert len(jout) == len(tout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"out[{i}]")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name,ell_cap", [("pwtk", 512), ("rmat_b", 6)])
def test_problem_from_numpy_runs_the_reference_problem(name, ell_cap, trace):
    """Same arrays in, same loop outputs out — in the same tuple order (5
    elements untraced, 6 traced with the frontier trace spliced before the
    trailing (total, overflow) pair)."""
    jp, tp, jctx, tctx = _loops(name, 2, 8, ell_cap=ell_cap, trace=trace)
    jout = jcol._rsoc_loop(jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri, jctx, 100)
    tout = tcol._rsoc_loop(tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri, tctx, 100)
    assert len(tout) == (6 if trace else 5)
    _assert_loop_outputs_equal(jout, tout)
    assert not bool(tout[-1])


@pytest.mark.parametrize("name,ell_cap", [("mesh2d", 512), ("rmat_b", 6)])
def test_externally_seeded_repair_loop(name, ell_cap):
    """``_rsoc_repair_loop`` from a damaged coloring: a fifth of the
    vertices uncolored (forced on their first pass), another fifth given
    their neighbour's color (defective), U = both sets."""
    jp, tp, jctx, tctx = _loops(name, 1, 8, ell_cap=ell_cap)
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
    jout = jcol._rsoc_repair_loop(jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri,
                                  jnp.asarray(colors), jnp.asarray(U), jctx,
                                  100)
    t_colors = torch.from_numpy(colors.copy())
    tout = tcol._rsoc_repair_loop(tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri,
                                  t_colors, torch.from_numpy(U), tctx, 100)
    _assert_loop_outputs_equal(jout, tout)
    # the caller's tensor is left as it was
    np.testing.assert_array_equal(t_colors.numpy(), colors)
    assert int(tout[1]) >= 2 and int(tout[3]) > 0


# combos neither package runs (CAT, GM and JP themselves are ported: their
# cases ask for a distance, mode or backend they lack; so are the
# distributed engines: the "incremental" and "distributed" cases ask for a
# distributed distance 2 and a distributed GM, and a distributed JP's
# nearest spec is now the distributed CAT, as in the reference); the ids
# are the cases' ids from before those engines were ported
_UNSUPPORTED = [
    (dict(algorithm="cat", distance=2), ("rsoc", 2, "static", "local")),
    (dict(algorithm="gm", mode="partial", n_left=3),
     ("rsoc", 2, "partial", "local")),
    (dict(distance=2, backend="distributed"),
     ("rsoc", 2, "static", "local")),
    (dict(algorithm="gm", backend="distributed"),
     ("cat", 1, "static", "distributed")),
    (dict(algorithm="jp", backend="distributed"),
     ("cat", 1, "static", "distributed"))]


@pytest.mark.parametrize("kw,near", _UNSUPPORTED,
                         ids=["cat", "gm", "incremental", "distributed",
                              "jp"])
def test_unsupported_specs_name_the_ported_engine(kw, near):
    with pytest.raises(ValueError) as e:
        tapi.ColoringSpec(**kw).validate()
    key = (kw.get("algorithm", "rsoc"), kw.get("distance", 1),
           kw.get("mode", "static"), kw.get("backend", "local"))
    assert not tregistry.has_engine(*key)
    assert tregistry.nearest_key(key) == near
    assert ("nearest supported spec: " + tregistry.format_key(near)) \
        in str(e.value)
    if not jregistry.has_engine(*key) and \
            tregistry.has_engine(*jregistry.nearest_key(key)):
        # a combo neither package runs, whose nearest spec in the reference
        # the port runs too: both name it
        assert jregistry.nearest_key(key) == near
        with pytest.raises(ValueError) as je:
            japi.ColoringSpec(**kw).validate()
        assert str(e.value) == str(je.value).replace("repro.api",
                                                     "repro_torch.api")
    with pytest.raises(ValueError):
        tapi.color(T_SUITE["mesh2d"], device="cpu", **kw)


def test_spec_and_surface_parity():
    assert tapi.SPEC_FIELDS == japi.SPEC_FIELDS
    assert tapi.MODES == japi.MODES and tapi.BACKENDS == japi.BACKENDS
    assert tapi.ColoringSpec().asdict() == japi.ColoringSpec().asdict()
    assert tapi.ColoringSpec(seed=3, C=64).spec_key() == \
        japi.ColoringSpec(seed=3, C=64).spec_key()
    assert "device" not in tapi.SPEC_FIELDS
    ported = [("cat", 1, "static", "distributed"),
              ("cat", 1, "static", "local"), ("gm", 1, "static", "local"),
              ("jp", 1, "static", "local"),
              ("rsoc", 1, "incremental", "distributed"),
              ("rsoc", 1, "incremental", "local"),
              ("rsoc", 1, "static", "distributed"),
              ("rsoc", 1, "static", "local"), ("rsoc", 2, "partial", "local"),
              ("rsoc", 2, "static", "local"),
              ("rsoc_compact", 1, "static", "local")]
    key = lambda r: (r["algorithm"], r["distance"], r["mode"], r["backend"])
    assert [key(r) for r in tapi.supported_specs()] == ported
    assert tapi.algorithms() == japi.algorithms() == \
        ["cat", "gm", "jp", "rsoc", "rsoc_compact"]
    assert tapi.algorithms(distance=2) == ["rsoc"]
    assert tapi.algorithms(distance=2, mode="partial") == ["rsoc"]
    rows = [r for r in japi.supported_specs() if key(r) in ported]
    assert rows == tapi.supported_specs() == japi.supported_specs()
    assert {r["replaces"] for r in rows} == {
        "color_rsoc", "color_rsoc_compact", "color_distance2",
        "color_bipartite_partial", "color_cat", "color_gm", "color_jp",
        "dynamic_state", "color_distributed", "sharded_state"}
    for bad in (dict(n_chunks=0), dict(C=0), dict(max_rounds=0),
                dict(forbidden_impl="sparse"), dict(mode="nope"),
                dict(n_left=3)):
        with pytest.raises(ValueError) as te:
            tapi.ColoringSpec(**bad).validate()
        with pytest.raises(ValueError) as je:
            japi.ColoringSpec(**bad).validate()
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError, match="unknown ColoringSpec override"):
        tapi.color(T_SUITE["mesh2d"], device="cpu", colour=1)
    with pytest.raises(TypeError, match="spec must be a ColoringSpec"):
        tapi.color(T_SUITE["mesh2d"], {"seed": 1}, device="cpu")
    with pytest.raises(ValueError, match="only meaningful with backend"):
        tapi.color(T_SUITE["mesh2d"], device="cpu", mesh=object())


def test_device_rule():
    """No ``device`` means the GPU; without one the call raises instead of
    carrying on on the CPU."""
    g = T_SUITE["mesh2d"]
    if torch.cuda.is_available():
        res = tapi.color(g)
        np.testing.assert_array_equal(
            res.colors, tapi.color(g, device="cpu").colors)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.color(g)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.color(g, device="cuda")
    spec = tapi.ColoringSpec(seed=2)
    a = tapi.color(g, spec, device="cpu")
    b = tapi.color(g, spec, device=torch.device("cpu"), n_chunks=16)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert a.spec == b.spec == spec.resolved()


@pytest.mark.parametrize("impl", ["bitset", "dense"])
@pytest.mark.parametrize("C", [4, 33, 64])
def test_pass_primitives_match_reference(C, impl):
    """The plain-torch primitives around the kernels (gather, forbidden
    tables in both representations, COO snapshot, overflow-edge defects)
    against the reference's jnp ones on random data with dead (FILL) COO
    slots and out-of-cap colors."""
    rng = np.random.default_rng(C)
    n, W, m = 96, 7, 300
    ell = rng.integers(-1, n, size=(n, W)).astype(np.int32)
    colors = rng.integers(-1, C + 2, size=n).astype(np.int32)
    pri = rng.permutation(n).astype(np.int32)
    src = rng.integers(-1, n, size=m).astype(np.int32)
    dst = rng.integers(-1, n, size=m).astype(np.int32)
    J = lambda *a: [jnp.asarray(x) for x in a]
    T = lambda *a: [torch.from_numpy(x.copy()) for x in a]
    jell, jc, jp, js, jd = J(ell, colors, pri, src, dst)
    tell, tc, tp, ts, td = T(ell, colors, pri, src, dst)

    def eq(t, j, name):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)

    jn, tn = jcol._gather_nbr(jell, jc, jp), tcol._gather_nbr(tell, tc, tp)
    eq(tn[0], jn[0], "nbrc")
    eq(tn[1], jn[1], "nbrp")
    jf, tf = jcol._forbidden(jn[0], C, impl), tcol._forbidden(tn[0], C, impl)
    eq(tf, jf, "forbidden")
    js_, ts_ = (jcol._snapshot_coo(js, jd, jc, n, C, impl),
                tcol._snapshot_coo(ts, td, tc, n, C, impl))
    eq(ts_, js_, "snapshot_coo")
    jm_, tm_ = (jcol._merge_forbidden(jf, js_, impl),
                tcol._merge_forbidden(tf, ts_, impl))
    eq(tm_, jm_, "merge_forbidden")
    for t, j, nm in zip(tcol._mex_of(tm_, C, impl),
                        jcol._mex_of(jm_, C, impl), ("mex", "ovf")):
        eq(t, j, nm)
    eq(tcol._ovf_conflict(ts, td, tc, tp, n),
       jcol._ovf_conflict(js, jd, jc, jp, n), "ovf_conflict")
    eq(tcol._forbidden_coo(ts, td, tc, n, C),
       jcol._forbidden_coo(js, jd, jc, n, C), "forbidden_coo")
