"""The port's degradation ladder, transactional steps, quarantine and heal
against the reference's (``repro_torch.resilience.ladder``,
``repro_torch.dynamic.service`` on the CPU against ``repro.resilience`` /
``repro.dynamic.service``).

Each case runs the same numpy-made batches under the same fault specs
(``faults.inject`` on both packages' fault registries, which fire alike:
the port's is a copy) and holds the port's outcome — rung, state fields,
colours, versions, rollback and quarantine records — equal to the
reference's.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.dynamic import incremental as jinc
from repro.dynamic.service import ColoringService as JService
from repro.graphs import csr as jcsr
from repro.resilience import faults as jfaults
from repro.resilience import ladder as jladder
from repro.resilience.errors import OvfGrowthExhausted as JOvfExhausted
from repro_torch import api as tapi
from repro_torch.core import coloring as tcol
from repro_torch.dynamic import incremental as tinc
from repro_torch.dynamic.service import ColoringService as TService
from repro_torch.graphs import csr as tcsr
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import ladder as tladder
from repro_torch.resilience.errors import (OvfGrowthExhausted,
                                           QuarantinedError)

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

OPTS = dict(seed=0, n_chunks=2, ell_cap=6, C=16, ovf_cap=64, delta_cap=32,
            frontier_frac=0.5)
N = 64


def _edges(s: int = 0, n: int = N, m: int = 150):
    r = np.random.default_rng(s)
    e = r.integers(0, n, (m, 2))
    return e[e[:, 0] != e[:, 1]]


def _graphs(s: int = 0, n: int = N, m: int = 150):
    e = _edges(s, n, m)
    return jcsr.from_edges(n, e), tcsr.from_edges(n, e)


def _clique(n: int):
    e = np.array([(u, v) for u in range(n) for v in range(u + 1, n)],
                 np.int64)
    return jcsr.from_edges(n, e), tcsr.from_edges(n, e)


def _batch(r, n: int = N, k: int = 8):
    ins = r.integers(0, n, (k, 2))
    ins = ins[ins[:, 0] != ins[:, 1]]
    return ins, r.integers(0, n, (3, 2))


@contextlib.contextmanager
def inject(spec):
    """Arm the same fault spec in both packages."""
    with jfaults.inject(spec), tfaults.inject(spec):
        yield


@pytest.fixture(autouse=True)
def _faults_off():
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


SCALARS = tuple(f.name for f in dataclasses.fields(tinc.DynamicColoringState)
                if f.name not in tinc.TENSOR_FIELDS + ("perm", "inv_perm"))


def assert_states_equal(js, ts, what=""):
    for f in tinc.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what}: {f}")
    for f in SCALARS:
        assert getattr(ts, f) == getattr(js, f), (what, f)
    np.testing.assert_array_equal(ts.perm, js.perm)
    np.testing.assert_array_equal(ts.colors, js.colors)


def _states(s=0, **kw):
    jg, tg = _graphs(s)
    js = japi.color(jg, mode="incremental", **{**OPTS, **kw}).state
    ts = tapi.color(tg, mode="incremental", device="cpu",
                    **{**OPTS, **kw}).state
    assert_states_equal(js, ts, "start")
    return js, ts


def _services(**kw):
    j = JService(**{**OPTS, **kw})
    t = TService(device="cpu", **{**OPTS, **kw})
    return j, t


def _assert_services_equal(j, t, names):
    for nm in names:
        assert (j.quarantined(nm) is None) == (t.quarantined(nm) is None), nm
        np.testing.assert_array_equal(t.colors(nm), j.colors(nm), err_msg=nm)
        assert t.version(nm) == j.version(nm), nm
        assert t.stats(nm) == j.stats(nm), nm
        assert t.pending(nm) == j.pending(nm), nm


# --------------------------------------------------------------------------
# budgets and the ladder's rungs
# --------------------------------------------------------------------------

def test_budgets_unused_are_bit_identical():
    js, ts = _states(1, max_cap_retries=10, max_ovf_growth=10)
    b = _batch(np.random.default_rng(2))
    assert_states_equal(jinc.recolor_incremental(js, *b),
                        tinc.recolor_incremental(ts, *b), "batch")


def test_genuine_ovf_exhaustion_raises():
    jg, tg = _graphs(3, n=32, m=60)
    kw = dict(n_chunks=2, ell_cap=2, ell_slack=0, ovf_cap=8, delta_cap=16,
              max_ovf_growth=0)
    js = jinc.dynamic_state(jg, **kw)
    ts = tinc.dynamic_state(tg, device="cpu", **kw)
    r = np.random.default_rng(5)
    ins = r.integers(0, 32, (60, 2))
    ins = ins[ins[:, 0] != ins[:, 1]]
    with pytest.raises(JOvfExhausted) as je:
        jinc.recolor_incremental(js, inserts=ins)
    with pytest.raises(OvfGrowthExhausted) as te:
        tinc.recolor_incremental(ts, inserts=ins)
    assert (te.value.grows, te.value.budget, te.value.forced) == \
        (je.value.grows, je.value.budget, je.value.forced)
    # unbounded budget applies the same batch by growing, alike
    assert_states_equal(
        jinc.recolor_incremental(
            dataclasses.replace(js, max_ovf_growth=None), inserts=ins),
        tinc.recolor_incremental(
            dataclasses.replace(ts, max_ovf_growth=None), inserts=ins),
        "grown")


@pytest.mark.parametrize("spec,rung", [(None, 0), ("ovf.exhaust", 1),
                                       ("cap.exhaust", 2)],
                         ids=["rung0", "rung1-scratch", "rung2-oracle"])
def test_ladder_rungs_equal_reference(spec, rung):
    js, ts = _states(0)
    ins, dels = _batch(np.random.default_rng(7 + rung))
    with (inject(spec) if spec else contextlib.nullcontext()):
        jst, jr = jladder.apply_with_ladder(js, ins, dels)
        tst, tr = tladder.apply_with_ladder(ts, ins, dels)
    assert tr == jr == rung and tst.last_degrade_rung == rung
    assert_states_equal(jst, tst, f"rung {rung}")
    assert tst.version == ts.version + 1
    assert tcol.is_proper(tladder.updated_graph(ts, ins, dels), tst.colors)


def test_updated_graph_equals_reference():
    js, ts = _states(4)
    ins, dels = _batch(np.random.default_rng(4), k=20)
    jg = jladder.updated_graph(js, ins, dels)
    tg = tladder.updated_graph(ts, ins, dels)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)


def test_incremental_engine_falls_back_to_oracle_encode():
    jg, tg = _clique(16)
    kw = dict(mode="incremental", C=4, max_cap_retries=0, n_chunks=2,
              delta_cap=16)
    jr = japi.color(jg, **kw)
    tr = tapi.color(tg, device="cpu", **kw)
    assert tr.degrade_rung == jr.degrade_rung == 2
    assert_states_equal(jr.state, tr.state, "oracle encode")
    assert_states_equal(jinc.recolor_incremental(jr.state, inserts=[[0, 1]]),
                        tinc.recolor_incremental(tr.state, inserts=[[0, 1]]),
                        "after")


# --------------------------------------------------------------------------
# transactional steps: rollback, quarantine, heal
# --------------------------------------------------------------------------

def test_rollback_is_bit_exact_and_requeues():
    svcs = _services(megabatch=False, quarantine_after=99)
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("a", g)
    ins, dels = _batch(np.random.default_rng(1))
    before = svcs[1].snapshot("a")
    with inject("service.step:times=1"):
        stats = []
        for svc in svcs:
            svc.submit("a", inserts=ins, deletes=dels)
            stats.append(dict(svc.step("a")["a"]))
    assert stats[1] == stats[0] and stats[1]["rolled_back"] == "injected"
    assert svcs[1].snapshot("a") is before and svcs[1].pending("a") == 1
    for svc in svcs:
        svc.step("a")
    _assert_services_equal(*svcs, ["a"])
    assert svcs[1].version("a") == 1


def test_quarantine_then_heal_replay():
    r = np.random.default_rng(2)
    batches = [_batch(r) for _ in range(3)]
    svcs = _services(megabatch=False, quarantine_after=2)
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("a", g)
    with inject("service.step"):
        for ins, dels in batches[:2]:
            for svc in svcs:
                svc.submit("a", inserts=ins, deletes=dels)
                svc.step("a")
        with pytest.raises(QuarantinedError):
            svcs[1].submit("a", inserts=batches[2][0])
    qs = [svc.quarantined("a") for svc in svcs]
    assert (qs[1].reason, qs[1].failures, qs[1].since_version) == \
        (qs[0].reason, qs[0].failures, qs[0].since_version)
    letters = [svc.dead_letters("a") for svc in svcs]
    assert len(letters[1]) == len(letters[0]) == 1
    assert letters[1][0].n_edges() == letters[0][0].n_edges()
    assert [svc.heal("a") for svc in svcs] == [2, 2]
    for svc in svcs:
        svc.submit("a", inserts=batches[2][0], deletes=batches[2][1])
        svc.step("a")
    _assert_services_equal(*svcs, ["a"])
    assert svcs[1].dead_letters("a") == []


def test_heal_scratch():
    svcs = _services(megabatch=False, quarantine_after=1)
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("a", g)
    ins, dels = _batch(np.random.default_rng(3))
    with inject("service.step"):
        for svc in svcs:
            svc.submit("a", inserts=ins, deletes=dels)
            svc.step("a")
    assert [svc.heal("a", mode="scratch") for svc in svcs] == [1, 1]
    _assert_services_equal(*svcs, ["a"])
    assert len(svcs[1].dead_letters("a")) == 1
    with pytest.raises(ValueError, match="not quarantined"):
        svcs[1].heal("a")


def test_corrupt_step_caught_by_verification():
    svcs = _services(megabatch=False, quarantine_after=99)
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("a", g)
    ins, dels = _batch(np.random.default_rng(4))
    with inject("color.corrupt:times=1:k=3"):
        for svc in svcs:
            svc.submit("a", inserts=ins, deletes=dels)
            assert svc.step("a")["a"]["rolled_back"] == "improper"
            assert svc.version("a") == 0
            svc.step("a")
    _assert_services_equal(*svcs, ["a"])
    assert tcol.is_proper(svcs[1].graph("a"), svcs[1].colors("a"))


def test_budget_exhaustion_degrades_and_commits():
    svcs = _services(megabatch=False)
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("a", g)
    ins, dels = _batch(np.random.default_rng(6))
    with inject("ovf.exhaust"):
        for svc in svcs:
            svc.submit("a", inserts=ins, deletes=dels)
            stats = svc.step("a")
            assert "rolled_back" not in stats["a"]
            assert stats["a"]["degrade_rung"] == 1
    _assert_services_equal(*svcs, ["a"])


def test_mega_group_fault_falls_back_to_per_tenant():
    svcs = _services(megabatch=True, megabatch_min=2, quarantine_after=99)
    r = np.random.default_rng(7)
    bs = [_batch(r) for _ in range(2)]
    for svc, g in zip(svcs, _graphs(0)):
        svc.add_graph("x", g)
        svc.add_graph("y", g)
    with inject("service.step:times=1"):
        for svc in svcs:
            for nm, (ins, dels) in zip(("x", "y"), bs):
                svc.submit(nm, inserts=ins, deletes=dels)
            svc.step()
    _assert_services_equal(*svcs, ["x", "y"])
    assert svcs[1].version("x") == 1


def test_submit_validation_equals_reference():
    svcs = _services()
    for svc, g in zip(svcs, _graphs(2)):
        svc.add_graph("z", g)
    for bad in ([[3, 3]], np.array([[1.5, 2.0]]), [[0, N + 5]], [[1, 2, 3]]):
        msgs = []
        for svc in svcs:
            with pytest.raises(ValueError) as e:
                svc.submit("z", inserts=bad)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    assert svcs[1].pending("z") == 0
    svcs[1].submit("z", deletes=[[3, 3]])
    assert svcs[1].pending("z") == 1


def test_restore_flushes_pending_and_latency_history():
    svc = TService(megabatch=False, device="cpu", **OPTS)
    svc.add_graph("rst-port", _graphs(0)[1])
    snap = svc.snapshot("rst-port")
    r = np.random.default_rng(8)
    svc.submit("rst-port", *_batch(r))
    svc.step("rst-port")
    assert svc.step_latency("rst-port")["count"] == 1
    svc.submit("rst-port", inserts=_batch(r)[0])
    assert svc.restore("rst-port", snap) == 2
    assert svc.pending("rst-port") == 0
    assert svc.step_latency("rst-port")["count"] == 0
    np.testing.assert_array_equal(svc.colors("rst-port"), snap.colors)


# --------------------------------------------------------------------------
# the reference's stateful fuzz, run on both packages in lockstep
# --------------------------------------------------------------------------

def _fuzz_round(pair, r, names):
    op = r.choice(["submit", "step", "step_one", "snapshot_restore",
                   "chaos_step", "remove_add"])
    nm = str(r.choice(names))
    if op == "submit":
        ins, dels = _batch(r)
        for svc in pair:
            with contextlib.suppress(Exception):
                svc.submit(nm, inserts=ins, deletes=dels)
    elif op == "step":
        for svc in pair:
            svc.step()
    elif op == "step_one":
        for svc in pair:
            svc.step(nm)
    elif op == "snapshot_restore":
        ins, dels = _batch(r)
        for svc in pair:
            snap = svc.snapshot(nm)
            with contextlib.suppress(Exception):
                svc.submit(nm, inserts=ins, deletes=dels)
                svc.step(nm)
            svc.restore(nm, snap)
    elif op == "chaos_step":
        spec = "service.step:times=1:seed=%d" % r.integers(0, 1000)
        with jfaults.inject(spec):
            pair[0].step()
        with tfaults.inject(spec):
            pair[1].step()
        for svc, f in zip(pair, (jfaults, tfaults)):
            with f.suppress():
                for qn in list(svc.quarantined()):
                    svc.heal(qn)
    elif op == "remove_add":
        s = int(r.integers(0, 100))
        for svc, g in zip(pair, _graphs(s)):
            svc.remove_graph(nm)
            svc.add_graph(nm, g)
    _assert_services_equal(*pair, names)


@pytest.mark.parametrize("megabatch", [False, True])
def test_stateful_fuzz_equals_reference(megabatch):
    names = [f"fz{int(megabatch)}{i}" for i in range(3)]
    r = np.random.default_rng(123 + megabatch)
    pair = _services(megabatch=megabatch, megabatch_min=2, quarantine_after=2)
    for i, nm in enumerate(names):
        for svc, g in zip(pair, _graphs(i)):
            svc.add_graph(nm, g)
    for _ in range(20):
        _fuzz_round(pair, r, names)
