"""The port's dynamic subsystem against the reference's: the delta wave
bodies, ``apply_updates``, ``dynamic_state`` and ``recolor_incremental``
(``repro_torch.dynamic`` on the CPU against ``repro.dynamic``).

Both sides get the same numpy-made, seeded inputs; everything is integer
arithmetic, so the bar is bit-equality (tolerance zero) on every array and
every state field, after every batch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfrontier
from repro.dynamic import delta as jdelta
from repro.dynamic import incremental as jinc
from repro.graphs import generators as jgen
from repro.graphs.csr import to_edge_list as j_to_edge_list
from repro_torch.core import coloring as tcol
from repro_torch.core import frontier as tfrontier
from repro_torch.dynamic import delta as tdelta
from repro_torch.dynamic import incremental as tinc
from repro_torch.graphs import generators as tgen

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

SCALAR_FIELDS = tuple(
    f.name for f in dataclasses.fields(tinc.DynamicColoringState)
    if f.name not in tinc.TENSOR_FIELDS + ("perm", "inv_perm"))


def assert_states_equal(js, ts, what=""):
    """Every field of a reference state equals the port's."""
    for f in tinc.TENSOR_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype == np.int32, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")
    for f in SCALAR_FIELDS:
        assert getattr(ts, f) == getattr(js, f), (what, f)
    np.testing.assert_array_equal(ts.perm, js.perm)
    np.testing.assert_array_equal(ts.inv_perm, js.inv_perm)
    np.testing.assert_array_equal(ts.colors, js.colors)
    assert ts.summary() == js.summary(), what


def both_states(jg, tg, **opts):
    js = jinc.dynamic_state(jg, **opts)
    ts = tinc.dynamic_state(tg, device="cpu", **opts)
    assert_states_equal(js, ts, "dynamic_state")
    return js, ts


def edge_set(edges):
    e = np.asarray(edges).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    return set(map(tuple, np.sort(e, axis=1).tolist()))


def random_batch(rng, n, und, n_ins, n_del):
    ins = rng.integers(0, n, size=(n_ins, 2))
    ins = ins[ins[:, 0] != ins[:, 1]]
    dels = (und[rng.choice(len(und), size=min(n_del, len(und)),
                           replace=False)]
            if n_del and len(und) else np.zeros((0, 2), np.int64))
    return ins, dels


def undirected(g):
    e = j_to_edge_list(g)
    return e[e[:, 0] < e[:, 1]]


# --------------------------------------------------------------------------
# the wave bodies, array for array
# --------------------------------------------------------------------------

def _tables(rng, n_pad=64, W=6, ocap=40, n_ovf=25):
    ell = rng.integers(0, n_pad, size=(n_pad, W)).astype(np.int32)
    ell[rng.random((n_pad, W)) < 0.4] = -1
    osrc = np.full(ocap, -1, np.int32)
    odst = np.full(ocap, -1, np.int32)
    live = rng.permutation(ocap)[:n_ovf]
    osrc[live] = rng.integers(0, n_pad, n_ovf)
    odst[live] = rng.integers(0, n_pad, n_ovf)
    return ell, osrc, odst


def _wave(rng, n_pad, k, cap, unique_rows=True):
    a = (rng.permutation(n_pad)[:k] if unique_rows
         else rng.integers(0, n_pad, k)).astype(np.int32)
    b = rng.integers(0, n_pad, k).astype(np.int32)
    w = np.full((cap, 2), -1, np.int32)
    w[:k, 0], w[:k, 1] = a, b
    return w


T = lambda a: torch.from_numpy(np.array(a))    # noqa: E731  (a copy)


@pytest.mark.parametrize("seed", range(4))
def test_delete_overflow_body(seed):
    rng = np.random.default_rng(seed)
    _, osrc, odst = _tables(rng)
    # deletes hitting live overflow pairs in both directions, plus misses
    live = np.nonzero(osrc >= 0)[0][:8]
    dels = np.full((16, 2), -1, np.int32)
    dels[:4] = np.stack([osrc[live[:4]], odst[live[:4]]], 1)
    dels[4:8] = np.stack([odst[live[4:8]], osrc[live[4:8]]], 1)
    dels[8:12] = rng.integers(0, 64, (4, 2))
    want = jdelta._delete_overflow(jnp.asarray(osrc), jnp.asarray(odst),
                                   jnp.asarray(dels))
    s_, d_ = T(osrc)[None], T(odst)[None]
    tdelta._delete_overflow_impl(s_, d_, T(dels)[None])
    np.testing.assert_array_equal(s_[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(d_[0].numpy(), np.asarray(want[1]))
    assert (np.asarray(want[0]) != osrc).sum() >= 8


@pytest.mark.parametrize("seed", range(4))
def test_delete_ell_wave_body(seed):
    rng = np.random.default_rng(seed)
    ell, _, _ = _tables(rng)
    w = _wave(rng, 64, 20, 32)
    w[:10, 1] = ell[w[:10, 0], 0]           # half hit a live slot
    want = jdelta._delete_ell_wave(jnp.asarray(ell), jnp.asarray(w[:, 0]),
                                   jnp.asarray(w[:, 1]))
    e = T(ell)[None]
    tdelta._delete_ell_wave_impl(e, T(w[:, 0])[None], T(w[:, 1])[None])
    np.testing.assert_array_equal(e[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_sort_overflow_snapshot(seed):
    rng = np.random.default_rng(seed)
    _, osrc, odst = _tables(rng)
    js, jd = jdelta._sort_overflow(jnp.asarray(osrc), jnp.asarray(odst))
    ts, td = tdelta.snapshot_pairs(
        tdelta._sort_overflow_impl(T(osrc)[None], T(odst)[None]))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))


@pytest.mark.parametrize("ocap,n_ovf", [(40, 25), (30, 28), (40, 0)],
                         ids=["room", "full", "empty"])
@pytest.mark.parametrize("seed", range(3))
def test_insert_wave_body(seed, ocap, n_ovf):
    """ELL landings, spills into the first free overflow slots, present
    edges (ELL and overflow) skipped, and a full buffer's ``fail``."""
    rng = np.random.default_rng(seed)
    ell, osrc, odst = _tables(rng, ocap=ocap, n_ovf=n_ovf)
    ell[rng.permutation(64)[:30]] = rng.integers(0, 64, (30, 6))  # full rows
    w = _wave(rng, 64, 24, 32)
    if n_ovf:
        live = np.nonzero(osrc >= 0)[0][:3]
        w[:3, 0], w[:3, 1] = osrc[live], odst[live]     # overflow-present
        w[3:6] = np.stack([w[3:6, 0], ell[w[3:6, 0], 0]], 1)  # ELL-present
    ss, ds = jdelta._sort_overflow(jnp.asarray(osrc), jnp.asarray(odst))
    want = jdelta._insert_wave(jnp.asarray(ell), jnp.asarray(osrc),
                               jnp.asarray(odst), ss, ds,
                               jnp.asarray(w[:, 0]), jnp.asarray(w[:, 1]))
    e, s_, d_ = T(ell)[None], T(osrc)[None], T(odst)[None]
    sk = tdelta._sort_overflow_impl(s_, d_)
    got = tdelta._insert_wave_impl(e, s_, d_, sk, T(w[:, 0])[None],
                                   T(w[:, 1])[None])
    for g, j in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(j))
    assert bool(got[3][0]) == bool(want[3])


@pytest.mark.parametrize("opts", [
    dict(ell_cap=4, ell_slack=0, ovf_cap=8, delta_cap=16),   # grows
    dict(ell_cap=6, ell_slack=1, ovf_cap=64, delta_cap=8),   # many waves
    dict(delta_cap=32),                                      # all-ELL
], ids=["overflow-full", "waves", "ell"])
def test_apply_updates_against_reference(opts):
    """``apply_updates`` on a reference state's arrays: an overflow-full
    insert wave grows the buffer and re-applies, in the reference's order;
    the input tensors are never written."""
    g = jgen.erdos_renyi(48, 5.0, seed=3)
    js = jinc.dynamic_state(g, n_chunks=2, **opts)
    rng = np.random.default_rng(5)
    ins, dels = random_batch(rng, 48, undirected(g), 60, 10)
    ins_r, dels_r = js.perm[ins], js.perm[dels]
    want = jdelta.apply_updates(js.ell, js.ovf_src, js.ovf_dst, ins_r,
                                dels_r, js.delta_cap)
    ins_t = [T(np.asarray(getattr(js, f)))
             for f in ("ell", "ovf_src", "ovf_dst")]
    keep = [t.clone() for t in ins_t]
    got = tdelta.apply_updates(*ins_t, ins_r, dels_r, js.delta_cap)
    for i, name in enumerate(("ell", "osrc", "odst", "touched")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=name)
    assert got[4] == want[4]
    if opts["delta_cap"] == 16:
        assert got[4] >= 1
    for t, k in zip(ins_t, keep):
        assert torch.equal(t, k)


def test_apply_updates_growth_budget():
    from repro.resilience.errors import OvfGrowthExhausted as JExhausted
    from repro_torch.resilience.errors import OvfGrowthExhausted
    g = jgen.erdos_renyi(32, 4.0, seed=3)
    js = jinc.dynamic_state(g, n_chunks=2, ell_cap=2, ell_slack=0,
                            ovf_cap=8, delta_cap=16)
    rng = np.random.default_rng(5)
    ins = js.perm[random_batch(rng, 32, undirected(g), 60, 0)[0]]
    none = np.zeros((0, 2), np.int64)
    with pytest.raises(JExhausted) as je:
        jdelta.apply_updates(js.ell, js.ovf_src, js.ovf_dst, ins, none, 16,
                             max_grows=0)
    with pytest.raises(OvfGrowthExhausted) as te:
        tdelta.apply_updates(T(np.asarray(js.ell)), T(np.asarray(js.ovf_src)),
                             T(np.asarray(js.ovf_dst)), ins, none, 16,
                             max_grows=0)
    assert (te.value.grows, te.value.budget, te.value.cap) == \
        (je.value.grows, je.value.budget, je.value.cap)


def test_plan_updates_is_the_reference_plan():
    rng = np.random.default_rng(17)
    for _ in range(10):
        ins = rng.integers(0, 64, (int(rng.integers(0, 40)), 2))
        dels = rng.integers(0, 64, (int(rng.integers(0, 40)), 2))
        jp = jdelta.plan_updates(ins, dels, 8, 64)
        tp = tdelta.plan_updates(ins, dels, 8, 64)
        for f in ("ovf_del", "ell_del", "ins"):
            assert len(getattr(jp, f)) == len(getattr(tp, f))
            for a, b in zip(getattr(jp, f), getattr(tp, f)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jp.touched, tp.touched)


# --------------------------------------------------------------------------
# streams: every field after every batch
# --------------------------------------------------------------------------

J_SUITE = jgen.paper_suite("tiny")
T_SUITE = tgen.paper_suite("tiny")


@pytest.mark.parametrize("name", sorted(J_SUITE))
def test_stream_equals_reference(name):
    """30 batches (random inserts, deletes from the current edge set) on a
    ``paper_suite("tiny")`` graph: every state field and ``colors`` equal
    the reference's after each batch, and the coloring stays proper."""
    opts = dict(seed=1, ell_cap=16, delta_cap=32)
    js, ts = both_states(J_SUITE[name], T_SUITE[name], **opts)
    rng = np.random.default_rng(7)
    n = js.n
    for b in range(30):
        ins, dels = random_batch(rng, n, undirected(jdelta.state_to_csr(js)),
                                 16, 8)
        js = jinc.recolor_incremental(js, ins, dels)
        ts = tinc.recolor_incremental(ts, ins, dels)
        assert_states_equal(js, ts, f"{name} batch {b}")
    assert tcol.is_proper(tdelta.state_to_csr(ts), ts.colors)
    assert edge_set(j_to_edge_list(jdelta.state_to_csr(js))) == edge_set(
        tgen_edges(tdelta.state_to_csr(ts)))


def tgen_edges(g):
    from repro_torch.graphs.csr import to_edge_list
    return to_edge_list(g)


def test_state_from_numpy_mid_stream():
    """Both packages start from the same reference mid-stream state (the
    port's built by ``state_from_numpy`` from its arrays) and stay equal."""
    g = J_SUITE["rmat_b"]
    js = jinc.dynamic_state(g, seed=2, ell_cap=8, delta_cap=32)
    rng = np.random.default_rng(3)
    for _ in range(4):
        js = jinc.recolor_incremental(js, *random_batch(
            rng, js.n, undirected(jdelta.state_to_csr(js)), 20, 10))
    fields = {f.name: (np.asarray(getattr(js, f.name))
                       if f.name in tinc.TENSOR_FIELDS
                       else getattr(js, f.name))
              for f in dataclasses.fields(js)}
    ts = tinc.state_from_numpy(fields, "cpu")
    assert_states_equal(js, ts, "carried")
    for b in range(6):
        ins, dels = random_batch(rng, js.n,
                                 undirected(jdelta.state_to_csr(js)), 20, 10)
        js = jinc.recolor_incremental(js, ins, dels)
        ts = tinc.recolor_incremental(ts, ins, dels)
        assert_states_equal(js, ts, f"batch {b}")


# --------------------------------------------------------------------------
# the reference's test_dynamic.py cases, as differentials
# --------------------------------------------------------------------------

def test_noop_and_duplicates():
    js, ts = both_states(jgen.mesh2d(12, 12), tgen.mesh2d(12, 12), seed=0,
                         delta_cap=64)
    e0 = j_to_edge_list(jgen.mesh2d(12, 12))[0]
    ins = np.array([e0, e0, [0, 5], [0, 5]])
    dels = np.array([[1, 100]])
    js2 = jinc.recolor_incremental(js, inserts=ins, deletes=dels)
    ts2 = tinc.recolor_incremental(ts, inserts=ins, deletes=dels)
    assert_states_equal(js2, ts2, "duplicates")
    assert tinc.recolor_incremental(ts2) is ts2       # empty batch


def test_spill_stream():
    g = (jgen.rmat_b(9, edge_factor=16), tgen.rmat_b(9, edge_factor=16))
    js, ts = both_states(*g, seed=2, ell_cap=8, ell_slack=1, ovf_cap=64,
                         delta_cap=128)
    rng = np.random.default_rng(9)
    for b in range(4):
        ins, dels = random_batch(rng, js.n,
                                 undirected(jdelta.state_to_csr(js)), 100, 50)
        js = jinc.recolor_incremental(js, ins, dels)
        ts = tinc.recolor_incremental(ts, ins, dels)
        assert_states_equal(js, ts, f"batch {b}")
    assert tdelta.overflow_load(ts.ovf_src) > 0       # the spill path ran


def test_clique_injection_cap_doubling():
    # an attempt at a cap the clique does not fit runs to max_rounds before
    # the cap doubles: 100 here keeps that first attempt short
    js, ts = both_states(jgen.mesh2d(8, 8), tgen.mesh2d(8, 8), seed=0, C=32,
                         delta_cap=128, max_rounds=100)
    ii, jj = np.meshgrid(np.arange(40), np.arange(40))
    clique = np.stack([ii[ii < jj], jj[ii < jj]], 1)
    js = jinc.recolor_incremental(js, inserts=clique)
    ts = tinc.recolor_incremental(ts, inserts=clique)
    assert_states_equal(js, ts, "clique")
    assert ts.retries >= 1 and ts.ovf_grows >= 1 and ts.n_colors == 40


def test_deletes_only_single_verify_pass():
    g = (jgen.mesh2d(24, 24), tgen.mesh2d(24, 24))
    js, ts = both_states(*g, seed=0)
    dels = j_to_edge_list(g[0])[:50]
    js2 = jinc.recolor_incremental(js, deletes=dels)
    ts2 = tinc.recolor_incremental(ts, deletes=dels)
    assert_states_equal(js2, ts2, "deletes")
    assert ts2.last_gather_passes == 1 and ts2.last_conflicts == 0
    # the deletes landed in a copy: the first state is as it was
    assert_states_equal(js, ts, "input state")


def test_uncolored_seed_repair_is_verified():
    """Adjacent uncolored seeds force-colored from one snapshot (lockstep
    n_chunks=1): the compacted repair keeps going until a pass verifies
    them, in both packages alike."""
    from repro.core import coloring as jcol
    from repro.graphs.csr import from_edges as j_from_edges
    from repro_torch.core.context import PassContext
    from repro_torch.graphs.csr import from_edges as t_from_edges
    e = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2]])
    jp = jcol.prepare(j_from_edges(4, e), seed=0, n_chunks=1, relabel=False)
    tp = tcol.prepare(t_from_edges(4, e), seed=0, n_chunks=1, relabel=False)
    colors0 = np.full(jp.n_pad, -1, np.int32)
    U0 = np.arange(jp.n_pad) < jp.n
    jout = jfrontier._repair_compact_loop(
        jp.ell, jp.ovf_src, jp.ovf_dst, jp.pri, jnp.asarray(colors0),
        jnp.asarray(U0), jcol.PassContext.for_problem(jp, n_chunks=1),
        jp.n_pad, 50)
    tout = tfrontier._repair_compact_loop(
        tp.ell, tp.ovf_src, tp.ovf_dst, tp.pri, torch.from_numpy(colors0),
        torch.from_numpy(U0), PassContext.for_problem(tp, n_chunks=1),
        tp.n_pad, 50)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(
            t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
            np.asarray(j))


def test_upsert_stream_does_not_grow_overflow():
    g = (jgen.rmat_b(9, edge_factor=16), tgen.rmat_b(9, edge_factor=16))
    js, ts = both_states(*g, seed=2, ell_cap=8, ell_slack=0, delta_cap=64)
    und = undirected(jdelta.state_to_csr(js))[:200]
    load0 = tdelta.overflow_load(ts.ovf_src)
    assert load0 > 0
    for _ in range(3):
        js = jinc.recolor_incremental(js, inserts=und)
        ts = tinc.recolor_incremental(ts, inserts=und)
        assert_states_equal(js, ts, "upsert")
    assert tdelta.overflow_load(ts.ovf_src) == load0


def test_incremental_engine_through_api():
    from repro import api as japi
    from repro_torch import api as tapi
    jr = japi.color(J_SUITE["pwtk"], mode="incremental", seed=3)
    tr = tapi.color(T_SUITE["pwtk"], mode="incremental", seed=3,
                    device="cpu")
    assert_states_equal(jr.state, tr.state, "engine")
    np.testing.assert_array_equal(tr.colors, jr.colors)
    assert tr.summary() == jr.summary()
    assert tr.spec.spec_key() == jr.spec.spec_key()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal path is not taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinc.dynamic_state(T_SUITE["pwtk"])
    from repro_torch.dynamic import ColoringService
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ColoringService()


@pytest.mark.cuda
def test_stream_on_the_card_equals_cpu(cuda_device):
    """The same stream on the card (B1, B2 with row_ids) and on the CPU."""
    g = T_SUITE["rmat_b"]
    a = tinc.dynamic_state(g, seed=1, ell_cap=16, delta_cap=32, device="cpu")
    b = tinc.dynamic_state(g, seed=1, ell_cap=16, delta_cap=32,
                           device=cuda_device)
    rng = np.random.default_rng(1)
    for _ in range(10):
        ins = rng.integers(0, a.n, (24, 2))
        dels = rng.integers(0, a.n, (12, 2))
        a = tinc.recolor_incremental(a, ins, dels)
        b = tinc.recolor_incremental(b, ins, dels)
        for f in tinc.TENSOR_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        assert a.summary() == b.summary()

