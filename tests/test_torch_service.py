"""The port's megabatched ``ColoringService`` against the reference's and
against its own per-tenant loop (``repro_torch.dynamic`` on the CPU).

The megabatched step must be bit-identical to the per-tenant loop —
escapes (colour cap, frontier past its cap, overflow buffer full)
included — and both to the reference's service; group planning must equal
per-tenant planning; the megabatched repair must equal the reference's
slot by slot; B2's slot-stride form must equal one call a slot.  Inputs are
numpy-made from seeds; the bar is equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfrontier
from repro.core.context import PassContext as JPassContext
from repro.dynamic import ColoringService as JService
from repro.dynamic import delta as jdelta
from repro.dynamic import incremental as jinc
from repro.graphs import generators as jgen
from repro_torch.core import coloring as tcol
from repro_torch.core import frontier as tfrontier
from repro_torch.core.context import PassContext as TPassContext
from repro_torch.dynamic import (ArtifactCache, ColoringService, megabatch,
                                 slot_key, state_to_csr)
from repro_torch.dynamic import delta as tdelta
from repro_torch.dynamic import incremental as tinc
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import ops
from repro_torch.obs import metrics as tmetrics

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

# the reference test_service.py's slot class
OPTS = dict(seed=0, n_chunks=2, ell_cap=6, C=16, ovf_cap=64, delta_cap=32,
            frontier_frac=0.5)


def _services(n_tenants=3, n=64, **over):
    """(reference, port loop, port megabatched) services with the same
    tenants.  The reference's loop stands for it: its megabatched service
    equals its loop (the reference's own test), and the loop compiles far
    less."""
    opts = {**OPTS, **over}
    out = [JService(megabatch=False, **opts)]
    out += [ColoringService(megabatch=m, device="cpu", **opts)
            for m in (False, True)]
    for svc, gen in zip(out, (jgen, tgen, tgen)):
        for i in range(n_tenants):
            svc.add_graph(f"g{i}", gen.erdos_renyi(n, 5.0, seed=i))
    keys = {slot_key(out[2].snapshot(f"g{i}")) for i in range(n_tenants)}
    assert len(keys) == 1, keys
    return out


def _assert_identical(svcs, n_tenants):
    for i in range(n_tenants):
        nm = f"g{i}"
        want = svcs[0]
        for svc in svcs[1:]:
            np.testing.assert_array_equal(svc.colors(nm), want.colors(nm),
                                          err_msg=nm)
            assert svc.version(nm) == want.version(nm), nm
            assert svc.stats(nm) == want.stats(nm), nm
        st = svcs[-1].snapshot(nm)
        assert tcol.is_proper(state_to_csr(st), st.colors), nm


def _mega(outcome):
    return tmetrics.counter_value("service.mega", outcome=outcome)


def _stream(svcs, n_tenants, n, steps, bpp=2, seed=3):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for t in range(n_tenants):
            for _b in range(bpp):
                ins = rng.integers(0, n, (6, 2))
                ins = ins[ins[:, 0] != ins[:, 1]]
                dels = rng.integers(0, n, (3, 2))
                for svc in svcs:
                    svc.submit(f"g{t}", inserts=ins, deletes=dels)
        for svc in svcs:
            svc.step()


@pytest.mark.parametrize("bpp", [1, 3, 9], ids=["1", "3", "9-two-chunks"])
def test_mega_step_equals_loop_and_reference(bpp):
    svcs = _services()
    bat0 = _mega("batched")
    _stream(svcs, 3, 64, steps=2, bpp=bpp)
    _assert_identical(svcs, 3)
    assert _mega("batched") > bat0                 # the fast path ran


def test_mega_escape_colour_cap():
    """K_12 on tenant 0 needs 12 colours > C=8: its slot escapes the
    stacked repair and replays per-tenant (cap doubling)."""
    svcs = _services(C=8)
    esc0 = _mega("escaped") + _mega("solo")
    ii, jj = np.meshgrid(np.arange(12), np.arange(12))
    clique = np.stack([ii[ii < jj], jj[ii < jj]], 1)
    rng = np.random.default_rng(5)
    others = [rng.integers(0, 64, (6, 2)) for _ in range(2)]
    for svc in svcs:
        svc.submit("g0", inserts=clique)
        for t in (1, 2):
            svc.submit(f"g{t}", inserts=others[t - 1])
        svc.submit("g0", inserts=others[0])         # the solo drain
        svc.step()
    _assert_identical(svcs, 3)
    assert svcs[2].snapshot("g0").C > 8
    assert _mega("escaped") + _mega("solo") > esc0


def test_mega_escape_frontier_past_cap():
    """A frontier of more than ``frontier_cap`` rows escapes the stacked
    repair (which has no full-width fallback); the per-tenant replay takes
    the fallback pass."""
    svcs = _services(frontier_frac=0.05)
    assert svcs[2].snapshot("g0").frontier_cap == 4
    esc0 = _mega("escaped")
    _stream(svcs, 3, 64, steps=2, bpp=2)
    _assert_identical(svcs, 3)
    assert _mega("escaped") > esc0


def test_mega_escape_overflow_buffer_full():
    """An insert spill that finds a slot's overflow buffer full escapes;
    the replay grows the buffer, so the tenant leaves the class ("solo")
    for the rest of its queue."""
    svcs = _services(ell_cap=2, ell_slack=0, ovf_cap=None)
    cap0 = int(svcs[2].snapshot("g1").ovf_src.shape[0])
    solo0 = _mega("solo")
    rng = np.random.default_rng(9)
    big = rng.integers(0, 64, (260, 2))
    big = big[big[:, 0] != big[:, 1]]
    for svc in svcs:
        svc.submit("g0", inserts=big[:3])
        svc.submit("g1", inserts=big[:200])          # spills past the buffer
        for j in range(9):              # the next chunk of rounds: solo
            svc.submit("g1", inserts=big[200 + 5 * j:205 + 5 * j])
            svc.submit("g2", inserts=big[4 * j:4 * j + 4])
        svc.step()
    _assert_identical(svcs, 3)
    assert int(svcs[2].snapshot("g1").ovf_src.shape[0]) > cap0
    assert _mega("solo") > solo0


def test_megabatch_min_falls_back_to_loop():
    svc = ColoringService(megabatch=True, megabatch_min=4, device="cpu",
                          **OPTS)
    for i in range(2):
        svc.add_graph(f"g{i}", tgen.erdos_renyi(64, 5.0, seed=i))
    n0 = _mega("loop")
    for i in range(2):
        svc.submit(f"g{i}", inserts=[[0, 9]])
    svc.step()
    assert _mega("loop") == n0 + 2


# --------------------------------------------------------------------------
# planning, the stacked repair, the slot-stride pass
# --------------------------------------------------------------------------

def test_plan_group_matches_plan_updates_and_reference():
    rng = np.random.default_rng(17)
    cap, n_pad = 8, 64
    for trial in range(25):
        n_slots = int(rng.integers(1, 5))
        batches = []
        for _ in range(n_slots):
            k_i, k_d = rng.integers(0, 30, 2)      # over-cap waves included
            batches.append((rng.integers(0, n_pad, (k_i, 2)).astype(np.int32),
                            rng.integers(0, n_pad, (k_d, 2)).astype(np.int32)))
        got = tdelta.plan_group(batches, cap, n_pad)
        for g, w in zip(got, jdelta.plan_group(batches, cap, n_pad)):
            np.testing.assert_array_equal(g, w)
        ovf_w, ell_w, ins_w, touched = got
        for b, (ins, dels) in enumerate(batches):
            ref = tdelta.plan_updates(ins, dels, cap, n_pad)
            for g, want in ((ovf_w, ref.ovf_del), (ell_w, ref.ell_del),
                            (ins_w, ref.ins)):
                for j in range(g.shape[0]):
                    exp = want[j] if j < len(want) else tdelta.empty_wave(cap)
                    np.testing.assert_array_equal(g[j, b], exp)
            np.testing.assert_array_equal(touched[b], ref.touched)


def test_apply_updates_mega_equals_per_tenant_and_reference():
    """One plan per slot in lockstep (shorter plans padded with no-op
    waves) equals each slot's own ``apply_updates`` and the reference's
    ``apply_updates_mega``; a slot whose buffer fills raises ``fail``."""
    states = [jinc.dynamic_state(jgen.erdos_renyi(64, 5.0, seed=i), **dict(
        OPTS, ell_cap=3, ell_slack=0, ovf_cap=256)) for i in range(3)]
    rng = np.random.default_rng(4)
    plans, batches = [], []
    for i, st in enumerate(states):
        k = (8, 40, 200)[i]                           # slot 2 overflows
        ins = rng.integers(0, 64, (k, 2))
        ins = st.perm[ins[ins[:, 0] != ins[:, 1]]]
        dels = st.perm[rng.integers(0, 64, (5, 2))]
        batches.append((ins, dels))
        plans.append(jdelta.plan_updates(ins, dels, 32, st.n_pad))
    stack = lambda f: np.stack([np.asarray(getattr(s, f))  # noqa: E731
                                for s in states])
    T = torch.from_numpy
    ell, osrc, odst = stack("ell"), stack("ovf_src"), stack("ovf_dst")
    want = jdelta.apply_updates_mega(jnp.asarray(ell), jnp.asarray(osrc),
                                     jnp.asarray(odst), plans, 32)
    got = tdelta.apply_updates_mega(T(ell), T(osrc), T(odst), plans, 32)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    assert got[3].tolist() == [False, False, True]
    for i in range(3):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w[i]))
    for i in (0, 1):                                  # no fail: as one
        one = tdelta.apply_updates(T(ell[i]), T(osrc[i]), T(odst[i]),
                                   *batches[i], 32)
        for g, o in zip(got[:3], one[:3]):
            assert torch.equal(g[i], o)
    assert torch.equal(T(ell), T(stack("ell")))       # inputs untouched


def _mega_case(S=4, n=64, frac=0.5, seed=0):
    """S same-shape reference states mid-stream and one batch each,
    applied: the stacked inputs of a megabatched repair."""
    states = [jinc.dynamic_state(jgen.erdos_renyi(n, 5.0, seed=i), **dict(
        OPTS, frontier_frac=frac)) for i in range(S)]
    rng = np.random.default_rng(seed)
    ells, osrcs, odsts, Us = [], [], [], []
    for i, st in enumerate(states):
        k = 3 if i == 1 else 10                      # ragged frontiers
        ins = st.perm[rng.integers(0, n, (k, 2))]
        ins = ins[ins[:, 0] != ins[:, 1]]
        e, s_, d_, U, _ = jdelta.apply_updates(st.ell, st.ovf_src, st.ovf_dst,
                                               ins, np.zeros((0, 2)), 32)
        ells.append(e)
        osrcs.append(s_)
        odsts.append(d_)
        Us.append(U)
    stack = lambda xs: np.stack([np.asarray(x) for x in xs])  # noqa: E731
    return (states[0], stack(ells), stack(osrcs), stack(odsts),
            stack([s.pri for s in states]),
            stack([s.colors_dev for s in states]), stack(Us))


@pytest.mark.parametrize("esc0", [(False,) * 4, (False, True, False, False)],
                         ids=["live", "frozen-slot"])
@pytest.mark.parametrize("C", [16, 2], ids=["C16", "C2-escapes"])
def test_repair_mega_loop_equals_reference(esc0, C):
    """Slot by slot: rounds, defects and escape flags equal the reference's
    ``vmap``-ed loop, and so do the colours of every slot that did not
    escape (an escaped slot's colours are garbage by contract)."""
    st, ell, osrc, odst, pri, colors, U = _mega_case()
    jctx = JPassContext(n=st.n, n_pad=st.n_pad, C=C, n_chunks=st.n_chunks)
    tctx = TPassContext(n=st.n, n_pad=st.n_pad, C=C, n_chunks=st.n_chunks)
    jc, jr, jt, je = jfrontier._repair_mega_loop(
        jnp.asarray(ell), jnp.asarray(osrc), jnp.asarray(odst),
        jnp.asarray(pri), jnp.asarray(colors), jnp.asarray(U),
        jnp.asarray(esc0), jctx, st.frontier_cap, 100)
    T = torch.from_numpy
    colors_t = T(colors.copy())
    tc, tr, tt, te = tfrontier._repair_mega_loop(
        T(ell), T(osrc), T(odst), T(pri), colors_t, T(U), np.array(esc0),
        tctx, st.frontier_cap, 100)
    np.testing.assert_array_equal(te, np.asarray(je))
    ok = ~te
    np.testing.assert_array_equal(tr[ok], np.asarray(jr)[ok])
    np.testing.assert_array_equal(tt[ok], np.asarray(jt)[ok])
    np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
    assert torch.equal(colors_t, T(colors))           # input untouched
    if any(esc0):
        assert tr[1] == 0 and tt[1] == 0              # frozen: zero rounds
    if C == 2:
        assert te.any()


@pytest.mark.parametrize("S", [1, 3, 6])
@pytest.mark.parametrize("W", [5, 12, 44])
def test_slot_stride_plain_equals_one_call_a_slot(S, W):
    """B2's slot-stride form (plain version, CPU) over S stacked slots
    equals one call of the one-table form a slot on that slot's tables;
    ELL ids past the slot are clamped within it."""
    n_pad, C, cs = 96, 32, 20
    rng = np.random.default_rng(S * 100 + W)
    ell = rng.integers(0, n_pad + 5, (S * n_pad, W)).astype(np.int32)
    ell[rng.random(ell.shape) < 0.3] = -1
    colors = rng.integers(-1, 12, S * n_pad).astype(np.int32)
    pri = np.concatenate([rng.permutation(n_pad) for _ in range(S)]).astype(
        np.int32)
    T = torch.from_numpy
    ell_t, colors_t, pri_t = T(ell), T(colors), T(pri)
    ids = np.stack([rng.permutation(n_pad)[:cs] for _ in range(S)])
    ids[:, -3:] = n_pad - 1                          # clamped dead rows
    rows = (np.arange(S)[:, None] * n_pad + ids).astype(np.int32).ravel()
    U = rng.random(S * cs) < 0.8
    force = rng.random(S * cs) < 0.2
    got = ops.detect_recolor(ell_t, colors_t, pri_t, T(U), 0, C,
                             force=T(force), row_ids=T(rows),
                             slot_rows=n_pad)
    for s in range(S):
        lo, hi = s * n_pad, (s + 1) * n_pad
        one = ops.detect_recolor(
            ell_t[lo:hi], colors_t[lo:hi], pri_t[lo:hi],
            T(U[s * cs:(s + 1) * cs]), 0, C,
            force=T(force[s * cs:(s + 1) * cs]),
            row_ids=T(ids[s].astype(np.int32)))
        for g, o in zip(got, one):
            assert torch.equal(g[s * cs:(s + 1) * cs], o)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [12, 44, 516])
def test_slot_stride_kernel_equals_plain(cuda_device, W):
    """The slot-stride launch on the card (``direct`` at W 12, ``vec16``
    at 44 and 516) equals its plain version and one launch a slot."""
    from repro_torch.kernels import detect_recolor as dr_mod
    S, n_pad, C, cs = 5, 256, 64, 48
    rng = np.random.default_rng(W)
    ell = rng.integers(0, n_pad, (S * n_pad, W)).astype(np.int32)
    ell[rng.random(ell.shape) < 0.4] = -1
    colors = rng.integers(-1, 20, S * n_pad).astype(np.int32)
    pri = rng.permutation(S * n_pad).astype(np.int32)
    ids = np.stack([rng.permutation(n_pad)[:cs] for _ in range(S)])
    rows = (np.arange(S)[:, None] * n_pad + ids).astype(np.int32).ravel()
    U = rng.random(S * cs) < 0.8
    dev = lambda a: torch.from_numpy(a).to(cuda_device)   # noqa: E731
    args = (dev(ell), dev(colors), dev(pri), dev(U), 0, C)
    before = dr_mod.detect_recolor.launches_slots
    got = ops.detect_recolor(*args, row_ids=dev(rows), slot_rows=n_pad)
    assert dr_mod.detect_recolor.launches_slots == before + 1
    want = ops.detect_recolor(*args, row_ids=dev(rows), slot_rows=n_pad,
                              backend="torch")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for s in range(S):
        lo, hi = s * n_pad, (s + 1) * n_pad
        one = ops.detect_recolor(args[0][lo:hi], args[1][lo:hi],
                                 args[2][lo:hi], args[3][s * cs:(s + 1) * cs],
                                 0, C, row_ids=dev(ids[s].astype(np.int32)))
        for g, o in zip(got, one):
            assert torch.equal(g[s * cs:(s + 1) * cs], o)


def test_slot_stride_argument_checks():
    T = torch.from_numpy
    ell = T(np.zeros((8, 2), np.int32))
    c = T(np.zeros(8, np.int32))
    U = T(np.ones(2, bool))
    rows = T(np.array([0, 5], np.int32))
    with pytest.raises(ValueError, match="row_ids"):
        ops.detect_recolor(ell[:2], c, c, U, 0, 4, slot_rows=4)
    with pytest.raises(ValueError, match="divide"):
        ops.detect_recolor(ell, c, c, U, 0, 4, row_ids=rows, slot_rows=3)
    with pytest.raises(ValueError, match="full pass"):
        ops.detect_recolor(ell, c, c, U, 0, 4, row_ids=rows, slot_rows=4,
                           detect_only=True)


def test_step_group_validates_before_touching():
    svc = ColoringService(device="cpu", **OPTS)
    svc.add_graph("a", tgen.erdos_renyi(64, 5.0, seed=0))
    svc.add_graph("b", tgen.mesh2d(4, 4))
    a, b = svc.snapshot("a"), svc.snapshot("b")
    with pytest.raises(ValueError, match="single slot class"):
        megabatch.step_group([a, b], [[], []])
    with pytest.raises(ValueError, match="outside"):
        megabatch.step_group([a, a], [[([[0, 99]], None)], []])
    assert megabatch.step_group([], []) == ([], [])


# --------------------------------------------------------------------------
# lifecycle, against the reference where it has a result
# --------------------------------------------------------------------------

def test_snapshot_restore_and_artifacts_equal_reference():
    svcs = [JService(**OPTS), ColoringService(device="cpu", **OPTS)]
    for svc, gen in zip(svcs, (jgen, tgen)):
        svc.add_graph("g", gen.mesh2d(8, 8))
    snaps = [svc.snapshot("g") for svc in svcs]
    for _ in range(2):
        for svc in svcs:
            svc.submit("g", inserts=[[0, 9], [3, 17]])
            svc.step("g")
    vs = [svc.restore("g", sn) for svc, sn in zip(svcs, snaps)]
    assert vs[0] == vs[1] == 3
    np.testing.assert_array_equal(svcs[1].colors("g"), svcs[0].colors("g"))
    for a, b in zip(svcs[1].vertex_schedule("g"),
                    svcs[0].vertex_schedule("g")):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(svcs[1].edge_colors("g"), svcs[0].edge_colors("g")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(TypeError):
        svcs[1].restore("g", object())
    with pytest.raises(ValueError):
        other = ColoringService(device="cpu", **OPTS)
        other.add_graph("t", tgen.mesh2d(4, 4))
        svcs[1].restore("g", other.snapshot("t"))


def test_artifact_cache_eviction_semantics():
    cache = ArtifactCache(budget_bytes=2048)
    assert cache.put(("g", "a"), 0, np.zeros(300, np.int64)) == []
    assert cache.put(("g", "b"), 0, np.zeros(200, np.int64)) == [("g", "a")]
    assert cache.get(("g", "a"), 0) is None
    assert cache.get(("g", "b"), 1) is None
    cache.drop_name("g")
    assert len(cache) == 0 and cache.nbytes == 0


def test_max_rounds_persisted_and_stats_lazy():
    svc = ColoringService(max_rounds=1, device="cpu", **OPTS)
    svc.add_graph("g", tgen.mesh2d(8, 8))
    svc.add_graph("h", tgen.mesh2d(8, 8))
    assert svc.snapshot("g").max_rounds == 1
    svc.submit("g", inserts=[[0, 9], [1, 10]])
    stats = svc.step()
    assert svc.snapshot("g").last_rounds <= 1
    assert set(stats) == {"g", "h"} and stats["g"] is stats["g"]


def test_mesh_asks_for_the_unported_sharded_engine():
    """``mesh=`` asks for the sharded engine, ported since: the tenant is a
    ``ShardedColoringState`` on the mesh (``tests/test_torch_sharded.py``
    holds it against the reference); a mesh that is not one, or whose
    devices are not the service's, is refused and adds no tenant."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.dynamic import ShardedColoringState
    svc = ColoringService(device="cpu", **OPTS)
    with pytest.raises(TypeError, match="must be a repro_torch.core.mesh"):
        svc.add_graph("s", tgen.mesh2d(4, 4), mesh=object())
    with pytest.raises(ValueError, match="contradicts the mesh"):
        svc.add_graph("s", tgen.mesh2d(4, 4), mesh=make_mesh(
            (2,), ("data",), devices=("meta", "meta")))
    assert svc.graphs() == []
    svc.add_graph("s", tgen.mesh2d(4, 4),
                  mesh=make_mesh((2,), ("data",), device="cpu"))
    assert isinstance(svc.snapshot("s"), ShardedColoringState)
    assert tcol.is_proper(svc.graph("s"), svc.colors("s"))


@pytest.mark.cuda
def test_mega_service_on_the_card_equals_cpu(cuda_device):
    svcs = [ColoringService(megabatch=True, device=d, **OPTS)
            for d in ("cpu", cuda_device)]
    for svc in svcs:
        for i in range(4):
            svc.add_graph(f"g{i}", tgen.erdos_renyi(64, 5.0, seed=i))
    _stream(svcs, 4, 64, steps=2, bpp=3)
    for i in range(4):
        np.testing.assert_array_equal(svcs[1].colors(f"g{i}"),
                                      svcs[0].colors(f"g{i}"))
        assert svcs[1].stats(f"g{i}") == svcs[0].stats(f"g{i}")
