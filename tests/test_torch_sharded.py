"""The port's sharded incremental stack against the reference's
(``repro_torch.dynamic.sharded`` on CPU meshes against
``repro.dynamic.sharded``): the flows of ``tests/test_sharded.py`` held as
differentials.  After every batch every state field, every per-shard array
and the colours are equal; at one shard the sharded stream also equals the
port's own ``mode="incremental"`` stream; the service with a sharded and a
local tenant, the ladder's sharded rungs and ``color.corrupt`` on a sharded
tenant behave alike.

The reference's meshes need ``XLA_FLAGS`` set before JAX is imported: its
side runs once, in one module-scoped subprocess (``reference_results``).
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.core import coloring as tcol
from repro_torch.core import mesh as tmesh
from repro_torch.dynamic import ColoringService as TService
from repro_torch.dynamic import delta as tdelta
from repro_torch.dynamic import recolor_incremental as t_recolor_inc
from repro_torch.dynamic import service as tservice
from repro_torch.dynamic import sharded as tsh
from repro_torch.graphs import generators as tgen
from repro_torch.obs import metrics as tmetrics
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import ladder as tladder

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SHARDS = (4, 8)
SCALARS = ("version", "last_rounds", "last_conflicts", "last_gather_passes",
           "total_gather_passes", "C", "retries", "ovf_grows", "replans",
           "last_halo_bytes", "total_halo_bytes", "last_degrade_rung", "n",
           "blk", "n_loc", "n_shards", "n_tab", "frontier_cap",
           "halo_bytes_per_round", "max_b_cap", "max_g_cap")
TENSORS = ("ell", "ovf_src", "ovf_dst", "pri_tab", "colors_tab")
HOST = ("boundary", "n_boundary", "ghost_ids", "ghost_flat", "n_ghost",
        "perm", "inv_perm", "pri_global", "row_of")


def sha(a) -> str:
    a = np.ascontiguousarray(a)
    return f"{a.dtype}:{a.shape}:" + hashlib.sha256(a.tobytes()).hexdigest()


def stacked(st, field):
    """A per-shard tensor field with its shard axis, as numpy (either
    package's state)."""
    if hasattr(st, "stacked"):
        return st.stacked(field)
    return np.asarray(getattr(st, field))


def state_entry(st) -> dict:
    d = {f: int(getattr(st, f)) for f in SCALARS}
    d.update({f: sha(stacked(st, f)) for f in TENSORS})
    d.update({f: sha(getattr(st, f)) for f in HOST})
    d["colors"] = np.asarray(st.colors).tolist()
    d["summary"] = {k: int(v) for k, v in st.summary().items()}
    return d


def stream(n, seed, k):
    """``tests/test_sharded.py``'s stream: 40 inserts, 15 deletes a batch."""
    rng = np.random.default_rng(seed)
    for _ in range(k):
        ins = rng.integers(0, n, size=(40, 2)).astype(np.int64)
        dels = rng.integers(0, n, size=(15, 2)).astype(np.int64)
        yield ins[ins[:, 0] != ins[:, 1]], dels


def big_batch(n):
    big = np.random.default_rng(13).integers(0, n, size=(3000, 2))
    return big[big[:, 0] != big[:, 1]].astype(np.int64)


def ladder_inserts(colors):
    """Edges between same-coloured vertices: guaranteed conflicts."""
    return np.array([(u, v) for u in range(40) for v in range(u + 1, 60)
                     if colors[u] == colors[v]][:16], np.int64)


def flows(api, recolor_sharded, ladder, faults, service_mod, make_service,
          mesh_of, gen, is_proper, state_to_csr, metrics) -> dict:
    """Every flow of the differential through one package (its api,
    sharded entry, ladder, faults, service module and factory, a
    ``mesh_of(D)`` maker and its generators); returns JSON-able records."""
    out = {}
    g = gen.mesh2d(24, 24)
    n = g.n_vertices

    # -- 1 shard: the stream of tests/test_sharded.py -----------------------
    st = api.color(g, mode="incremental", backend="distributed",
                   mesh=mesh_of(1), seed=0).state
    rows = [state_entry(st)]
    for ins, dels in stream(n, 7, 5):
        st = recolor_sharded(st, ins, dels)
        rows.append(state_entry(st))
    out["one_shard"] = rows

    # -- 4 and 8 shards, then a batch that forces a re-plan -----------------
    for D in SHARDS:
        st = api.color(g, mode="incremental", backend="distributed",
                       mesh=mesh_of(D), seed=0).state
        rows = [state_entry(st)]
        for ins, dels in stream(n, 11, 4):
            st = recolor_sharded(st, ins, dels)
            rows.append(state_entry(st))
        st = recolor_sharded(st, big_batch(n), None)
        row = state_entry(st)
        row["proper"] = bool(is_proper(state_to_csr(st), st.colors))
        rows.append(row)
        out[f"shards{D}"] = rows

    # -- the service: a sharded tenant next to a local one ------------------
    metrics.reset()
    svc = make_service()
    svc.add_graph("sh", g, mesh=mesh_of(8), seed=0)
    svc.add_graph("loc", g, seed=0)
    rng = np.random.default_rng(3)
    steps = []
    for _ in range(2):
        ins = rng.integers(0, n, size=(25, 2)).astype(np.int64)
        ins = ins[ins[:, 0] != ins[:, 1]]
        svc.submit("sh", inserts=ins)
        svc.submit("loc", inserts=ins)
        svc.step()
        steps.append({nm: dict(svc.stats(nm),
                               colors=svc.colors(nm).tolist())
                      for nm in ("sh", "loc")})
    hb = {nm: int(metrics.counter("service.halo_bytes", tenant=nm).value)
          for nm in ("sh", "loc")}
    snap = svc.snapshot("sh")
    svc.submit("sh", inserts=np.array([[0, 5]], np.int64))
    svc.step("sh")
    v_after = svc.restore("sh", snap)
    sched = svc.vertex_schedule("sh")
    out["service"] = {
        "steps": steps, "halo_bytes": hb, "restore_version": int(v_after),
        "restored": state_entry(svc.snapshot("sh")),
        "sharded_snapshot": type(snap).__name__,
        "schedule": [np.asarray(c).tolist() for c in sched],
        "proper": bool(is_proper(svc.graph("sh"), svc.colors("sh")))}

    # -- the ladder on a sharded state --------------------------------------
    st = api.color(g, mode="incremental", backend="distributed",
                   mesh=mesh_of(8), seed=0).state
    # C=1 overflows on the first recolor; the repair still runs until
    # max_rounds before its overflow flag is read, so the bound is cut
    st_poor = dataclasses.replace(st, C=1, max_cap_retries=0, max_rounds=16)
    ins = ladder_inserts(st.colors)
    none = np.zeros((0, 2), np.int64)
    st2, rung = ladder.apply_with_ladder(st_poor, ins, none)
    st3 = ladder.oracle_state(st_poor, ins, none)
    out["ladder"] = {
        "rung": int(rung), "state": state_entry(st2),
        "type": type(st2).__name__, "oracle": state_entry(st3),
        "proper": bool(is_proper(state_to_csr(st2), st2.colors)),
        "oracle_proper": bool(is_proper(state_to_csr(st3), st3.colors))}

    # -- color.corrupt on a sharded tenant: the service's verification
    # rolls the step back and the next step commits -------------------------
    svc = make_service(megabatch=False, quarantine_after=99)
    svc.add_graph("sh", g, mesh=mesh_of(4), seed=0)
    ins, dels = next(stream(n, 5, 1))
    with faults.inject("color.corrupt:times=1:k=3"):
        svc.submit("sh", inserts=ins, deletes=dels)
        first = svc.step("sh")["sh"].get("rolled_back")
        version = svc.version("sh")
        svc.step("sh")
    out["corrupt"] = {"rolled_back": first,
                      "version_after_rollback": int(version),
                      "healed": state_entry(svc.snapshot("sh"))}
    return out


def reference_results() -> dict:
    import jax
    from repro import api
    from repro.core.coloring import is_proper
    from repro.dynamic import ColoringService, delta, recolor_sharded
    from repro.dynamic import service as service_mod
    from repro.graphs import generators as gen
    from repro.obs import metrics
    from repro.resilience import faults, ladder

    meshes = {D: jax.make_mesh((D,), ("data",)) for D in (1, 4, 8)}
    return flows(api, recolor_sharded, ladder, faults, service_mod,
                 lambda **kw: ColoringService(**dict(dict(megabatch=True),
                                                     **kw)),
                 meshes.get, gen, is_proper, delta.state_to_csr, metrics)


SCRIPT = r"""
import os, sys, json, importlib.util
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
spec = importlib.util.spec_from_file_location("tsharded", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
print(json.dumps(m.reference_results()))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_FAULTS", None)
    p = subprocess.run([sys.executable, "-c", SCRIPT, os.path.abspath(
        __file__)], capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def cpu_mesh(D: int):
    return tmesh.make_mesh((D,), ("data",), device="cpu")


@pytest.fixture(scope="module")
def port():
    return flows(tapi, tsh.recolor_sharded, tladder, tfaults, tservice,
                 lambda **kw: TService(**dict(dict(megabatch=True),
                                              device="cpu", **kw)),
                 cpu_mesh, tgen, tcol.is_proper, tdelta.state_to_csr,
                 tmetrics)


def test_one_shard_equals_reference(ref, port):
    assert len(port["one_shard"]) == 6
    for i, (a, b) in enumerate(zip(port["one_shard"], ref["one_shard"])):
        assert a == b, f"batch {i}"


def test_one_shard_equals_local_incremental(port):
    """The reference's stated bar, in the port: one shard replays
    ``mode="incremental"`` bit for bit across the stream."""
    g = tgen.mesh2d(24, 24)
    st = tapi.color(g, mode="incremental", seed=0, device="cpu").state
    rows = port["one_shard"]
    for i, (ins, dels) in enumerate([(None, None)]
                                    + list(stream(g.n_vertices, 7, 5))):
        if i:
            st = t_recolor_inc(st, ins, dels)
        row = rows[i]
        assert row["colors"] == st.colors.tolist(), i
        for f in ("C", "last_rounds", "last_conflicts",
                  "last_gather_passes", "total_gather_passes", "version"):
            assert row[f] == getattr(st, f), (i, f)
    assert rows[-1]["last_halo_bytes"] > 0


@pytest.mark.parametrize("D", SHARDS)
def test_multi_shard_stream_equals_reference(ref, port, D):
    """Every batch, the re-planning one included, at 4 and 8 shards."""
    rows, want = port[f"shards{D}"], ref[f"shards{D}"]
    assert len(rows) == len(want) == 6
    for i, (a, b) in enumerate(zip(rows, want)):
        assert a == b, f"D={D} batch {i}"
    assert rows[-1]["proper"]
    assert rows[-1]["summary"]["n_shards"] == D
    assert 0 < rows[-1]["halo_bytes_per_round"] < D * 4 * 576


def test_replan_heals_capacity(port):
    """The 3000-edge batch outgrows the halo slack and re-plans."""
    assert port["shards8"][-1]["replans"] >= 1


def test_service_sharded_tenant_equals_reference(ref, port):
    a, b = port["service"], ref["service"]
    assert a == b
    assert a["halo_bytes"]["sh"] > 0 and a["halo_bytes"]["loc"] == 0
    assert a["sharded_snapshot"] == "ShardedColoringState"
    assert a["restore_version"] > 0 and a["proper"]
    assert sum(len(c) for c in a["schedule"]) == 576


def test_ladder_on_sharded_state_equals_reference(ref, port):
    a, b = port["ladder"], ref["ladder"]
    assert a == b
    assert a["rung"] >= 1 and a["state"]["last_degrade_rung"] == a["rung"]
    assert a["type"] == "ShardedColoringState" and a["proper"]
    assert a["oracle"]["last_degrade_rung"] == 2 and a["oracle_proper"]


def test_corrupt_on_sharded_tenant_equals_reference(ref, port):
    """The step is rolled back and the next one commits the same state.
    The rollback's reason differs: the reference's payload
    (``_corrupt_colors_sharded``) writes shard 0's table with ``.at[0,
    v].set``, which this JAX refuses on an array with a sharding
    (``ShardingTypeError``), so its step fails with "error" where the
    port's verification finds the corrupted colours "improper"."""
    a, b = port["corrupt"], ref["corrupt"]
    assert a["rolled_back"] == "improper"
    assert b["rolled_back"] in ("improper", "error")
    assert a["version_after_rollback"] == b["version_after_rollback"] == 0
    assert a["healed"] == b["healed"] and a["healed"]["version"] == 1


def _corrupt_payload(st, ell0, colors0):
    """The reference's ``_corrupt_colors_sharded`` payload over numpy: the
    colours it writes into shard 0's table, drawn from the armed site's
    RNG."""
    n0 = min(st.blk, st.n)
    local = (ell0 != -1) & (ell0 < st.n_loc)
    live_rows = np.nonzero(local[:n0].any(axis=1))[0]
    r = tfaults.rng("color.corrupt")
    k = min(max(1, int(tfaults.param("color.corrupt", "k", 1))),
            len(live_rows))
    out = colors0.copy()
    for v in r.choice(live_rows, size=k, replace=False):
        w = int(ell0[int(v)][local[int(v)]][0])
        out[int(v)] = int(colors0[w])
    return out


def test_corrupt_on_a_four_shard_tenant():
    """The port's payload writes the reference's colours (its numpy
    transcription, ``_corrupt_payload``) into a copy of shard 0's table,
    and the service's verification rolls the step back."""
    g = tgen.mesh2d(24, 24)
    st = tapi.color(g, mode="incremental", backend="distributed",
                    mesh=cpu_mesh(4), seed=0).state
    before = st.stacked("colors_tab").copy()
    with tfaults.inject("color.corrupt:times=1:k=3"):
        assert tfaults.fires("color.corrupt")
        bad = tservice._corrupt_colors(st)
    with tfaults.inject("color.corrupt:times=1:k=3"):
        assert tfaults.fires("color.corrupt")
        want = _corrupt_payload(st, st.stacked("ell")[0], before[0])
    np.testing.assert_array_equal(bad.stacked("colors_tab")[0], want)
    np.testing.assert_array_equal(bad.stacked("colors_tab")[1:], before[1:])
    np.testing.assert_array_equal(st.stacked("colors_tab"), before)
    assert not np.array_equal(bad.stacked("colors_tab"), before)
    assert not tcol.is_proper(g, bad.colors)
    svc = TService(megabatch=False, quarantine_after=99, device="cpu")
    svc.add_graph("sh", g, mesh=cpu_mesh(4), seed=0)
    ins, dels = next(stream(g.n_vertices, 5, 1))
    with tfaults.inject("color.corrupt:times=1:k=3"):
        svc.submit("sh", inserts=ins, deletes=dels)
        assert svc.step("sh")["sh"]["rolled_back"] == "improper"
        assert svc.version("sh") == 0
        svc.step("sh")
    assert svc.version("sh") == 1
    assert tcol.is_proper(svc.graph("sh"), svc.colors("sh"))


def test_route_allocates_like_the_reference_loop():
    """The array router against a literal transcription of the
    reference's dict walk, on a batch with repeated and crossing pairs."""
    g = tgen.rmat_b(9, 8)
    st = tapi.color(g, mode="incremental", backend="distributed",
                    mesh=cpu_mesh(4), seed=2).state
    rng = np.random.default_rng(5)
    ins = st.perm[rng.integers(0, g.n_vertices, size=(400, 2))]
    ins = np.concatenate([ins, ins[:50], ins[:20, ::-1], [[3, 3]]])
    dels = st.perm[rng.integers(0, g.n_vertices, size=(100, 2))]
    dels = np.concatenate([dels, ins[:30]])
    got_b, got_a = tsh._route(dataclasses.replace(
        st, boundary=np.pad(st.boundary, ((0, 0), (0, 4096)),
                            constant_values=-1),
        ghost_ids=np.pad(st.ghost_ids, ((0, 0), (0, 4096)),
                         constant_values=-1),
        ghost_flat=np.pad(st.ghost_flat, ((0, 0), (0, 4096)),
                          constant_values=-1)), ins, dels)
    want_b, want_a = _route_loop(st, ins, dels, st.max_b_cap + 4096)
    for (gi, gd), (wi, wd) in zip(got_b, want_b):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    for d in range(st.n_shards):
        np.testing.assert_array_equal(got_a[0][d], want_a[0][d])
        np.testing.assert_array_equal(got_a[1][d][0], want_a[1][d][0])
        np.testing.assert_array_equal(got_a[1][d][1], want_a[1][d][1])
    np.testing.assert_array_equal(got_a[2], want_a[2])
    np.testing.assert_array_equal(got_a[3], want_a[3])
    assert sum(map(len, want_a[0])) > 0


def _route_loop(state, ins_r, dels_r, max_b):
    """The reference's ``_route`` walk (``src/repro/dynamic/sharded.py``),
    transcribed over numpy pair lists, with ``max_b`` the boundary cap."""
    D, blk, n_loc = state.n_shards, state.blk, state.n_loc
    gmap = [{int(v): i for i, v in enumerate(
        state.ghost_ids[d, :int(state.n_ghost[d])])} for d in range(D)]
    bmap = [{int(state.boundary[d, j]) + d * blk: j
             for j in range(int(state.n_boundary[d]))} for d in range(D)]
    n_b = [int(x) for x in state.n_boundary]
    n_g = [int(x) for x in state.n_ghost]
    new_bnd, new_gst = [[] for _ in range(D)], [[] for _ in range(D)]
    ins_sh, del_sh = [[] for _ in range(D)], [[] for _ in range(D)]

    def boundary_slot(owner, v):
        j = bmap[owner].get(v)
        if j is None:
            j = n_b[owner]
            n_b[owner] += 1
            bmap[owner][v] = j
            new_bnd[owner].append(v - owner * blk)
        return j

    def ghost_slot(d, owner, v):
        i = gmap[d].get(v)
        if i is None:
            j = boundary_slot(owner, v)
            i = n_g[d]
            n_g[d] += 1
            gmap[d][v] = i
            new_gst[d].append((v, owner * max_b + j))
        return n_loc + i

    def shard(v):
        return min(v // blk, D - 1)

    for u, v in ins_r:
        u, v = int(u), int(v)
        du, dv = shard(u), shard(v)
        if u == v:
            ins_sh[du].append((u - du * blk, u - du * blk))
            continue
        tu = (v - du * blk) if dv == du else ghost_slot(du, dv, v)
        ins_sh[du].append((u - du * blk, tu))
        tv = (u - dv * blk) if du == dv else ghost_slot(dv, du, u)
        ins_sh[dv].append((v - dv * blk, tv))
    for u, v in dels_r:
        u, v = int(u), int(v)
        du, dv = shard(u), shard(v)
        if u == v:
            del_sh[du].append((u - du * blk, u - du * blk))
            continue
        gi = gmap[du].get(v) if dv != du else None
        tu = ((v - du * blk) if dv == du
              else (n_loc + gi if gi is not None else u - du * blk))
        del_sh[du].append((u - du * blk, tu))
        gj = gmap[dv].get(u) if du != dv else None
        tv = ((u - dv * blk) if du == dv
              else (n_loc + gj if gj is not None else v - dv * blk))
        del_sh[dv].append((v - dv * blk, tv))

    def pairs(lst):
        return (np.asarray(lst, np.int32).reshape(-1, 2) if lst
                else np.zeros((0, 2), np.int32))

    batches = [(pairs(ins_sh[d]), pairs(del_sh[d])) for d in range(D)]
    gst = [(np.asarray([v for v, _ in new_gst[d]], np.int64),
            np.asarray([f for _, f in new_gst[d]], np.int32))
           for d in range(D)]
    bnd = [np.asarray(new_bnd[d], np.int32) for d in range(D)]
    return batches, (bnd, gst, np.asarray(n_b), np.asarray(n_g))


@pytest.mark.cuda
def test_sharded_stream_on_the_card_equals_cpu(cuda_device):
    """The 4-shard stream with its re-planning batch, on the card (B1 / B2
    launches) against the CPU (the plain versions), state for state."""
    g = tgen.mesh2d(24, 24)
    states = []
    for mesh in (tmesh.make_mesh((4,), ("data",), device=cuda_device),
                 cpu_mesh(4)):
        st = tapi.color(g, mode="incremental", backend="distributed",
                        mesh=mesh, seed=0).state
        rows = [state_entry(st)]
        for ins, dels in stream(g.n_vertices, 11, 4):
            st = tsh.recolor_sharded(st, ins, dels)
            rows.append(state_entry(st))
        st = tsh.recolor_sharded(st, big_batch(g.n_vertices), None)
        rows.append(state_entry(st))
        states.append(rows)
    assert states[0] == states[1]
