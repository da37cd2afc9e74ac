"""The port's distributed static engines against the reference's:
``api.color(g, backend="distributed", algorithm="rsoc" | "cat")`` and
``build_rsoc_halo`` on meshes of 1, 2, 4 and 8 shards, every
``ColoringResult`` field bit-equal (``repro_torch.core.distributed`` on the
CPU against ``repro.core.distributed``).

The reference's multi-device side needs ``XLA_FLAGS`` set before JAX is
imported, so it runs once, in one module-scoped subprocess (this file's
``reference_results``), as ``tests/test_distributed.py`` does; the 1-shard
case also runs in-process against ``jax.make_mesh((1,), ("data",))``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.core import distributed as tdist
from repro_torch.core import mesh as tmesh
from repro_torch.core import partition as tpart
from repro_torch.core.context import PassContext as TPassContext
from repro_torch.graphs import generators as tgen
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SHARDS = (1, 2, 4, 8)
HALO_SHARDS = (1, 4, 8)
ALGOS = ("rsoc", "cat")
# the reference's own test's knobs (tests/test_distributed.py)
OPTS = dict(seed=1, n_chunks=2, max_rounds=64)
FIELDS = ("n_rounds", "total_conflicts", "n_colors", "overflow",
          "gather_passes", "final_C", "retries", "distance",
          "trace_truncated")


def graphs(gen) -> dict:
    """The graphs of the differential: the reference test's two, and the
    tiny paper suite (under its own names)."""
    out = {"mesh2d_24": gen.mesh2d(24, 24), "rmat_b_9_8": gen.rmat_b(9, 8)}
    out.update({f"tiny_{k}": g for k, g in gen.paper_suite("tiny").items()})
    return out


# the tiny suite at 1 and 4 shards, seeds 0-2, is tests/torch_golden.json's
# "distributed" section (tests/test_torch_golden.py); here it runs at 8
TINY_D = 8


def static_runs(gen):
    """``(key, graph, D, spec overrides)``: the two graphs at every D with
    ``OPTS``; the tiny suite at ``TINY_D`` with the default spec."""
    for name, g in graphs(gen).items():
        for algo in ALGOS:
            if name.startswith("tiny_"):
                yield (f"{algo}/{name}/D={TINY_D}", g, TINY_D,
                       dict(algorithm=algo))
                continue
            for D in SHARDS:
                yield (f"{algo}/{name}/D={D}", g, D,
                       dict(algorithm=algo, **OPTS))


def result_entry(res) -> dict:
    d = {f: (bool(getattr(res, f)) if isinstance(getattr(res, f), (bool,
                                                                  np.bool_))
             else int(getattr(res, f))) for f in FIELDS}
    d["colors"] = np.asarray(res.colors).tolist()
    d["colors_dtype"] = str(np.asarray(res.colors).dtype)
    d["conflicts_per_round"] = np.asarray(res.conflicts_per_round).tolist()
    d["conflicts_dtype"] = str(np.asarray(res.conflicts_per_round).dtype)
    return d


def halo_inputs(part, plan, seed: int):
    """numpy inputs of ``build_rsoc_halo`` from either package's partition
    and halo plan: each (D, ...) with the shard axis first."""
    D, n_loc, n = part.n_shards, part.n_loc, part.n
    n_pad = D * n_loc
    pri = np.full((n_pad,), -1, np.int32)
    pri[:n] = np.random.default_rng(seed + 1).permutation(n)
    own = plan.ghost_owner.astype(np.int64)
    live = own >= 0
    src = np.where(live, own, 0)
    slot = np.where(live, plan.ghost_slot, 0)
    gid = src * n_loc + plan.boundary[src, slot]
    pri_ghost = np.where(live, pri[np.clip(gid, 0, n_pad - 1)], -1)
    ghost_flat = np.where(live, own * plan.max_b + plan.ghost_slot, -1)
    valid = (np.arange(n_pad) < n).reshape(D, n_loc)
    return dict(ell=plan.ell_local, pri_loc=pri.reshape(D, n_loc),
                pri_ghost=pri_ghost.astype(np.int32),
                boundary=plan.boundary,
                ghost_flat=ghost_flat.astype(np.int32), valid=valid)


def halo_runs(gen):
    for name in ("mesh2d_24", "rmat_b_9_8"):
        for D in HALO_SHARDS:
            yield f"halo/{name}/D={D}", graphs(gen)[name], D


HALO_CHUNKS, HALO_C, HALO_SEED = 4, 64, 3


def halo_entry(colors_l, r, trace, tot, part) -> dict:
    colors = np.asarray(colors_l)[part.perm]
    return {"colors": colors.tolist(), "rounds": int(r),
            "trace": np.asarray(trace)[:min(int(r), 64)].tolist(),
            "total": int(tot)}


def reference_results() -> dict:
    """The reference package's results of every run of this file (run in
    a process whose JAX sees 8 host devices)."""
    import jax
    from repro import api
    from repro.core import distributed as jdist
    from repro.core import partition as jpart
    from repro.core.context import PassContext
    from repro.graphs import generators as gen

    meshes = {D: jax.make_mesh((D,), ("data",)) for D in SHARDS}
    out = {key: result_entry(api.color(g, backend="distributed",
                                       mesh=meshes[D], **kw))
           for key, g, D, kw in static_runs(gen)}
    for key, g, D in halo_runs(gen):
        part = jpart.block_partition(g, D, seed=HALO_SEED)
        plan = jpart.build_halo(part)
        x = halo_inputs(part, plan, HALO_SEED)
        ctx = PassContext(n=part.n, n_pad=part.n_pad, C=HALO_C,
                          n_chunks=HALO_CHUNKS, forbidden_impl="bitset")
        shapes = dict(D=D, n_loc=part.n_loc, max_b=plan.max_b,
                      max_g=plan.max_g)
        fn = jdist.build_rsoc_halo(meshes[D], "data", shapes, ctx, 64)
        res = fn(*(x[k].reshape((D * x[k].shape[1],) + x[k].shape[2:])
                   for k in ("ell", "pri_loc", "pri_ghost", "boundary",
                             "ghost_flat", "valid")))
        out[key] = halo_entry(*res, part)
    return out


SCRIPT = r"""
import os, sys, json, importlib.util
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
spec = importlib.util.spec_from_file_location("tdist", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
print(json.dumps(m.reference_results()))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", SCRIPT, os.path.abspath(
        __file__)], capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def cpu_mesh(D: int):
    return tmesh.make_mesh((D,), ("data",), device="cpu")


STATIC = {key: (g, D, kw) for key, g, D, kw in static_runs(tgen)}


@pytest.mark.parametrize("key", sorted(STATIC))
def test_static_engine_equals_reference(ref, key):
    g, D, kw = STATIC[key]
    res = tapi.color(g, backend="distributed", mesh=cpu_mesh(D), **kw)
    assert result_entry(res) == ref[key]


HALO = {key: (g, D) for key, g, D in halo_runs(tgen)}


@pytest.mark.parametrize("key", sorted(HALO))
def test_halo_engine_equals_reference(ref, key):
    g, D = HALO[key]
    part = tpart.block_partition(g, D, seed=HALO_SEED)
    plan = tpart.build_halo(part)
    x = halo_inputs(part, plan, HALO_SEED)
    ctx = TPassContext(n=part.n, n_pad=part.n_pad, C=HALO_C,
                       n_chunks=HALO_CHUNKS, forbidden_impl="bitset")
    shapes = dict(D=D, n_loc=part.n_loc, max_b=plan.max_b, max_g=plan.max_g)
    fn = tdist.build_rsoc_halo(cpu_mesh(D), "data", shapes, ctx, 64)
    args = [[torch.from_numpy(np.ascontiguousarray(x[k][d]))
             for d in range(D)]
            for k in ("ell", "pri_loc", "pri_ghost", "boundary",
                      "ghost_flat", "valid")]
    got = halo_entry(*fn(*args), part)
    assert got == ref[key]
    from repro_torch.core.coloring import is_proper
    assert is_proper(g, np.asarray(got["colors"]))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["mesh2d_24", "rmat_b_9_8"])
def test_one_shard_in_process(algo, name):
    """D = 1 against the reference's 1-device mesh in this process."""
    import jax
    from repro import api as japi
    from repro.graphs import generators as jgen
    jres = japi.color(graphs(jgen)[name], algorithm=algo,
                      backend="distributed",
                      mesh=jax.make_mesh((1,), ("data",)), **OPTS)
    tres = tapi.color(graphs(tgen)[name], algorithm=algo,
                      backend="distributed", mesh=cpu_mesh(1), **OPTS)
    assert result_entry(tres) == result_entry(jres)


@pytest.mark.parametrize("algo,per_round", [("rsoc", 1), ("cat", 2)])
def test_collectives_per_round(algo, per_round):
    """RSOC: one collective a round (and one for round 0); CAT: two."""
    g = tgen.mesh2d(24, 24)
    tmetrics.reset()
    res = tapi.color(g, algorithm=algo, backend="distributed",
                     mesh=cpu_mesh(4), **OPTS)
    assert res.n_rounds >= 1
    assert tmesh.collectives() == per_round * (1 + res.n_rounds)
    assert tmesh.collectives() == res.gather_passes
    # a round gathers the color vector (4 shards x 144 rows) and one int32
    # a shard: in one payload (RSOC) or two (CAT)
    assert tmesh.gathered_bytes() == (1 + res.n_rounds) * (4 * 144 + 4) * 4


def test_two_axis_mesh_flattens_row_major():
    """``axis="a,b"`` over a 2 x 2 mesh is the 4-shard mesh."""
    g = tgen.rmat_b(9, 8)
    m2 = tmesh.make_mesh((2, 2), ("a", "b"), device="cpu")
    a = tapi.color(g, backend="distributed", mesh=m2, axis="a,b", **OPTS)
    b = tapi.color(g, backend="distributed", mesh=cpu_mesh(4), **OPTS)
    assert result_entry(a) == result_entry(b)
    assert m2.shape == {"a": 2, "b": 2} and hash(m2) == hash(
        tmesh.make_mesh((2, 2), ("a", "b"), device="cpu"))
    with pytest.raises(ValueError, match="every axis"):
        tapi.color(g, backend="distributed", mesh=m2, axis="a")


def test_mesh_required_and_device_rule():
    g = tgen.mesh2d(4, 4)
    for kw in (dict(), dict(mode="incremental")):
        with pytest.raises(ValueError, match="requires a device mesh") as e:
            tapi.color(g, backend="distributed", **kw)
        assert "repro_torch.core.mesh.make_mesh" in str(e.value)
    with pytest.raises(ValueError, match="contradicts the mesh"):
        tapi.color(g, backend="distributed", mesh=cpu_mesh(2),
                   device="cuda")
    res = tapi.color(g, backend="distributed", mesh=cpu_mesh(2),
                     device="cpu")
    assert res.colors.shape == (16,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_mesh((2,), ("data",))


def test_legacy_shim():
    g = tgen.mesh2d(24, 24)
    with pytest.warns(DeprecationWarning):
        a = tdist.color_distributed(g, cpu_mesh(2), algorithm="cat",
                                    seed=1, n_chunks=2)
    b = tapi.color(g, algorithm="cat", backend="distributed",
                   mesh=cpu_mesh(2), seed=1, n_chunks=2, max_rounds=64)
    assert result_entry(a) == result_entry(b)


def test_all_gather_stacks_per_device():
    tmetrics.reset()
    p = [torch.full((3,), d, dtype=torch.int32) for d in range(4)]
    out = tmesh.all_gather(p)
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert out[0].tolist() == [[d] * 3 for d in range(4)]
    assert tmesh.collectives() == 1 and tmesh.gathered_bytes() == 48
    with pytest.raises(ValueError, match="payloads differ"):
        tmesh.all_gather([p[0], p[1][:2]])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_on_the_card_equals_cpu(cuda_device, algo):
    """Four shards sharing the card (B1 / B2 launches) against four on the
    CPU (the plain versions)."""
    g = tgen.rmat_b(9, 8)
    mesh = tmesh.make_mesh((4,), ("data",), device=cuda_device)
    a = tapi.color(g, algorithm=algo, backend="distributed", mesh=mesh,
                   **OPTS)
    b = tapi.color(g, algorithm=algo, backend="distributed",
                   mesh=cpu_mesh(4), **OPTS)
    assert result_entry(a) == result_entry(b)
