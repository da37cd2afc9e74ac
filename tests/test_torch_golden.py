"""``tests/torch_golden.json`` is current on both sides: it equals what the
JAX reference package produces today and what the port produces on the CPU.

``chip_smoke.py`` holds the port's output on a GPU against the same file,
which is how the card's results are tied to the reference's without JAX on
that machine.  Integer results and a SHA-256 of the color bytes: the bar is
equality.  Regenerate with ``tests/make_torch_golden.py``.
"""
import importlib.util
import json
import os

import pytest
import torch

from repro import api as japi
from repro.dynamic import ColoringService as JService
from repro.dynamic import recolor_incremental as j_recolor
from repro.graphs import generators as j_generators
from repro_torch import api as tapi
from repro_torch.dynamic import ColoringService as TService
from repro_torch.dynamic import recolor_incremental as t_recolor
from repro_torch.graphs import generators as t_generators

# one intra-op thread: the tensors here are tiny, and a pool of OpenMP
# threads per test worker only takes cores from the other workers
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(HERE, "make_torch_golden.py"))
make_torch_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_torch_golden)

with open(make_torch_golden.PATH) as _f:
    _DOC = json.load(_f)
GOLDEN = _DOC["results"]
GOLDEN_INC = _DOC["incremental"]
GOLDEN_SVC = _DOC["service"]

J_RUNS = {key: (g, kw) for key, g, kw in make_torch_golden.runs(j_generators)}
T_RUNS = {key: (g, kw) for key, g, kw in make_torch_golden.runs(t_generators)}
KEYS = sorted(J_RUNS)


def test_golden_file_covers_the_suite():
    assert sorted(GOLDEN) == KEYS == sorted(T_RUNS)
    assert sum(k.startswith("d2/") for k in KEYS) == 18
    assert sum(k.startswith("partial/") for k in KEYS) == 6
    for algo in make_torch_golden.BASELINES:
        assert sum(k.startswith(f"{algo}/") for k in KEYS) == 18
    for entry in GOLDEN.values():
        assert sorted(entry) == sorted(make_torch_golden.FIELDS
                                       + ("colors_sha256",))
        assert len(entry["colors_sha256"]) == 64


# ids as "<graph>-<seed>" for the distance-1 entries (their ids since the
# file began), "d2-<graph>-<seed>", "partial-<graph>-<seed>" and
# "<cat|gm|jp>-<graph>-<seed>" for the rest
@pytest.mark.parametrize(
    "key", KEYS, ids=lambda k: k.replace("/seed=", "-").replace("/", "-"))
def test_golden_equals_reference_and_port(key):
    want = GOLDEN[key]
    g, kw = J_RUNS[key]
    assert make_torch_golden.entry(japi.color(g, **kw)) == want, \
        "reference package"
    g, kw = T_RUNS[key]
    assert make_torch_golden.entry(
        tapi.color(g, device="cpu", **kw)) == want, "port"


J_SUITE = j_generators.paper_suite("tiny")
T_SUITE = t_generators.paper_suite("tiny")


def test_golden_dynamic_sections_cover_the_suite():
    assert sorted(GOLDEN_INC) == sorted(J_SUITE)
    for rows in GOLDEN_INC.values():
        assert len(rows) == make_torch_golden.STREAM_BATCHES
        assert [r["version"] for r in rows] == list(range(1, 11))
    assert len(GOLDEN_SVC) == make_torch_golden.SVC_STEPS
    assert all(len(s) == make_torch_golden.SVC_TENANTS for s in GOLDEN_SVC)


@pytest.mark.parametrize("name", sorted(J_SUITE))
def test_golden_incremental_equals_reference_and_port(name):
    want = GOLDEN_INC[name]
    assert make_torch_golden.incremental_stream(
        japi.color, j_recolor, J_SUITE[name]) == want, "reference package"
    port = lambda g, **kw: tapi.color(g, device="cpu", **kw)  # noqa: E731
    assert make_torch_golden.incremental_stream(
        port, t_recolor, T_SUITE[name]) == want, "port"


def test_golden_service_equals_reference_and_port():
    assert make_torch_golden.service_entries(
        JService(megabatch=True, **make_torch_golden.SVC_OPTS),
        j_generators) == GOLDEN_SVC, "reference package"
    assert make_torch_golden.service_entries(
        TService(megabatch=True, device="cpu", **make_torch_golden.SVC_OPTS),
        t_generators) == GOLDEN_SVC, "port"


@pytest.fixture(scope="module", autouse=True)
def mesh_reference():
    """The reference's multi-device sections, made again in a subprocess
    whose JAX sees 4 host devices; started with this file's first test and
    read by its last, so the port's tests run meanwhile."""
    proc = make_torch_golden.start_mesh_sections()
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


GOLDEN_DIST = _DOC["distributed"]
GOLDEN_SHARDED = _DOC["sharded"]
T_DIST = {key: (g, D, kw)
          for key, g, D, kw in make_torch_golden.dist_runs(t_generators)}


def _cpu_mesh(D: int):
    from repro_torch.core.mesh import make_mesh
    return make_mesh((D,), ("data",), device="cpu")


def test_golden_mesh_sections_cover_the_suite():
    keys = sorted(key for key, *_ in make_torch_golden.dist_runs(
        j_generators))
    assert sorted(GOLDEN_DIST) == keys == sorted(T_DIST)
    assert len(keys) == (len(J_SUITE) * len(make_torch_golden.SEEDS)
                         * len(make_torch_golden.DIST_ALGOS)
                         * len(make_torch_golden.DIST_SHARDS))
    assert sorted(GOLDEN_SHARDED) == [
        f"D={D}" for D in make_torch_golden.DIST_SHARDS]
    for D, rows in GOLDEN_SHARDED.items():
        assert [r["version"] for r in rows] == list(
            range(1, make_torch_golden.SHARD_BATCHES + 1))
        assert all(r["n_shards"] == int(D[2:]) for r in rows)


@pytest.mark.parametrize(
    "key", sorted(T_DIST),
    ids=lambda k: k.replace("/seed=", "-").replace("/", "-"))
def test_golden_distributed_equals_port(key):
    g, D, kw = T_DIST[key]
    assert make_torch_golden.entry(
        tapi.color(g, mesh=_cpu_mesh(D), **kw)) == GOLDEN_DIST[key], "port"


def test_golden_sharded_equals_port():
    from repro_torch.dynamic import recolor_sharded
    assert make_torch_golden.sharded_stream(
        tapi.color, recolor_sharded, _cpu_mesh, t_generators) == \
        GOLDEN_SHARDED, "port"


# the last test of this file: it waits for the subprocess started with the
# first one
def test_golden_mesh_sections_equal_reference(mesh_reference):
    got = make_torch_golden.finish_mesh_sections(mesh_reference)
    assert got["distributed"] == GOLDEN_DIST, "reference package"
    assert got["sharded"] == GOLDEN_SHARDED, "reference package"
