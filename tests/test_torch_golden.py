"""``tests/torch_golden.json`` is current on both sides: it equals what the
JAX reference package produces today and what the port produces on the CPU.

``chip_smoke.py`` holds the port's output on a GPU against the same file,
which is how the card's results are tied to the reference's without JAX on
that machine.  Integer results and a SHA-256 of the color bytes: the bar is
equality; the ``gnn``, ``lm_train`` and ``models`` sections' float values
are held to stated tolerances.
Regenerate with ``tests/make_torch_golden.py``.
"""
import importlib.util
import json
import os

import numpy as np
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


GOLDEN_GNN = _DOC["gnn"]
# the port's loss histories against the reference's: float32 in another
# order, six AdamW steps (measured at about 2e-7 on the CPU)
GNN_RTOL = 1e-4


def test_golden_gnn_losses_equal_reference_and_port():
    """Six training steps of each GNN smoke model (``gnn_leaf_values``
    weights): the reference today gives the file's numbers (rtol 1e-6: the
    same program), the port on the CPU within ``GNN_RTOL``."""
    assert sorted(GOLDEN_GNN["losses"]) == sorted(
        make_torch_golden.GNN_ARCHS)
    got = make_torch_golden.reference_gnn_losses()
    for arch, want in GOLDEN_GNN["losses"].items():
        assert len(want) == make_torch_golden.GNN_STEPS
        np.testing.assert_allclose(got[arch], want, rtol=1e-6, err_msg=arch)
    got = make_torch_golden.port_gnn_losses("cpu")
    for arch, want in GOLDEN_GNN["losses"].items():
        np.testing.assert_allclose(got[arch], want, rtol=GNN_RTOL,
                                   err_msg=arch)


def test_golden_halo_loss_equals_port():
    """The port's halo GatedGCN on the ring at 4 CPU shards against the
    reference's ``shard_map`` loss in the file (rtol 1e-5)."""
    from repro_torch import tree
    from repro_torch.core import partition
    from repro_torch.graphs import csr
    from repro_torch.models import gnn
    _, shards, _ = make_torch_golden.halo_ring(partition, csr)
    cfg = gnn.GatedGCNConfig(**make_torch_golden.HALO_CFG)
    params = gnn.gatedgcn_init(torch.Generator().manual_seed(0), cfg, "cpu")
    vals = make_torch_golden.gnn_leaf_values(
        [(k, tuple(x.shape)) for k, x in tree.flatten_with_paths(params)])
    with torch.no_grad():
        for k, x in tree.flatten_with_paths(params):
            x.copy_(torch.from_numpy(vals[k]))
    loss = gnn.gatedgcn_halo_loss(
        params, cfg, [{k: torch.from_numpy(v) for k, v in s.items()}
                      for s in shards], _cpu_mesh(make_torch_golden.HALO_D))
    np.testing.assert_allclose(float(loss.detach()), GOLDEN_GNN["halo_loss"],
                               rtol=1e-5)


GOLDEN_LM = _DOC["lm_train"]
# the port's LM training against the reference's (float32 in another order;
# measured on the CPU at about 1e-7 on the losses, 1e-6 of a leaf's largest
# gradient, 1e-8 on the values after the steps)
LM_TOL = dict(loss_rtol=1e-5, grad_atol=1e-4, after_atol=1e-5)


def check_lm_train(got: dict, want: dict, tol: dict, who: str):
    """``got`` (``lm_summary`` of each arch) against the file's entries:
    losses within ``loss_rtol``, each picked gradient value within
    ``grad_atol`` of its leaf's largest reference gradient, each value
    after the steps within ``after_atol``."""
    assert sorted(got) == sorted(want), who
    for arch, w in want.items():
        g = got[arch]
        assert g["tokens"] == w["tokens"], (who, arch)
        np.testing.assert_allclose(g["loss"], w["loss"],
                                   rtol=tol["loss_rtol"], err_msg=who)
        np.testing.assert_allclose(g["losses"], w["losses"],
                                   rtol=tol["loss_rtol"], err_msg=who)
        assert sorted(g["grad"]) == sorted(w["grad"]), who
        for path, wg in w["grad"].items():
            assert g["grad"][path]["index"] == wg["index"], (who, path)
            np.testing.assert_allclose(
                g["grad"][path]["values"], wg["values"], rtol=0,
                atol=tol["grad_atol"] * wg["absmax"],
                err_msg=f"{who} {arch} {path}")
            np.testing.assert_allclose(
                g["after_steps"][path], w["after_steps"][path], rtol=0,
                atol=tol["after_atol"], err_msg=f"{who} {arch} {path}")


def test_golden_lm_train_equals_reference():
    """The reference today gives the file's ``lm_train`` section (1e-6: the
    same program)."""
    assert sorted(GOLDEN_LM) == sorted(make_torch_golden.LM_ARCHS)
    check_lm_train(make_torch_golden.reference_lm_train(), GOLDEN_LM,
                   dict(loss_rtol=1e-6, grad_atol=1e-6, after_atol=1e-7),
                   "reference package")


def test_golden_lm_train_equals_port():
    """The port on the CPU within ``LM_TOL`` of the file's section: loss and
    gradient of the first batch, three steps' losses and values, from
    ``lm_leaf_values`` weights over the file's batches."""
    check_lm_train(make_torch_golden.port_lm_train("cpu", GOLDEN_LM),
                   GOLDEN_LM, LM_TOL, "port")


GOLDEN_MODELS = _DOC["models"]
# the port's smoke nequip / dcn-v2 against the reference's (float32 in
# another order; measured on the CPU at about 1e-7 on the forward and the
# losses, 1e-7 of the leaf's largest gradient)
MODELS_TOL = dict(forward_rel=1e-5, grad_rel=1e-4, loss_rtol=1e-4)


def check_models(got: dict, want: dict, tol: dict, who: str):
    """``got`` (``models_summary`` of each arch) against the file's
    entries: the forward within ``forward_rel`` of its largest magnitude,
    the leaf's gradient within ``grad_rel`` of its largest, the losses
    within ``loss_rtol``."""
    assert sorted(got) == sorted(want), who
    for arch, w in want.items():
        g = got[arch]
        assert g["batches"] == w["batches"], (who, arch)
        fwd = np.abs(w["forward"]).max()
        np.testing.assert_allclose(g["forward"], w["forward"], rtol=0,
                                   atol=tol["forward_rel"] * fwd,
                                   err_msg=f"{who} {arch} forward")
        np.testing.assert_allclose(g["grad"]["values"], w["grad"]["values"],
                                   rtol=0,
                                   atol=tol["grad_rel"] * w["grad"]["absmax"],
                                   err_msg=f"{who} {arch} gradient")
        assert len(w["losses"]) == make_torch_golden.MODELS_STEPS
        np.testing.assert_allclose(g["losses"], w["losses"],
                                   rtol=tol["loss_rtol"],
                                   err_msg=f"{who} {arch} losses")


def test_golden_models_equal_reference():
    """The reference today gives the file's ``models`` section (1e-6: the
    same program), its batches drawn anew equal to the stored ones."""
    assert sorted(GOLDEN_MODELS) == sorted(make_torch_golden.MODELS_ARCHS)
    check_models(make_torch_golden.reference_models(), GOLDEN_MODELS,
                 dict(forward_rel=1e-6, grad_rel=1e-6, loss_rtol=1e-6),
                 "reference package")


def test_golden_models_equal_port():
    """The port on the CPU within ``MODELS_TOL`` of the file's section:
    the smoke nequip's per-node energies, its ``species_embed`` gradient
    through the forces and three steps' losses; the smoke dcn-v2's logits,
    a deep-tower gradient and three steps' losses; over the stored
    batches, from ``gnn_leaf_values`` weights."""
    check_models(make_torch_golden.port_models("cpu", GOLDEN_MODELS),
                 GOLDEN_MODELS, MODELS_TOL, "port")


# the last test of this file: it waits for the subprocess started with the
# first one
def test_golden_mesh_sections_equal_reference(mesh_reference):
    got = make_torch_golden.finish_mesh_sections(mesh_reference)
    assert got["distributed"] == GOLDEN_DIST, "reference package"
    assert got["sharded"] == GOLDEN_SHARDED, "reference package"
    np.testing.assert_allclose(got["halo_loss"], GOLDEN_GNN["halo_loss"],
                               rtol=1e-6, err_msg="reference package")
