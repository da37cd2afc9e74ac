"""Port vs reference: the train cells on meshes whose positions sit on
different devices (``launch.cells``' train cells with the gradient
all-reduce of ``launch.sharding.reduce_replicas`` /
``core.mesh.all_reduce_replicas``).

``torch.device("cpu", i)`` for distinct ``i`` are distinct devices to a
``Mesh``: ``place`` gives each a copy of a replicated block (a copy made
by ``.to``), while every tensor reports ``cpu``.  So these meshes take the
cross-device route on a CPU: a replicated block is one autograd leaf a
device, whose copies' gradients must be summed before the update.

* LM (``qwen3-1.7b`` on (1, 2), (2, 2), (1, 4); with ``fsdp_inner``,
  ``act_shard``, ``remat`` and 2 microbatches; ``qwen2-moe-a2.7b`` with ``moe_ep``),
  two steps against the reference's ``_lm_train_cell`` step under a 1 x 1
  mesh, as ``tests/test_torch_train_mesh.py`` holds it (smoke configs,
  float32, 4 x 24 tokens), and against the same port cell on a one-device
  mesh.  Compared after each step: loss, ``grad_norm``, ``lr``, and after
  the last every parameter and ``mu`` / ``nu`` leaf, within rtol 1e-4 and
  atol 1e-4 times the leaf's largest magnitude.
* GNN / recsys (``gatedgcn``, the halo cell, ``dcn-v2`` on (2, 2)): one
  step against the reference as ``tests/test_torch_cells_gnn_recsys.py``
  holds them, and two against the one-device cell.
* Shared devices: a (2, 4) mesh of ``cpu:0, cpu:0, cpu:1, cpu:1, ...``,
  two positions a device, where a replicated block's copies sit at
  positions (0, 2, 4, 6), which are no axis's groups.

The optimizer is the cells' ``OPT`` with a one-step warmup in both
packages, so that a step moves the weights past their tolerance (a copy
that took another step would show).  On every case, after each step:
every block's copies are bit-equal (found from the specs, not from the
code under test, by ``chip_smoke.py``'s ``td_copies``), ``grad_norm`` is
the one-device cell's (each replica set counted once), and the step's
collectives and bytes past the one-device cell's are the all-reduces
``chip_smoke.td_reckoned`` reckons from the specs: one a (pattern,
dtype), the pattern being the positions of each block's copies on
different devices.  The one-device cell's numbers equal those of the
placed update without replica sets (the update as it was before them,
run here) bit for bit, and its collective counts are the ones it made
then (``ONE_DEVICE_COLLECTIVES``).
"""
import dataclasses
import functools
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import cells as JC
from repro.models import gnn as JG
from repro.models import recsys as JRS
from repro.models import transformer as JTF
from repro.training import optimizer as JOPT
from repro_torch import configs as tconfigs
from repro_torch import tree as TT
from repro_torch.core import mesh as TM
from repro_torch.launch import cells as TC
from repro_torch.launch import sharding as TSH
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TRS
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics
from repro_torch.training import optimizer as TOPT

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
LOSS_RTOL, GNORM_RTOL, HALO_REL = 1e-5, 1e-4, 1e-5
B, L = 4, 24
STEPS = 2
J_OPT = dataclasses.replace(JC.OPT, warmup_steps=1)
T_OPT = dataclasses.replace(TC.OPT, warmup_steps=1)
ONE_BY_ONE = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
AXES = ("data", "model")


def _mesh(shape, per_device=None):
    """One ``cpu:i`` a ``per_device`` positions (None: every position on
    ``cpu``, the one-device mesh)."""
    if per_device is None:
        return TM.make_mesh(shape, AXES, device="cpu")
    n = int(np.prod(shape))
    return TM.make_mesh(shape, AXES, devices=[f"cpu:{i // per_device}"
                                              for i in range(n)])


# --------------------------------------------------------------------------
# what the specs say: a block's copies, the all-reduces of a step
# --------------------------------------------------------------------------

# chip_smoke.py's phase 5r reckons both from the specs, apart from the code
# under test (``td_copies``, ``td_reckoned``); the tests use that reckoning
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _expected_all_reduces(placed) -> tuple:
    """(all-reduces, bytes) of a step's gradient all-reduce."""
    r = chip_smoke.td_reckoned(placed)
    return r["all_reduces"], r["bytes"]


def _assert_copies_equal(placed, state, cross_device: bool):
    """Every block's copies are bit-equal (weights and moments); on a mesh
    of several devices some block has copies that are distinct tensors."""
    seen = 0
    for tree in (placed, state["mu"], state["nu"]):
        for path, blocks in chip_smoke.td_copies(tree).items():
            for d in blocks.values():
                ts = [t for _, t in d.values()]
                for t in ts[1:]:
                    assert t is not ts[0] and torch.equal(t, ts[0]), path
                    seen += 1
    assert (seen > 0) == cross_device


def _run(cell, steps=STEPS) -> list:
    """``steps`` steps: per step (metrics as floats, collectives, bytes)."""
    out = []
    for _ in range(steps):
        metrics.reset()
        _, _, m = cell.run()
        out.append(({k: float(v) for k, v in m.items()}, TM.collectives(),
                    TM.gathered_bytes()))
    return out


def _update_before_replica_sets(cfg, placed, sets, grads, state):
    """The placed update as it was before replica sets: every distinct
    block one leaf of one AdamW step."""
    blocks = [b for _, b in TSH.distinct(placed)]
    flat = {"mu": [b for _, b in TSH.distinct(state["mu"])],
            "nu": [b for _, b in TSH.distinct(state["nu"])],
            "step": state["step"]}
    _, new, m = TOPT.adamw_update(cfg, blocks, list(grads), flat)
    return placed, {"mu": TSH.with_blocks(state["mu"], new["mu"]),
                    "nu": TSH.with_blocks(state["nu"], new["nu"]),
                    "step": new["step"]}, m


def _close(got, want, what):
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


def _check_devices(build, name, shape, per, monkeypatch):
    """The cell ``build(mesh)`` builds on a mesh of ``shape`` with ``per``
    positions a ``cpu:i``, against the same cell on one device (whose
    collectives ``ONE_DEVICE_COLLECTIVES[shape, name]`` are); returns the
    several-device cell and its per-step runs."""
    one = build(_mesh(shape))
    got_one = _run(one)
    # the one-device cell is the update as it was, bit for bit, and makes
    # the collectives it made
    with monkeypatch.context() as mp:
        mp.setattr(TC, "_adamw_update_placed", _update_before_replica_sets)
        mp.setattr(TSH, "reduce_replicas",
                   lambda mesh, sets, grads: list(grads))
        old = build(_mesh(shape))
        got_old = _run(old)
    assert [r[0] for r in got_one] == [r[0] for r in got_old]
    for k in range(2):
        for a, b in zip(TT.leaves(one.args[k]["mu"].shards if k else
                                  one.args[0].shards),
                        TT.leaves(old.args[k]["mu"].shards if k else
                                  old.args[0].shards), strict=True):
            assert torch.equal(a, b)
    assert [r[1] for r in got_one] == [r[1] for r in got_old] == \
        ONE_DEVICE_COLLECTIVES[shape, name]
    _assert_copies_equal(one.args[0], one.args[1], False)
    assert _expected_all_reduces(one.args[0]) == (0, 0)
    # several devices: copies equal after each step, the all-reduces
    # reckoned from the specs, the one-device numbers
    cell = build(_mesh(shape, per))
    n, nbytes = _expected_all_reduces(cell.args[0])
    assert n > 0
    runs = []
    for step in range(STEPS):
        runs += _run(cell, 1)
        _assert_copies_equal(cell.args[0], cell.args[1], True)
        m, coll, byt = runs[-1]
        want = got_one[step]
        assert (coll - want[1], byt - want[2]) == (n, nbytes)
        np.testing.assert_allclose(m["grad_norm"], want[0]["grad_norm"],
                                   rtol=1e-6)
        np.testing.assert_allclose(m["loss"], want[0]["loss"], rtol=1e-6)
        assert m["lr"] == want[0]["lr"]
    for path in cell.args[0].shapes:
        w = one.args[0].gather(path).detach().numpy()
        _close(cell.args[0].gather(path), w, path)
        for k in ("mu", "nu"):
            _close(cell.args[1][k].gather(path),
                   one.args[1][k].gather(path).numpy(), f"{k} {path}")
    return cell, runs


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------

# remat: one checkpoint frame spans every position's devices
ALL = (("fsdp_inner", True), ("act_shard", True), ("remat", True))
# (arch, mesh, positions a cpu:i, knobs, microbatches)
LM_CASES = [
    ("qwen3-1.7b", (1, 2), 1, (), 1),
    ("qwen3-1.7b", (2, 2), 1, (), 1),
    ("qwen3-1.7b", (1, 4), 1, (), 1),
    ("qwen3-1.7b", (2, 2), 1, ALL, 2),
    # experts over model, capacity over data
    ("qwen2-moe-a2.7b", (2, 2), 1, (), 1),
    # shared devices: the norms' copies at (0, 2, 4, 6)
    ("qwen3-1.7b", (2, 4), 2, (), 1),
]
# the one-device cells' collectives a step (the placed update before
# replica sets made these: the forward's and the recompute's collectives,
# none of the update's)
ONE_DEVICE_COLLECTIVES = {
    ((1, 2), "qwen3-1.7b-plain-mb1"): [9, 9],
    ((2, 2), "qwen3-1.7b-plain-mb1"): [16, 16],
    ((1, 4), "qwen3-1.7b-plain-mb1"): [13, 13],
    ((2, 2), "qwen3-1.7b-fsdp_inner+act_shard+remat-mb2"): [96, 96],
    ((2, 2), "qwen2-moe-a2.7b-plain-mb1"): [30, 30],
    ((2, 4), "qwen3-1.7b-plain-mb1"): [20, 20],
    ((2, 2), "gatedgcn"): [2, 2],
    ((2, 2), "halo"): [3, 3],
    ((2, 2), "dcn-v2"): [4, 4],
    ((2, 4), "dcn-v2"): [4, 4],
}


def _lm_ids(case):
    arch, shape, per, knobs, m = case
    k = "+".join(n for n, _ in knobs) or "plain"
    return f"{arch}-{shape[0]}x{shape[1]}-{per}pos-{k}-mb{m}"


def _cfgs(arch, knobs):
    cj, ct = jconfigs.get(arch).make_smoke(), tconfigs.get(arch).make_smoke()
    if cj.moe is not None:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(
            cj.moe, ep_axes=("model", "data"), capacity_factor=1.0))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(
            ct.moe, ep_axes=("model", "data"), capacity_factor=1.0))
    return (dataclasses.replace(cj, **dict(knobs)),
            dataclasses.replace(ct, **dict(knobs)))


@functools.lru_cache(maxsize=None)
def _lm_weights(arch):
    cj, _ = _cfgs(arch, ())
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return pj, jax.tree_util.tree_map(np.asarray, pj)


def _lm_batch(cfg):
    rng = np.random.default_rng(1)
    return {k: rng.integers(1, cfg.vocab, (B, L)).astype(np.int32)
            for k in ("tokens", "labels")}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _lm_reference(arch, knobs, microbatches):
    """The reference's train step under a 1 x 1 mesh, ``STEPS`` times,
    with ``J_OPT``: (metrics a step, new params, mu, nu by path)."""
    cj, _ = _cfgs(arch, knobs)
    pj, _ = _lm_weights(arch)
    batch = {k: jnp.asarray(v) for k, v in _lm_batch(cj).items()}
    with ONE_BY_ONE, mock.patch.object(JC, "OPT", J_OPT):
        cell = JC._lm_train_cell(arch, {"batch": B, "seq_len": L},
                                 ONE_BY_ONE, cj, microbatches=microbatches)
        step = jax.jit(cell.step)
        p, o, mets = pj, JOPT.init_opt_state(pj), []
        for _ in range(STEPS):
            p, o, m = step(p, o, batch)
            mets.append({k: float(v) for k, v in m.items()})
    return mets, _by_path(p), _by_path(o["mu"]), _by_path(o["nu"])


@pytest.mark.parametrize("case", LM_CASES, ids=_lm_ids)
def test_lm_train_cell_on_devices(case, monkeypatch):
    monkeypatch.setattr(TC, "OPT", T_OPT)
    arch, shape, per, knobs, microbatches = case
    cj, ct = _cfgs(arch, knobs)
    over = dict(knobs, microbatches=microbatches)
    if ct.moe is not None:
        over.update(moe_ep=True, moe=ct.moe)
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cj).items()}

    def build(mesh):
        pt = TTF.params_from_reference(ct, _lm_weights(arch)[1], "cpu")
        return TC.build_cell(arch, "train_4k", mesh, dict(over), batch=B,
                             seq_len=L, smoke=True, params=pt, inputs=batch)

    name = _lm_ids(case).replace(f"-{shape[0]}x{shape[1]}-{per}pos", "")
    cell, runs = _check_devices(build, name, shape, per, monkeypatch)
    want, wp, wmu, wnu = _lm_reference(arch, knobs, microbatches)
    for (got, _, _), ref in zip(runs, want, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
    params, state = cell.args[0], cell.args[1]
    assert int(state["step"]) == STEPS
    old = _by_path(_lm_weights(arch)[0])
    for path in wp:
        new = params.gather(path)
        _close(new, wp[path], path)
        if not np.array_equal(old[path], wp[path]):
            assert not np.array_equal(new.detach().numpy(), old[path]), path
        _close(state["mu"].gather(path), wmu[path], "mu " + path)
        _close(state["nu"].gather(path), wnu[path], "nu " + path)


# --------------------------------------------------------------------------
# GNN, halo, recsys
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_step(loss_fn):
    """The reference cells' step: value_and_grad, then AdamW."""
    def step(params, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        p, o, m = JOPT.adamw_update(J_OPT, params, grads,
                                    JOPT.init_opt_state(params))
        m["loss"] = loss
        return p, o, m
    return jax.jit(step)


GNN_SIZES = {"n_nodes": 96, "n_edges": 400, "d_feat": 16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _gatedgcn_reference():
    """(reference weights, the cell's seeded batch, the reference's step
    on it): the batch does not depend on the mesh."""
    probe = TC.build_cell("gatedgcn", "full_graph_sm", _mesh((1, 1)),
                          smoke=True, sizes=GNN_SIZES)
    cj = type(jconfigs.get("gatedgcn").make_smoke())(
        **dataclasses.asdict(probe.cfg))
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), cj)
    batch = probe.args[2]
    b = {p[2:-2]: batch.gather(p).numpy() for p in batch.shapes}
    shp = dict(jconfigs.common.shapes_for("gnn")["full_graph_sm"],
               **GNN_SIZES)
    loss_fn = JC._gnn_loss_fn(jconfigs.get("gatedgcn"), shp, cj,
                              batch.shapes["['feats']"][0])
    return pj, _jit_step(loss_fn)(pj, {k: jnp.asarray(v)
                                       for k, v in b.items()})


def _first_step_equals(build, ref, mesh):
    """One step of ``build(mesh)`` against the reference's (params,
    opt_state, metrics), as ``tests/test_torch_cells_gnn_recsys.py``
    holds a cell."""
    cell = build(mesh)
    _, state, m = cell.run()
    _assert_copies_equal(cell.args[0], state, True)
    wp, wo, wm = ref
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(wm["grad_norm"]), rtol=GNORM_RTOL)
    for tree, want in ((cell.args[0], wp), (state["mu"], wo["mu"]),
                       (state["nu"], wo["nu"])):
        for path, w in _by_path(want).items():
            _close(tree.gather(path), w, path)


def test_gatedgcn_train_cell_on_devices(monkeypatch):
    monkeypatch.setattr(TC, "OPT", T_OPT)
    pj, ref = _gatedgcn_reference()

    def build(mesh):
        return TC.build_cell("gatedgcn", "full_graph_sm", mesh, smoke=True,
                             sizes=GNN_SIZES,
                             params=TG.params_from_reference("gatedgcn",
                                                             _np(pj)))

    _check_devices(build, "gatedgcn", (2, 2), 1, monkeypatch)
    _first_step_equals(build, ref, _mesh((2, 2), 1))


def test_halo_train_cell_on_devices(monkeypatch):
    """The halo cell against the replicated loss on the partition's
    relabeled graph (the reference's) and its gradient norm."""
    monkeypatch.setattr(TC, "OPT", T_OPT)
    n, E = 96, 400
    rng = np.random.default_rng(6)
    arrays = {"src": rng.integers(0, n, E), "dst": rng.integers(0, n, E),
              "feats": rng.standard_normal((n, 16)).astype(np.float32),
              "labels": rng.integers(0, 7, n).astype(np.int32),
              "train_mask": (rng.random(n) < 0.5).astype(np.float32)}
    probe = TC.build_cell("gatedgcn", "full_graph_sm", _mesh((2, 2)),
                          {"halo": True}, smoke=True, sizes=GNN_SIZES,
                          inputs=arrays)
    cj = type(jconfigs.get("gatedgcn").make_smoke())(
        **dataclasses.asdict(probe.cfg))
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), cj)

    def build(mesh):
        return TC.build_cell(
            "gatedgcn", "full_graph_sm", mesh, {"halo": True}, smoke=True,
            sizes=GNN_SIZES, inputs=arrays,
            params=TG.params_from_reference("gatedgcn", _np(pj)))

    _, runs = _check_devices(build, "halo", (2, 2), 1, monkeypatch)
    part, _, _, rep = TC.halo_batch(*(arrays[k] for k in (
        "src", "dst", "feats", "labels", "train_mask")), n, 4)
    src, dst, feats, labels, mask = rep
    lj = float(JG.node_classification_loss(jax.jit(
        JG.gatedgcn_apply, static_argnums=(1, 5))(
        pj, cj, feats, src, dst, part.n_pad), labels, mask))
    pt = TG.params_from_reference("gatedgcn", _np(pj))
    lr = TG.node_classification_loss(TG.gatedgcn_apply(
        pt, probe.cfg, *(torch.from_numpy(x) for x in (feats, src, dst)),
        part.n_pad), torch.from_numpy(labels), torch.from_numpy(mask))
    grads = torch.autograd.grad(lr, list(pt.parameters()),
                                allow_unused=True, materialize_grads=True)
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    m = runs[0][0]
    assert abs(m["loss"] - lj) <= HALO_REL * abs(lj)
    np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=GNORM_RTOL)


@functools.lru_cache(maxsize=None)
def _recsys_reference(B_rows):
    cj = jconfigs.get("dcn-v2").make_smoke()
    pj = JRS.dcnv2_init(jax.random.PRNGKey(0), cj)
    rng = np.random.default_rng(3)
    sparse = np.stack([rng.integers(0, v, (B_rows, cj.max_hots))
                       for v in cj.vocabs], 1).astype(np.int32)
    sparse[rng.random(sparse.shape) < 0.3] = -1
    b = {"dense": rng.standard_normal((B_rows, cj.n_dense)).astype(
        np.float32), "sparse": sparse,
        "labels": rng.integers(0, 2, B_rows).astype(np.int32)}
    return pj, b, _jit_step(lambda p, bt: JRS.ctr_loss(p, cj, bt))(
        pj, {k: jnp.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("shape,per", [((2, 2), 1), ((2, 4), 2)],
                         ids=["2x2", "2x4-shared"])
def test_recsys_train_cell_on_devices(shape, per, monkeypatch):
    monkeypatch.setattr(TC, "OPT", T_OPT)
    pj, b, ref = _recsys_reference(64)

    def build(mesh):
        return TC.build_cell("dcn-v2", "train_batch", mesh, smoke=True,
                             batch=64, params=TRS.params_from_reference(
                                 _np(pj)),
                             inputs={k: torch.from_numpy(v)
                                     for k, v in b.items()})

    _check_devices(build, "dcn-v2", shape, per, monkeypatch)
    _first_step_equals(build, ref, _mesh(shape, per))


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def test_replica_sets_key_on_the_mesh_devices():
    """On a mesh of ``cpu:i`` positions every tensor reports ``cpu``: the
    sets follow ``mesh.devices``.  (2, 4) with two positions a device: the
    norm's copies at (0, 2, 4, 6), a leaf split over ``model`` only at the
    ``data`` groups; a one-device mesh has sets of one."""
    ct = tconfigs.get("qwen3-1.7b").make_smoke()
    params = TTF.init_params(torch.Generator().manual_seed(0), ct, "cpu")
    placed = TSH.place(params, _mesh((2, 4), 2), TSH.lm_param_spec)
    sets = TSH.replica_sets(placed)
    blocks = TSH.distinct(placed)
    assert sorted(i for _, c in sets for _, i in c) == list(range(
        len(blocks)))
    by_path = {}
    for path, copies in sets:
        assert all(blocks[i][0] == path for _, i in copies)
        by_path.setdefault(path, []).append(tuple(p for p, _ in copies))
    assert by_path["['final_norm']['scale']"] == [(0, 2, 4, 6)]
    one = TSH.place(params, _mesh((2, 4)), TSH.lm_param_spec)
    assert [len(c) for _, c in TSH.replica_sets(one)] == [1] * len(
        TSH.distinct(one))


def test_all_reduce_replicas_sums_in_position_order():
    """Each set's sum of its copies, added in position order, on its first
    copy's device; leaves of one pattern and dtype travel in one
    collective, every copy's bytes counted."""
    mesh = _mesh((2, 2), 1)
    gen = torch.Generator().manual_seed(0)

    def leaf(shape, groups, dtype=torch.float32):
        return [[(p, torch.randn(shape, generator=gen).to(dtype))
                 for p in g] for g in groups]

    leaves = [leaf((3, 2), [(0, 1, 2, 3)]), leaf((5,), [(0, 1, 2, 3)]),
              leaf((4,), [(0, 1), (2, 3)]),
              leaf((2, 2), [(0, 1, 2, 3)], torch.float64),
              leaf((6,), [(0,), (1,), (2,), (3,)])]
    metrics.reset()
    out = TM.all_reduce_replicas(mesh, leaves)
    assert TM.collectives() == 3            # float32 x 2 patterns, float64
    for sets, got in zip(leaves, out, strict=True):
        for s, g in zip(sets, got, strict=True):
            want = s[0][1].clone()
            for _, t in s[1:]:
                want = want + t
            assert g.shape == want.shape and g.dtype == want.dtype
            assert torch.equal(g, want)
            if len(s) == 1:
                assert g is s[0][1]
    assert TM.gathered_bytes() == 4 * (4 * 6 + 4 * 5 + 4 * 4) + 8 * 4 * 4


def test_backward_runs_on_the_calling_thread_across_devices(monkeypatch):
    """On a mesh of several devices a train step's backward runs on the
    calling thread: one autograd thread a device would recompute a remat
    region that spans the devices from two threads at once (a CPU runs
    every backward on the calling thread, so only a card shows the
    fault); on one device the engine keeps its threads."""
    seen = []
    grad = torch.autograd.grad

    def spy(*a, **kw):
        seen.append(torch._C._is_multithreading_enabled())
        return grad(*a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    x = torch.ones(2, requires_grad=True)
    for mesh in (_mesh((1, 2), 1), _mesh((1, 2))):
        (g,) = TC._grad(mesh, (x * 3).sum(), [x])
        assert torch.equal(g, torch.full((2,), 3.0))
    assert seen == [False, True]
