"""Port vs reference: the cell builders and the mesh makers
(``repro_torch.launch.cells`` / ``.mesh`` against ``repro.launch``).

``build_cell`` allocates: its ``Cell.args`` are placed tensors and
``Cell.run()`` runs the step the reference's ``Cell`` lowers.  The LM's
prefill and decode cells run here on the smoke configs (float32, CPU
meshes) with the reference's weights, against the reference's ``prefill``
/ ``decode_step`` under a 1 x 1 mesh, within ``TOL`` (1e-4, float32 in
another order); a train cell runs a step with each mesh knob
(``tests/test_torch_train_mesh.py`` holds it to the reference); a train
cell over several devices raises, naming its ROADMAP item (B.19); every
cell of the reference's 40-cell grid runs on a (2, 2) mesh.  MLA,
GNN and recsys cells: ``tests/test_torch_mla_mesh.py`` and
``tests/test_torch_cells_gnn_recsys.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import mesh as JM
from repro.models import transformer as JTF
from repro_torch import configs as tconfigs
from repro_torch.core import mesh as TM
from repro_torch.launch import cells as TC
from repro_torch.launch import mesh as TLM
from repro_torch.launch import sharding as TSH
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ONE_BY_ONE = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)


def _mesh(shape):
    return TM.make_mesh(shape, ("data", "model"), device="cpu")


def _weights(arch, **over):
    cj = dataclasses.replace(jconfigs.get(arch).make_smoke(), **over)
    ct = dataclasses.replace(tconfigs.get(arch).make_smoke(), **over)
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return cj, pj, TTF.params_from_reference(
        ct, jax.tree_util.tree_map(np.asarray, pj), "cpu")


def test_mesh_makers_and_axes():
    m = TLM.make_production_mesh(device="cpu")
    assert (m.axis_names, m.axis_sizes) == (("data", "model"), (16, 16))
    m2 = TLM.make_production_mesh(multi_pod=True, device="cpu")
    assert (m2.axis_names, m2.axis_sizes) == (("pod", "data", "model"),
                                              (2, 16, 16))
    for mesh in (m, m2, _mesh((2, 2))):
        stand_in = types.SimpleNamespace(axis_names=mesh.axis_names,
                                         devices=np.empty(mesh.size))
        assert TLM.batch_axes(mesh) == JM.batch_axes(stand_in)
        assert TLM.n_chips(mesh) == JM.n_chips(stand_in) == mesh.size
    with pytest.raises(TypeError):
        TLM.make_production_mesh()                  # device= is required
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            TLM.make_host_mesh(1, 4)


@pytest.mark.parametrize("arch,shape,mesh_shape", [
    ("qwen3-1.7b", "prefill_32k", (1, 4)),
    ("qwen3-32b", "prefill_32k", (2, 2)),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", (2, 2)),
    ("qwen2-moe-a2.7b", "prefill_32k", (1, 2))])
def test_prefill_cell_equals_the_reference(arch, shape, mesh_shape):
    over = {"n_layers": 1}
    cj, pj, pt = _weights(arch, **over)
    if cj.moe is not None:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(
            cj.moe, ep_axes=("model", "data")))
        over["moe_ep"] = True
    mesh = _mesh(mesh_shape)
    cell = TC.build_cell(arch, shape, mesh, over, batch=2, seq_len=9,
                         smoke=True, params=pt)
    assert cell.kind == "prefill" and cell.cfg.n_layers == 1
    assert "batch cut from 32 to 2" in cell.static_notes
    assert "seq_len cut from 32768 to 9" in cell.static_notes
    assert "n_layers cut from 2 to 1" in cell.static_notes
    assert (cell.cfg.moe is not None) == ("moe_ep" in over)
    if cell.cfg.moe is not None:
        assert cell.cfg.moe.ep_axes == ("model", "data")
    tokens = cell.args[1]
    assert isinstance(cell.args[0], TSH.Placed)
    assert tokens.shapes[""] == (2, 9)
    toks = np.asarray(tokens.gather(""))
    metrics.reset()
    logits, cache = cell.run()
    assert TM.collectives() > 0
    with ONE_BY_ONE:
        lj, cjc = jax.jit(lambda p, t: JTF.prefill(p, cj, t))(
            pj, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(cache.gather("['k']").numpy(),
                               np.asarray(cjc["k"]), **TOL)


@pytest.mark.parametrize("arch,shape,mesh_shape,batch", [
    ("qwen3-1.7b", "long_500k", (1, 4), None),      # B 1: seq over all
    ("qwen3-32b", "long_500k", (2, 2), None),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", (2, 2), 4),
    ("qwen3-1.7b", "decode_32k", (2, 1), 2)])
def test_decode_cell_equals_the_reference(arch, shape, mesh_shape, batch):
    over = {"n_layers": 1, "decode_write_then_attend": True,
            "decode_seq_axis": "model"}
    cj, pj, pt = _weights(arch, **over)
    if cj.moe is not None:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(
            cj.moe, ep_axes=("model", "data")))
        over["moe_ep"] = True
    B = batch or 1
    S = 64
    rng = np.random.default_rng(5)
    cache = {k: rng.standard_normal((1, B, cj.n_kv_heads, S, cj.head_dim))
             .astype(np.float32) for k in ("k", "v")}
    length = rng.integers(0, S, (B,)).astype(np.int32)
    token = rng.integers(1, cj.vocab, (B,)).astype(np.int32)
    mesh = _mesh(mesh_shape)
    cell = TC.build_cell(
        arch, shape, mesh, over, batch=batch, seq_len=S, smoke=True,
        params=pt, inputs={"cache": {k: torch.from_numpy(v.copy())
                                     for k, v in cache.items()},
                           "length": torch.from_numpy(length),
                           "token": torch.from_numpy(token)})
    assert cell.kind == "decode" and "seq_len cut" in cell.static_notes
    pc = cell.args[2]
    want = TSH.lm_cache_spec(mesh, "gqa", B, cj.n_kv_heads)["k"]
    assert tuple(pc.specs["['k']"]) == tuple(TSH.sanitize_spec(
        want, (1, B, cj.n_kv_heads, S, cj.head_dim), mesh))
    if B < mesh_shape[0]:
        assert pc.split("['k']", 3) == ("data", "model")
    logits, pc = cell.run()
    with ONE_BY_ONE:
        lj, cjc = jax.jit(lambda p, t, c, n: JTF.decode_step(
            p, cj, t, c, n))(pj, jnp.asarray(token),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             jnp.asarray(length))
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pc.gather(f"['{k}']").numpy(),
                                   np.asarray(cjc[k]), **TOL)


def test_default_cell_inputs_run():
    """Without ``params`` / ``inputs`` the cell draws its own (seeded
    weights, tokens; a zero cache at length 0), and runs."""
    mesh = _mesh((1, 2))
    cell = TC.build_cell("qwen3-1.7b", "decode_32k", mesh, {"n_layers": 1},
                         batch=2, seq_len=16, smoke=True)
    logits, cache = cell.run()
    assert logits.shape == (2, 512) and torch.isfinite(logits).all()
    assert cache.shapes["['k']"] == (1, 2, 2, 16, 16)
    cell = TC.build_cell("qwen3-1.7b", "prefill_32k", mesh,
                         batch=1, seq_len=8, smoke=True)
    assert cell.static_notes == ("batch cut from 32 to 1; seq_len cut from "
                                 "32768 to 8")
    assert cell.run()[0].shape == (1, 512)


@pytest.mark.parametrize("knob", ["plain", "act_shard", "fsdp_inner"])
def test_train_cell_runs_with_each_knob(knob):
    """A train cell with its default weights and batch (seeded) on a (1, 2)
    mesh: one step, its cuts in ``static_notes``, the launcher's mesh
    fields in its config (``tests/test_torch_train_mesh.py`` holds the
    step to the reference's)."""
    over = {"n_layers": 1}
    if knob != "plain":
        over[knob] = True
    cell = TC.build_cell("qwen3-1.7b", "train_4k", _mesh((1, 2)), over,
                         smoke=True, batch=2, seq_len=8)
    assert cell.kind == "train"
    assert cell.static_notes == ("batch cut from 256 to 2; seq_len cut from "
                                 "4096 to 8; n_layers cut from 2 to 1")
    assert cell.cfg.model_axis_size == (2 if knob == "fsdp_inner" else 0)
    assert cell.cfg.act_batch_axes == (("data",) if knob == "act_shard"
                                       else ())
    params, opt, m = cell.run()
    assert sorted(m) == ["grad_norm", "loss", "lr"]
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(opt["step"]) == 1 and cell.args[1] is opt
    assert isinstance(params, TSH.Placed) and params.shapes[
        "['embed']['table']"] == (512, 64)


def test_train_cell_refusals():
    """No train cell refuses a mesh whose positions sit on different
    devices (it did until the gradient all-reduce, ROADMAP B.19): each
    family builds on a (1, 2) mesh of ``cpu:0`` / ``cpu:1`` and takes a
    finite step, its replicated blocks' copies bit-equal after it
    (``tests/test_torch_train_devices.py`` holds the steps to the
    reference's)."""
    two = TM.make_mesh((1, 2), ("data", "model"), devices=["cpu:0", "cpu:1"])
    for arch, shape, cut in (
            ("qwen3-1.7b", "train_4k", {"batch": 2, "seq_len": 8}),
            ("gatedgcn", "full_graph_sm", {"n_nodes": 8, "n_edges": 8}),
            ("dcn-v2", "train_batch", {"batch": 2})):
        cell = TC.build_cell(arch, shape, two, smoke=True, sizes=cut)
        params, opt, m = cell.run()
        assert int(opt["step"]) == 1
        assert all(bool(torch.isfinite(m[k])) for k in ("loss",
                                                        "grad_norm"))
        copies = [c for _, c in TSH.replica_sets(params) if len(c) > 1]
        assert copies, arch
        blocks = [b for _, b in TSH.distinct(params)]
        for c in copies:
            assert all(torch.equal(blocks[i], blocks[c[0][1]])
                       for _, i in c), arch


# --------------------------------------------------------------------------
# every cell of the reference's grid
# --------------------------------------------------------------------------

GRID_CUTS = {
    "lm": {"batch": 2, "seq_len": 16},
    "full_graph_sm": {"n_nodes": 48, "n_edges": 128, "d_feat": 8},
    "ogb_products": {"n_nodes": 48, "n_edges": 128, "d_feat": 8},
    "minibatch_lg": {"batch_nodes": 4, "fanouts": (3, 2), "d_feat": 8},
    "molecule": {"batch": 4, "d_feat": 8},
    "train_batch": {"batch": 64}, "serve_p99": {"batch": 48},
    "serve_bulk": {"batch": 16}, "retrieval_cand": {"n_candidates": 512}}
GRID = [(a, s) for a in jconfigs.ARCHS
        for s in jconfigs.common.shapes_for(jconfigs.get(a).family)]
# the shapes' cuts to smoke size, by family (LM) or shape


def test_the_grid_is_the_references():
    assert len(GRID) == 40
    assert [(a, s) for a in tconfigs.ARCHS for s in
            tconfigs.common.shapes_for(tconfigs.get(a).family)] == GRID


@pytest.mark.parametrize("arch,shape", GRID, ids=[f"{a}-{s}"
                                                  for a, s in GRID])
def test_every_cell_of_the_grid_runs(arch, shape):
    """Every (arch, shape) cell of the reference's 40 builds and runs one
    step on a (2, 2) mesh at smoke width, its shape cut, with finite
    outputs of the step's kind."""
    family = tconfigs.get(arch).family
    cut = GRID_CUTS["lm" if family == "lm" else shape]
    cell = TC.build_cell(arch, shape, _mesh((2, 2)), smoke=True, sizes=cut)
    assert cell.kind == jconfigs.common.shapes_for(family)[shape]["kind"]
    out = cell.run()
    if cell.kind == "train":
        assert int(out[1]["step"]) == 1
        vals = [out[2]["loss"], out[2]["grad_norm"]]
    elif cell.kind in ("prefill", "decode"):
        vals = [out[0]]
        assert out[0].shape == (2, cell.cfg.vocab)
    elif cell.kind == "serve":
        vals = [out]
        assert out.shape == (cut["batch"],)
    else:
        vals = list(out)
        assert out[2].shape == (100,)
    assert all(bool(torch.isfinite(v).all()) for v in vals)
