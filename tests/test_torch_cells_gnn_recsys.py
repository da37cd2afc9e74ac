"""Port vs reference: the GNN and recsys cells on the model mesh
(``repro_torch.launch.cells.build_cell`` against ``repro.launch.cells``'s
step functions), on CPU meshes at smoke widths, float32.

* Recsys (``dcn-v2``'s smoke config, tables row-sharded over ``model``):
  one ``train_batch`` step against the reference's ``RS.ctr_loss`` +
  ``adamw_update``; ``serve_p99``'s probabilities against ``RS.predict``;
  ``retrieval_cand`` against ``RS.retrieval_scores``, with every
  candidate row repeated about 8 times so that the top 100 are full of
  ties: the ids equal the reference's, ties in index order.
* GNN (edges over the mesh, nodes replicated): one step of each of the
  four models (``nequip`` on its ``molecule`` shape, the others on
  ``full_graph_sm``, cut) against the reference's ``_gnn_loss_fn`` and
  ``adamw_update`` on the cell's own seeded batch.  The halo GatedGCN (a
  real ``build_halo`` plan) against the replicated loss, the port's and
  the reference's, as ``tests/test_torch_gnn.py`` holds the halo model.

The reference's weights (``init(PRNGKey(0))``) are carried across by the
port's ``params_from_reference``; its functions are ``jax.jit``'d.  The
optimizer is the cells' ``OPT`` with a one-step warmup in both packages,
so that one step moves the weights past their tolerance.  Tolerances:
loss rtol 1e-5, grad_norm rtol 1e-4, every new parameter and moment leaf
rtol 1e-4 and atol 1e-4 of the leaf's largest magnitude (float32 in
another order: the psum-ed lookups and scatters, the gathered columns;
measured about 1e-6); predictions and scores 1e-5; the halo loss 1e-5
relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import cells as JC
from repro.models import equivariant as JEQ
from repro.models import gnn as JG
from repro.models import recsys as JRS
from repro.training import optimizer as JOPT
from repro_torch import configs as tconfigs
from repro_torch.core import mesh as TM
from repro_torch.launch import cells as TC
from repro_torch.launch import sharding as TSH
from repro_torch.models import equivariant as TEQ
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TRS
from repro_torch.obs import metrics

torch.set_num_threads(1)

LOSS_RTOL, GNORM_RTOL, LEAF_TOL, OUT_TOL, HALO_REL = 1e-5, 1e-4, 1e-4, \
    1e-5, 1e-5
J_OPT = dataclasses.replace(JC.OPT, warmup_steps=1)
T_OPT = dataclasses.replace(TC.OPT, warmup_steps=1)
MESHES = ((2, 2), (1, 4))


def _ids(shape):
    return "x".join(map(str, shape))


def _mesh(shape):
    return TM.make_mesh(shape, ("data", "model"), device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


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


def _check_step(cell, ref):
    """One cell step against the reference's (params, opt_state,
    metrics)."""
    _, state, m = cell.run()
    wp, wo, wm = ref
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(wm["grad_norm"]), rtol=GNORM_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(wm["lr"]), rtol=1e-6)
    for tree, want in ((cell.args[0], wp), (state["mu"], wo["mu"]),
                       (state["nu"], wo["nu"])):
        for path, w in _by_path(want).items():
            np.testing.assert_allclose(
                tree.gather(path).detach().numpy(), w, rtol=LEAF_TOL,
                atol=LEAF_TOL * max(float(np.abs(w).max()), 1e-30),
                err_msg=path)


# --------------------------------------------------------------------------
# recsys
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _recsys_weights():
    cj = jconfigs.get("dcn-v2").make_smoke()
    pj = JRS.dcnv2_init(jax.random.PRNGKey(0), cj)
    return cj, pj


def _recsys_batch(cfg, B):
    rng = np.random.default_rng(3)
    sparse = np.stack([rng.integers(0, v, (B, cfg.max_hots))
                       for v in cfg.vocabs], 1).astype(np.int32)
    sparse[rng.random(sparse.shape) < 0.3] = -1
    sparse[0, 0, 0] = cfg.vocabs[0] + 5          # clipped into the table
    return {"dense": rng.standard_normal((B, cfg.n_dense)).astype(
        np.float32), "sparse": sparse,
        "labels": rng.integers(0, 2, B).astype(np.int32)}


def _recsys_cell(shape, mesh_shape, monkeypatch, **kw):
    monkeypatch.setattr(TC, "OPT", T_OPT)
    cj, pj = _recsys_weights()
    return TC.build_cell("dcn-v2", shape, _mesh(mesh_shape), smoke=True,
                         params=TRS.params_from_reference(_np(pj)), **kw)


@functools.lru_cache(maxsize=None)
def _recsys_train_reference(B=64):
    cj, pj = _recsys_weights()
    b = _recsys_batch(cj, B)
    return b, _jit_step(lambda p, bt: JRS.ctr_loss(p, cj, bt))(
        pj, {k: jnp.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
def test_recsys_train_cell_equals_the_reference(mesh_shape, monkeypatch):
    b, ref = _recsys_train_reference()
    cell = _recsys_cell("train_batch", mesh_shape, monkeypatch, batch=64,
                        inputs={k: torch.from_numpy(v) for k, v in
                                b.items()})
    placed = cell.args[0]
    assert placed.split("['tables'][0]", 0) == ("model",)
    assert placed.split("['mlp_w'][0]", 1) == ("model",)
    assert cell.args[2].split("['dense']", 0) == ("data",)
    assert cell.static_notes == "batch cut from 65536 to 64"
    metrics.reset()
    _check_step(cell, ref)
    assert TM.collectives() > 0


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
def test_recsys_train_cell_below_32_rows(mesh_shape, monkeypatch):
    """C.5: below 32 rows the cell places ``dense`` / ``sparse`` whole and
    still splits ``labels`` over the data axes, as the reference places
    them; each position scores the logits of its label rows, and the step
    is the reference's mean BCE at B 8 (on (2, 2) it raised)."""
    b, ref = _recsys_train_reference(8)
    cell = _recsys_cell("train_batch", mesh_shape, monkeypatch, batch=8,
                        inputs={k: torch.from_numpy(v) for k, v in
                                b.items()})
    batch = cell.args[2]
    assert batch.split("['dense']", 0) == ()
    assert batch.split("['labels']", 0) == ("data",)
    _check_step(cell, ref)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
def test_recsys_serve_cell_equals_the_reference(mesh_shape, monkeypatch):
    cj, pj = _recsys_weights()
    b = _recsys_batch(cj, 48)
    cell = _recsys_cell("serve_p99", mesh_shape, monkeypatch, batch=48,
                        inputs={k: torch.from_numpy(b[k])
                                for k in ("dense", "sparse")})
    got = cell.run()
    want = jax.jit(lambda p, bt: JRS.predict(p, cj, bt))(
        pj, {k: jnp.asarray(b[k]) for k in ("dense", "sparse")})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
def test_recsys_retrieval_cell_equals_the_reference(mesh_shape,
                                                    monkeypatch):
    cj, pj = _recsys_weights()
    rng = np.random.default_rng(4)
    base = rng.standard_normal((256, cj.mlp_dims[-1])).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    cand = base[rng.integers(0, 256, 2048)]      # every row about 8 times
    b = _recsys_batch(cj, 1)
    cell = _recsys_cell(
        "retrieval_cand", mesh_shape, monkeypatch,
        sizes={"n_candidates": 2048},
        inputs={"dense": torch.from_numpy(b["dense"]),
                "sparse": torch.from_numpy(b["sparse"]),
                "cand": torch.from_numpy(cand)})
    assert cell.args[3].split("", 0) == ("data", "model")
    scores, top_v, top_i = cell.run()
    ws, wv, wi = jax.jit(lambda p, d, s, c: JRS.retrieval_scores(
        p, cj, d, s, c, top_k=100))(pj, b["dense"], b["sparse"], cand)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ws), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(top_v.numpy(), np.asarray(wv), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert len(set(np.asarray(wv).tolist())) < 100          # ties
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(wi))


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------

GNN_CASES = (("gat-cora", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
             ("gatedgcn", "full_graph_sm"), ("nequip", "molecule"))
GNN_SIZES = {"full_graph_sm": {"n_nodes": 96, "n_edges": 400, "d_feat": 16},
             "molecule": {"batch": 6}}
J_INIT = {"gat": JG.gat_init, "mgn": JG.mgn_init,
          "gatedgcn": JG.gatedgcn_init, "nequip": JEQ.nequip_init}


def _gnn_port_params(model, tree):
    if model == "nequip":
        return TEQ.params_from_reference(tree)
    return TG.params_from_reference(model, tree)


def _gnn_reference(arch, cfg):
    """(reference config, weights) of the port cell's config."""
    cj = type(jconfigs.get(arch).make_smoke())(**dataclasses.asdict(cfg))
    model = tconfigs.get(arch).extras["model"]
    return cj, J_INIT[model](jax.random.PRNGKey(0), cj)


@functools.lru_cache(maxsize=None)
def _gnn_case(arch, shape):
    """(the reference's weights, the cell's seeded batch, the reference's
    step on it): the batch does not depend on the mesh."""
    probe = TC.build_cell(arch, shape, _mesh((1, 1)), smoke=True,
                          sizes=GNN_SIZES[shape])
    cj, pj = _gnn_reference(arch, probe.cfg)
    batch = probe.args[2]
    b = {p[2:-2]: batch.gather(p).numpy() for p in batch.shapes}
    shp = dict(jconfigs.common.shapes_for("gnn")[shape],
               **GNN_SIZES[shape])
    loss_fn = JC._gnn_loss_fn(jconfigs.get(arch), shp, cj,
                              batch.shapes["['feats']"][0])
    return pj, b, _jit_step(loss_fn)(pj, {k: jnp.asarray(v)
                                          for k, v in b.items()})


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
@pytest.mark.parametrize("arch,shape", GNN_CASES)
def test_gnn_train_cell_equals_the_reference(arch, shape, mesh_shape,
                                             monkeypatch):
    monkeypatch.setattr(TC, "OPT", T_OPT)
    model = tconfigs.get(arch).extras["model"]
    pj, b, ref = _gnn_case(arch, shape)
    cell = TC.build_cell(arch, shape, _mesh(mesh_shape), smoke=True,
                         sizes=GNN_SIZES[shape],
                         params=_gnn_port_params(model, _np(pj)))
    batch = cell.args[2]
    assert batch.split("['src']", 0) == ("data", "model")
    assert batch.shapes["['src']"][0] % TC.EDGE_PAD == 0
    for k, v in b.items():          # the same seeded batch on every mesh
        np.testing.assert_array_equal(batch.gather(f"['{k}']").numpy(), v)
    metrics.reset()
    _check_step(cell, ref)
    assert TM.collectives() > 0


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_ids)
def test_halo_cell_equals_the_replicated_loss(mesh_shape, monkeypatch):
    """The halo cell's loss against the replicated GatedGCN's on the
    partition's relabeled graph, the port's and the reference's; its
    gradient norm against the replicated loss's (``halo_batch`` gives the
    replicated form of the cell's graph)."""
    monkeypatch.setattr(TC, "OPT", T_OPT)
    n, E = 96, 400
    rng = np.random.default_rng(6)
    arrays = {"src": rng.integers(0, n, E), "dst": rng.integers(0, n, E),
              "feats": rng.standard_normal((n, 16)).astype(np.float32),
              "labels": rng.integers(0, 7, n).astype(np.int32),
              "train_mask": (rng.random(n) < 0.5).astype(np.float32)}
    mesh = _mesh(mesh_shape)
    sizes = {"n_nodes": n, "n_edges": E, "d_feat": 16}
    probe = TC.build_cell("gatedgcn", "full_graph_sm", mesh, {"halo": True},
                          smoke=True, sizes=sizes, inputs=arrays)
    cj, pj = _gnn_reference("gatedgcn", probe.cfg)
    pt = TG.params_from_reference("gatedgcn", _np(pj))
    cell = TC.build_cell("gatedgcn", "full_graph_sm", mesh, {"halo": True},
                         smoke=True, sizes=sizes, params=pt, inputs=arrays)
    assert "build_halo" in cell.static_notes
    assert "boundary_frac 0.1" in cell.static_notes
    part, _, _, rep = TC.halo_batch(*(arrays[k] for k in (
        "src", "dst", "feats", "labels", "train_mask")), n, mesh.size)
    src, dst, feats, labels, mask = rep
    lj = float(JG.node_classification_loss(jax.jit(
        JG.gatedgcn_apply, static_argnums=(1, 5))(
        pj, cj, feats, src, dst, part.n_pad), labels, mask))
    pt_rep = TG.params_from_reference("gatedgcn", _np(pj))
    lr = TG.node_classification_loss(TG.gatedgcn_apply(
        pt_rep, probe.cfg, *(torch.from_numpy(x) for x in (feats, src,
                                                           dst)),
        part.n_pad), torch.from_numpy(labels), torch.from_numpy(mask))
    grads = torch.autograd.grad(lr, list(pt_rep.parameters()),
                                allow_unused=True, materialize_grads=True)
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    metrics.reset()
    _, _, m = cell.run()
    assert TM.collectives() == probe.cfg.n_layers + 1
    for want in (lj, float(lr.detach())):
        assert abs(float(m["loss"]) - want) <= HALO_REL * abs(want)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm,
                               rtol=GNORM_RTOL)


def test_halo_cell_refuses_other_archs():
    with pytest.raises(ValueError, match="gatedgcn full-graph"):
        TC.build_cell("gat-cora", "full_graph_sm", _mesh((1, 2)),
                      {"halo": True}, smoke=True)
    with pytest.raises(ValueError, match="gatedgcn full-graph"):
        TC.build_cell("gatedgcn", "molecule", _mesh((1, 2)), {"halo": True},
                      smoke=True)
