"""Port vs reference: the GNN models (``repro_torch.models.gnn`` against
``repro.models.gnn``).

The reference's weights (``<model>_init(PRNGKey(0))``) are carried into the
port by ``params_from_reference``; both packages then run the same numpy
batch (``FullGraphStream`` on ``mesh2d(12, 12)``) through the forward pass
and the node-classification loss's gradient.  The reference's functions are
``jax.jit``'d.

Tolerances (float32): forward outputs and losses rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6 — the same arithmetic in another order
(XLA's and PyTorch's products and scatters sum differently; the port's
GatedGCN also takes ``(h @ D)[src]`` where the reference takes
``h[src] @ D``), measured at about 1e-7 relative here.  The halo GatedGCN:
its loss within 1e-5 relative of the replicated one,
its gradients within atol 1e-6 of the port's replicated gradients.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as jschedule
from repro.data import pipeline as JDP
from repro.graphs import generators as jgen
from repro.models import gnn as JG
from repro_torch import tree as T
from repro_torch.core import mesh as tmesh
from repro_torch.core import partition as tpart
from repro_torch.core import schedule as tschedule
from repro_torch.graphs import csr as tcsr
from repro_torch.models import gnn as TG
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(HERE, "make_torch_golden.py"))
make_torch_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_torch_golden)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
HALO_REL = 1e-5

MODELS = {
    "gat": (JG.GATConfig(n_layers=2, d_hidden=4, n_heads=2, d_in=16,
                         n_classes=3), JG.gat_init, JG.gat_apply),
    "mgn": (JG.MGNConfig(n_layers=2, d_hidden=16, mlp_layers=2, d_in=8,
                         d_edge_in=4, d_out=3), JG.mgn_init, JG.mgn_apply),
    "gatedgcn": (JG.GatedGCNConfig(n_layers=2, d_hidden=8, d_in=16, d_out=3),
                 JG.gatedgcn_init, JG.gatedgcn_apply),
}
T_CFG = {"gat": TG.GATConfig, "mgn": TG.MGNConfig,
         "gatedgcn": TG.GatedGCNConfig}
T_APPLY = {"gat": TG.gat_apply, "mgn": TG.mgn_apply,
           "gatedgcn": TG.gatedgcn_apply}


def _batch(model):
    cfg = MODELS[model][0]
    n_classes = getattr(cfg, "n_classes", None) or cfg.d_out
    g = jgen.mesh2d(12, 12)
    b = next(JDP.FullGraphStream(g, d_feat=cfg.d_in, n_classes=n_classes,
                                 pad_edges_to=1024))
    E = b["src"].shape[0]
    b["edge_feats"] = np.random.default_rng(1).standard_normal(
        (E, 4)).astype(np.float32)
    return b, g.n_vertices + 1


def _call(apply, model, p, cfg, b, n):
    if model == "mgn":
        return apply(p, cfg, b["feats"], b["edge_feats"], b["src"], b["dst"],
                     n)
    return apply(p, cfg, b["feats"], b["src"], b["dst"], n)


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(model, n):
    cfg, _, apply = MODELS[model]

    def fwd_loss(p, b):
        out = _call(apply, model, p, cfg, b, n)
        return JG.node_classification_loss(out, b["labels"],
                                           b["train_mask"]), out

    return jax.jit(jax.value_and_grad(fwd_loss, has_aux=True))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_loss_and_gradients_equal_the_reference(model):
    cfg_j, init, _ = MODELS[model]
    b, n = _batch(model)
    pj = init(jax.random.PRNGKey(0), cfg_j)
    (lj, outj), gj = _j_value_and_grad(model, n)(
        pj, jax.tree.map(jnp.asarray, b))

    cfg_t = T_CFG[model](**vars(cfg_j))
    pt = TG.params_from_reference(model, jax.tree.map(np.asarray, pj), "cpu")
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    outt = _call(T_APPLY[model], model, pt, cfg_t, bt, n)
    lt = TG.node_classification_loss(outt, bt["labels"], bt["train_mask"])
    gt = torch.autograd.grad(lt, T.leaves(pt), allow_unused=True,
                             materialize_grads=True)

    np.testing.assert_allclose(outt.detach().numpy(), np.asarray(outj),
                               **FWD_TOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **FWD_TOL)
    jflat = jax.tree_util.tree_flatten_with_path(gj)[0]
    tflat = T.flatten_with_paths(pt)
    assert [k for k, _ in tflat] == [jax.tree_util.keystr(p)
                                     for p, _ in jflat]
    for (key, _), g_t, (_, g_j) in zip(tflat, gt, jflat):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   err_msg=key, **GRAD_TOL)


def test_params_from_reference_checks_the_tree():
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), MODELS["gatedgcn"][0])
    tree = jax.tree.map(np.asarray, pj)
    with pytest.raises(ValueError, match="expected"):
        TG.params_from_reference("gat", tree)
    with pytest.raises(ValueError, match="unknown GNN model"):
        TG.params_from_reference("nequip", tree)
    pt = TG.params_from_reference("gatedgcn", tree)
    assert all(p.requires_grad for p in T.leaves(pt))
    assert pt["blocks"][1]["C"].shape == (8, 8)


@functools.lru_cache(maxsize=None)
def _j_segment_softmax(n):
    return jax.jit(lambda s, i: jax.vmap(
        lambda c: JG.segment_softmax(c, i, n), in_axes=1, out_axes=1)(s))


@pytest.mark.parametrize("heads", [1, 4])
def test_segment_softmax_with_empty_segments(heads):
    """Segments 0-39 of 50: the last ten are empty (they take no rows and
    get none back); a segment of one edge gives 1."""
    rng = np.random.default_rng(heads)
    E, n = 300, 50
    seg = rng.integers(0, 40, E).astype(np.int32)
    seg[-1] = 39
    scores = (rng.standard_normal((E, heads)) * 5).astype(np.float32)
    want = np.asarray(_j_segment_softmax(n)(scores, seg))
    got = TG.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg),
                             n)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    sums = np.zeros((n, heads), np.float32)
    np.add.at(sums, seg, got.numpy())
    np.testing.assert_allclose(sums[np.unique(seg)], 1.0, rtol=1e-5)
    assert not sums[40:].any()
    mx = TG.segment_max(torch.from_numpy(scores), torch.from_numpy(seg), n)
    assert torch.isneginf(mx[40:]).all()


def test_colored_segment_sum_equals_the_reference_and_the_plain_sum():
    """Classes from ``edge_color_by_dst`` (both packages give the same
    colours); the port adds one class at a time without collisions: equal
    to the reference's bit for bit, and to the plain segment sum within
    float32 rounding (rtol 1e-5)."""
    g = jgen.erdos_renyi(300, 6.0, seed=3)
    e = tcsr.to_edge_list(g)
    src, dst = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
    ec_t, k_t = tschedule.edge_color_by_dst(src, dst, g.n_vertices)
    ec_j, k_j = jschedule.edge_color_by_dst(src, dst, g.n_vertices)
    np.testing.assert_array_equal(ec_t, ec_j)
    assert k_t == k_j
    msg = np.random.default_rng(0).standard_normal(
        (len(src), 5)).astype(np.float32)
    want = np.asarray(jax.jit(JG.colored_segment_sum, static_argnums=(2, 4))(
        msg, dst, g.n_vertices, ec_j, k_j))
    got = TG.colored_segment_sum(torch.from_numpy(msg), torch.from_numpy(dst),
                                 g.n_vertices, torch.from_numpy(ec_t), k_t)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = TG.segment_sum(torch.from_numpy(msg), torch.from_numpy(dst),
                           g.n_vertices)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)
    # a colour outside [0, n_colors) is left out, as in the reference
    ec_cut = ec_t.copy()
    ec_cut[:10] = k_t
    got = TG.colored_segment_sum(torch.from_numpy(msg), torch.from_numpy(dst),
                                 g.n_vertices, torch.from_numpy(ec_cut), k_t)
    want = np.asarray(jax.jit(JG.colored_segment_sum, static_argnums=(2, 4))(
        msg, dst, g.n_vertices, ec_cut, k_t))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the halo GatedGCN on the reference's ring
# --------------------------------------------------------------------------

def _halo_case(D):
    """(port params, cfg, shard batches, mesh, replicated tensors, the
    reference's replicated loss) at D shards."""
    old = make_torch_golden.HALO_D
    make_torch_golden.HALO_D = D
    try:
        part, shards, rep = make_torch_golden.halo_ring(tpart, tcsr)
    finally:
        make_torch_golden.HALO_D = old
    cfg_j = JG.GatedGCNConfig(**make_torch_golden.HALO_CFG)
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), cfg_j)
    src, dst, feats, labels, mask = rep
    logits = jax.jit(JG.gatedgcn_apply, static_argnums=(1, 5))(
        pj, cfg_j, feats, src, dst, part.n_pad)
    lj = float(JG.node_classification_loss(logits, labels, mask))
    pt = TG.params_from_reference("gatedgcn", jax.tree.map(np.asarray, pj))
    sh = [{k: torch.from_numpy(v) for k, v in s.items()} for s in shards]
    rep_t = [torch.from_numpy(x) for x in rep]
    return (pt, TG.GatedGCNConfig(**make_torch_golden.HALO_CFG), sh,
            tmesh.make_mesh((D,), ("data",), device="cpu"), rep_t,
            part.n_pad, lj)


@pytest.mark.parametrize("D", [1, 4, 8])
def test_halo_loss_equals_the_reference_replicated_loss(D):
    """One all-gather a layer and one for the loss; the gathered bytes are
    D payloads of (max_b, d) float32 a layer."""
    pt, cfg, sh, mesh, _, _, lj = _halo_case(D)
    tmetrics.reset()
    lt = float(TG.gatedgcn_halo_loss(pt, cfg, sh, mesh).detach())
    assert abs(lt - lj) <= HALO_REL * abs(lj), (lt, lj)
    assert tmesh.collectives() == cfg.n_layers + 1
    max_b = sh[0]["boundary"].shape[0]
    assert tmesh.gathered_bytes() == (cfg.n_layers * D * max_b
                                      * cfg.d_hidden * 4 + D * 2 * 4)


def test_halo_gradients_equal_the_replicated_gradients():
    pt, cfg, sh, mesh, rep, n_pad, _ = _halo_case(4)
    src, dst, feats, labels, mask = rep
    lh = TG.gatedgcn_halo_loss(pt, cfg, sh, mesh)
    gh = torch.autograd.grad(lh, T.leaves(pt), allow_unused=True,
                             materialize_grads=True)
    lr = TG.node_classification_loss(
        TG.gatedgcn_apply(pt, cfg, feats, src, dst, n_pad), labels, mask)
    gr = torch.autograd.grad(lr, T.leaves(pt), allow_unused=True,
                             materialize_grads=True)
    lh, lr = float(lh.detach()), float(lr.detach())
    assert abs(lh - lr) <= HALO_REL * abs(lr)
    for (key, _), a, b in zip(T.flatten_with_paths(pt), gh, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key,
                                   **GRAD_TOL)


def test_halo_takes_shards_of_unequal_edge_counts():
    """The reference stacks the shards' edges (equal counts); the port's
    host loop takes each shard's own.  Dropping one of a shard's local
    edges equals dropping it from the replicated graph."""
    pt, cfg, sh, mesh, rep, n_pad, _ = _halo_case(4)
    src, dst, feats, labels, mask = rep
    n_loc = sh[0]["feats"].shape[0]
    j = int(torch.nonzero(sh[2]["src"] < n_loc)[0, 0])
    # a local slot of shard 2 is relabeled vertex 2 * n_loc + slot
    gs, gd = 2 * n_loc + sh[2]["src"][j], 2 * n_loc + sh[2]["dst"][j]
    cut = torch.ones(len(sh[2]["src"]), dtype=torch.bool)
    cut[j] = False
    sh[2] = dict(sh[2], src=sh[2]["src"][cut], dst=sh[2]["dst"][cut])
    keep = ~((src == gs) & (dst == gd))
    assert int((~keep).sum()) == 1
    lh = float(TG.gatedgcn_halo_loss(pt, cfg, sh, mesh).detach())
    lr = float(TG.node_classification_loss(
        TG.gatedgcn_apply(pt, cfg, feats, src[keep], dst[keep], n_pad),
        labels, mask).detach())
    assert abs(lh - lr) <= HALO_REL * abs(lr)


def test_scatter_mode_scope():
    """``atomic_scatter`` switches the mode for its scope only; on the CPU
    both modes give the same numbers (the CPU adds in index order)."""
    x = torch.randn(50, 3)
    idx = torch.randint(0, 7, (50,))
    base = TG.segment_sum(x, idx, 7)
    with TG.atomic_scatter():
        assert TG._ATOMIC.get()
        assert torch.equal(TG.segment_sum(x, idx, 7), base)
    assert not TG._ATOMIC.get()
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet", "gatedgcn"])
def test_gnn_configs_equal_the_reference(arch):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    ja, ta = jconfigs.get(arch), tconfigs.get(arch)
    for f in ("name", "family", "notes", "extras"):
        assert getattr(ja, f) == getattr(ta, f), f
    for jc, tc in ((ja.make_smoke(), ta.make_smoke()),
                   (ja.make_full(), ta.make_full()),
                   (ja.make_full(d_in=100, n_classes=47),
                    ta.make_full(d_in=100, n_classes=47))):
        assert type(jc).__name__ == type(tc).__name__
        assert vars(jc) == vars(tc)
