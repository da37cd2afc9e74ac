"""Port vs reference: DCN-v2 (``repro_torch.models.recsys`` against
``repro.models.recsys``).

The reference's weights (``dcnv2_init(PRNGKey(0))``) are carried into the
port by ``params_from_reference``; both packages then run the same numpy
batch (``RecsysStream``: ragged bags of ``max_hots = 2``, the missing hots
-1).  The smoke config is run in both ``structure``s, full-rank and with
``cross_rank = 4``.  The reference's functions are ``jax.jit``'d.

Tolerances (float32): logits, probabilities and the loss within 1e-5 of
their largest reference magnitude, each leaf's gradient within 1e-5 of its
largest reference gradient (measured about 1e-7: the same products in
another order); the bag lookups 1e-6.  Top-k: the values within 1e-6, the
indices equal as sets (the scores here have no ties; ``lax.top_k`` and
``torch.topk`` may order tied scores differently).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as JDP
from repro.models import recsys as JRS
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.models import recsys as TRS

torch.set_num_threads(1)

REL = 1e-5
BATCH = 32
VARIANTS = {"stacked": dict(), "parallel": dict(structure="parallel"),
            "stacked-lowrank": dict(cross_rank=4),
            "parallel-lowrank": dict(structure="parallel", cross_rank=4)}


def close(got, want, what="", rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-30),
                               err_msg=what)


def _t(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _cfg(variant):
    j = dataclasses.replace(jconfigs.get("dcn-v2").make_smoke(),
                            **VARIANTS[variant])
    return j, TRS.DCNv2Config(**vars(j))


@functools.lru_cache(maxsize=None)
def _ref_params(variant):
    return JRS.dcnv2_init(jax.random.PRNGKey(0), _cfg(variant)[0])


def _port_params(variant):
    return TRS.params_from_reference(
        jax.tree.map(np.asarray, _ref_params(variant)))


def _batch(cfg, batch=BATCH, seed=0):
    return next(JDP.RecsysStream(batch=batch, n_dense=cfg.n_dense,
                                 n_sparse=cfg.n_sparse, vocabs=cfg.vocabs,
                                 max_hots=cfg.max_hots, seed=seed))


@functools.lru_cache(maxsize=None)
def _j_step(variant):
    cfg = _cfg(variant)[0]

    def f(p, b):
        loss, g = jax.value_and_grad(lambda q: JRS.ctr_loss(q, cfg, b))(p)
        return (JRS.dcnv2_forward(p, cfg, b["dense"], b["sparse"]),
                JRS.predict(p, cfg, b), loss, g)
    return jax.jit(f)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_loss_and_gradients_equal_the_reference(variant):
    cfg_j, cfg_t = _cfg(variant)
    b = _batch(cfg_j)
    assert (b["sparse"] < 0).any()                 # ragged bags
    logit_j, prob_j, loss_j, g_j = _j_step(variant)(
        _ref_params(variant), jax.tree.map(jnp.asarray, b))
    p = _port_params(variant)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    logit_t = TRS.dcnv2_forward(p, cfg_t, bt["dense"], bt["sparse"])
    prob_t = TRS.predict(p, cfg_t, bt)
    loss_t = TRS.ctr_loss(p, cfg_t, bt)
    g_t = torch.autograd.grad(loss_t, T.leaves(p), allow_unused=True,
                              materialize_grads=True)
    close(_t(logit_t), logit_j, "logits")
    close(_t(prob_t), prob_j, "predict")
    close(float(loss_t.detach()), float(loss_j), "ctr_loss")
    jflat = jax.tree_util.tree_flatten_with_path(g_j)[0]
    tflat = T.flatten_with_paths(p)
    assert [k for k, _ in tflat] == [jax.tree_util.keystr(k) for k, _ in jflat]
    for (key, _), gt, (_, gj) in zip(tflat, g_t, jflat):
        close(_t(gt), gj, key)


@functools.lru_cache(maxsize=None)
def _j_bag(mode):
    def f(table, idx, w):
        out = JRS.embedding_bag(table, idx, mode)
        return out, jax.grad(lambda t: (JRS.embedding_bag(t, idx, mode)
                                        * w).sum())(table)
    return jax.jit(f)


@pytest.mark.parametrize("hots", [1, 2, 3])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_equals_the_reference(mode, hots):
    """Ragged bags: -1 pads masked, a bag with no real id (0 for ``sum``
    and ``mean`` alike), ids past the table clipped; one id a bag (1-D
    indices) too.  Its table gradient with many repeated ids."""
    rng = np.random.default_rng(hots)
    V, D, B = 7, 4, 64
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V + 3, (B, hots)).astype(np.int32)
    idx[rng.random((B, hots)) < 0.3] = -1
    idx[0] = -1
    if hots == 1:
        idx = idx[:, 0]
    w = rng.standard_normal((B, D)).astype(np.float32)
    out_j, g_j = _j_bag(mode)(table, idx, w)
    tt = torch.from_numpy(table).requires_grad_(True)
    out_t = TRS.embedding_bag(tt, torch.from_numpy(idx), mode)
    (g_t,) = torch.autograd.grad((out_t * torch.from_numpy(w)).sum(), [tt])
    close(_t(out_t), out_j, "bag", rel=1e-6)
    close(_t(g_t), g_j, "table gradient", rel=1e-6)
    assert not _t(out_t)[0].any()


@functools.lru_cache(maxsize=None)
def _j_retrieval(variant, top_k):
    cfg = _cfg(variant)[0]

    def f(p, b, qd, qs):
        cand = JRS.make_candidate_tower(p, cfg, b["dense"], b["sparse"])
        return cand, JRS.retrieval_scores(p, cfg, qd, qs, cand, top_k=top_k)
    return jax.jit(f)


@pytest.mark.parametrize("variant", ["stacked", "parallel-lowrank"])
def test_retrieval_equals_the_reference(variant):
    cfg_j, cfg_t = _cfg(variant)
    b = _batch(cfg_j, batch=256, seed=1)
    q = _batch(cfg_j, batch=1, seed=2)
    top_k = 16
    cand_j, (s_j, v_j, i_j) = _j_retrieval(variant, top_k)(
        _ref_params(variant), jax.tree.map(jnp.asarray, b), q["dense"],
        q["sparse"])
    p = _port_params(variant)
    cand_t = TRS.make_candidate_tower(p, cfg_t, torch.from_numpy(b["dense"]),
                                      torch.from_numpy(b["sparse"]))
    s_t, v_t, i_t = TRS.retrieval_scores(
        p, cfg_t, torch.from_numpy(q["dense"]), torch.from_numpy(q["sparse"]),
        cand_t, top_k=top_k)
    close(_t(cand_t), cand_j, "candidate tower")
    close(_t(s_t), s_j, "scores")
    close(_t(v_t), v_j, "top-k values", rel=1e-6)
    assert (np.diff(_t(v_t)) <= 0).all()
    scores = _t(s_t)
    assert len(np.unique(scores)) == scores.size   # no ties here
    assert set(_t(i_t).tolist()) == set(np.asarray(i_j).tolist())
    # top-k is a sort of the scores
    np.testing.assert_array_equal(_t(v_t), np.sort(scores)[::-1][:top_k])


def test_params_from_reference_checks_the_tree():
    tree = jax.tree.map(np.asarray, _ref_params("stacked-lowrank"))
    with pytest.raises(ValueError, match="expected"):
        TRS.params_from_reference({k: v for k, v in tree.items()
                                   if k != "b_logit"})
    pt = TRS.params_from_reference(tree)
    assert all(x.requires_grad for x in T.leaves(pt))
    assert pt["cross"][1]["u"].shape == (61, 4)
    assert pt["tables"][5].shape == (1000, 8)
    # the port's own initialisation has the reference's tree and shapes
    for variant in VARIANTS:
        cfg_j, cfg_t = _cfg(variant)
        own = TRS.dcnv2_init(torch.Generator().manual_seed(0), cfg_t)
        assert [(k, tuple(x.shape))
                for k, x in T.flatten_with_paths(own)] == [
            (jax.tree_util.keystr(k), tuple(x.shape)) for k, x in
            jax.tree_util.tree_flatten_with_path(_ref_params(variant))[0]]


def test_configs_and_n_params_equal_the_reference():
    ja, ta = jconfigs.get("dcn-v2"), tconfigs.get("dcn-v2")
    for f in ("name", "family", "notes", "extras"):
        assert getattr(ja, f) == getattr(ta, f), f
    for jc, tc in ((ja.make_smoke(), ta.make_smoke()),
                   (ja.make_full(), ta.make_full())):
        assert vars(jc) == vars(tc)
        assert (jc.vocabs, jc.d_x0) == (tc.vocabs, tc.d_x0)
        assert JRS.n_params(jc) == TRS.n_params(tc)
        for v in VARIANTS.values():
            assert JRS.n_params(dataclasses.replace(jc, **v)) == \
                TRS.n_params(dataclasses.replace(tc, **v))
    assert TRS.n_params(ta.make_full()) == 418_568_643
