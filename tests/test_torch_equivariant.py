"""Port vs reference: NequIP (``repro_torch.models.equivariant`` against
``repro.models.equivariant``).

The reference's weights (``nequip_init(PRNGKey(0))``, the smoke config) are
carried into the port by ``params_from_reference``; both packages then run
the same numpy batch: a ``MoleculeStream`` batch of 3 molecules (6 atoms,
12 edges each) with its sink node and its sink -> sink padding edges, and
the same batch with the padding edges marked -1 (NumPy's and JAX's
indexing wraps a -1 to the last row; the edge is masked).  The reference's
functions are ``jax.jit``'d.

Tolerances (float32): every compared array within ``REL`` = 1e-5 of its
largest reference magnitude (per node energies, forces, losses, and each
leaf's gradient of ``energy_loss`` with and without a ``forces`` label;
measured about 1e-6: XLA's and PyTorch's products and sums in another
order).  The host-side Clebsch-Gordan tensors are the same numpy code and
must be equal exactly.  The equivariance test is the reference's own
(``tests/test_models_smoke.py``), with its tolerances, on the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as JDP
from repro.launch.cells import _gnn_loss_fn as j_gnn_loss_fn
from repro.models import equivariant as JEQ
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.models import equivariant as TEQ
from repro_torch.models import gnn as TG

torch.set_num_threads(1)

CFG_J = JEQ.NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4,
                         cutoff=5.0, n_species=4)
CFG_T = TEQ.NequIPConfig(**vars(CFG_J))
REL = 1e-5
MOL = dict(n_nodes=6, n_edges=12, batch=3)
N_REAL_EDGES = MOL["batch"] * MOL["n_edges"]


def close(got, want, what="", rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-30),
                               err_msg=what)


def _t(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _ref_params():
    return JEQ.nequip_init(jax.random.PRNGKey(0), CFG_J)


def _port_params():
    return TEQ.params_from_reference(jax.tree.map(np.asarray, _ref_params()))


def _batch(edges: str) -> dict:
    """``edges``: "sink" (the stream's sink -> sink padding) or "pad" (the
    padding marked -1: both ends, the source only, the target only)."""
    b = next(JDP.MoleculeStream(n_species=CFG_J.n_species, d_feat=0, **MOL))
    if edges == "pad":
        kind = np.arange(b["src"].shape[0] - N_REAL_EDGES) % 3
        src, dst = b["src"].copy(), b["dst"].copy()
        src[N_REAL_EDGES:] = np.where(kind == 2, 1, -1)
        dst[N_REAL_EDGES:] = np.where(kind == 1, 2, -1)
        b["src"], b["dst"] = src, dst
    n = b["species"].shape[0]
    rng = np.random.default_rng(3)
    b["forces"] = rng.standard_normal((n, 3)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0                                  # the sink
    b["node_mask"] = mask
    return b


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return jax.tree.map(jnp.asarray, b)


@functools.lru_cache(maxsize=None)
def _j_apply_forces():
    def f(p, b):
        n = b["species"].shape[0]
        e = JEQ.nequip_apply(p, CFG_J, b["species"], b["positions"],
                             b["src"], b["dst"], n)
        et, fo = JEQ.energy_and_forces(p, CFG_J, b["species"],
                                       b["positions"], b["src"], b["dst"], n)
        return e, et, fo
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _j_loss_grad():
    return jax.jit(jax.value_and_grad(
        lambda p, b: JEQ.energy_loss(p, CFG_J, b)))


def _loss_batch(b, forces: bool) -> dict:
    keep = ("species", "positions", "src", "dst", "graph_id", "energy")
    out = {k: b[k] for k in keep}
    if forces:
        out["forces"], out["node_mask"] = b["forces"], b["node_mask"]
    return out


def test_real_cg_and_paths_equal_the_reference():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                assert np.array_equal(TEQ.real_cg(l1, l2, l3),
                                      JEQ.real_cg(l1, l2, l3)), (l1, l2, l3)
    for cfg in (tconfigs.get("nequip").make_full(),
                tconfigs.get("nequip").make_smoke()):
        j = JEQ.NequIPConfig(**vars(cfg))
        assert cfg.paths == j.paths
    assert len(tconfigs.get("nequip").make_full().paths) == 15


@functools.lru_cache(maxsize=None)
def _j_basis():
    return jax.jit(lambda v, r: (JEQ.spherical_harmonics(v, 2),
                                 JEQ.bessel_basis(r, 8, 5.0)))


def test_spherical_harmonics_and_bessel_basis_equal_the_reference():
    """Unit vectors, the zero vector of a zero-length edge (its unit is 0:
    the reference's finite values), and radii from 0 past the cutoff."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:4] = 0.0
    r = np.concatenate([[0.0, 1e-6, 1e-12], rng.uniform(0, 7, 61)]).astype(
        np.float32)
    sh_j, rbf_j = _j_basis()(v, r)
    sh_t = TEQ.spherical_harmonics(torch.from_numpy(v), 2)
    rbf_t = TEQ.bessel_basis(torch.from_numpy(r), 8, 5.0)
    assert sorted(sh_t) == sorted(sh_j)
    for l in sh_j:
        close(_t(sh_t[l]), sh_j[l], f"sh l={l}")
    close(_t(rbf_t), rbf_j, "bessel")
    assert np.isfinite(_t(rbf_t)).all()


@pytest.mark.parametrize("edges", ["sink", "pad"])
def test_apply_and_forces_equal_the_reference(edges):
    b = _batch(edges)
    n = b["species"].shape[0]
    e_j, et_j, f_j = _j_apply_forces()(_ref_params(), _jb(b))
    p = _port_params()
    bt = _tb(b)
    e_t = TEQ.nequip_apply(p, CFG_T, bt["species"], bt["positions"],
                           bt["src"], bt["dst"], n)
    with torch.no_grad():
        et_t, f_t = TEQ.energy_and_forces(p, CFG_T, bt["species"],
                                          bt["positions"], bt["src"],
                                          bt["dst"], n)
    # the sink (the last node) sums thousands of self-loop messages: its
    # energy is held apart, so that the real nodes' are held to their own
    # largest magnitude
    close(_t(e_t)[:-1], np.asarray(e_j)[:-1], "per-node energy")
    close(_t(e_t)[-1:], np.asarray(e_j)[-1:], "the sink's energy")
    close(_t(et_t), et_j, "total energy")
    close(_t(f_t), f_j, "forces")
    assert np.isfinite(_t(f_t)).all()
    assert not f_t.requires_grad
    # the sink's self-loops have zero length: no force on it
    if edges == "sink":
        assert not _t(f_t)[-1].any()


@pytest.mark.parametrize("forces", [False, True], ids=["energy", "forces"])
@pytest.mark.parametrize("edges", ["sink", "pad"])
def test_energy_loss_and_gradients_equal_the_reference(edges, forces):
    """With a ``forces`` label the loss differentiates the forces again
    (the double backward)."""
    b = _loss_batch(_batch(edges), forces)
    l_j, g_j = _j_loss_grad()(_ref_params(), _jb(b))
    p = _port_params()
    l_t = TEQ.energy_loss(p, CFG_T, _tb(b))
    g_t = torch.autograd.grad(l_t, T.leaves(p), allow_unused=True,
                              materialize_grads=True)
    close(float(l_t.detach()), float(l_j), "loss")
    jflat = jax.tree_util.tree_flatten_with_path(g_j)[0]
    tflat = T.flatten_with_paths(p)
    assert [k for k, _ in tflat] == [jax.tree_util.keystr(k) for k, _ in jflat]
    for (key, _), gt, (_, gj) in zip(tflat, g_t, jflat):
        close(_t(gt), gj, key)
        assert np.isfinite(_t(gt)).all(), key


def test_forces_keep_their_graph_under_grad_mode():
    """Under grad mode the forces are differentiable (``gnn.gather``'s
    backward records its scatter); under ``no_grad`` they are detached."""
    b = _tb(_batch("sink"))
    n = b["species"].shape[0]
    p = _port_params()
    _, f = TEQ.energy_and_forces(p, CFG_T, b["species"], b["positions"],
                                 b["src"], b["dst"], n)
    assert f.requires_grad
    (g,) = torch.autograd.grad((f ** 2).sum(), [p["species_embed"]])
    assert g.abs().max() > 0
    assert not b["positions"].requires_grad


def test_equivariance():
    """E(3) invariance of energies / equivariance of forces under a random
    rotation + translation (the reference's test, on the port)."""
    params = TEQ.nequip_init(torch.Generator().manual_seed(0), CFG_T)
    rng = np.random.default_rng(0)
    N = 10
    pos = rng.uniform(0, 3, (N, 3)).astype(np.float32)
    species = torch.from_numpy(rng.integers(0, 4, N).astype(np.int32))
    src = rng.integers(0, N, 40).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, N - 1, 40)) % N).astype(np.int32)
    src, dst = torch.from_numpy(src), torch.from_numpy(dst)
    a, b, c = 0.3, 1.1, -0.7
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                   [0, np.sin(c), np.cos(c)]])
    R = (Rz @ Ry @ Rx).astype(np.float32)
    pos2 = (pos @ R.T + np.float32([1.0, -2.0, 0.5])).astype(np.float32)
    with torch.no_grad():
        e1, f1 = TEQ.energy_and_forces(params, CFG_T, species,
                                       torch.from_numpy(pos), src, dst, N)
        e2, f2 = TEQ.energy_and_forces(params, CFG_T, species,
                                       torch.from_numpy(pos2), src, dst, N)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4)
    np.testing.assert_allclose(f1.numpy() @ R.T, f2.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_params_from_reference_checks_the_tree():
    tree = jax.tree.map(np.asarray, _ref_params())
    with pytest.raises(ValueError, match="expected"):
        TEQ.params_from_reference({k: v for k, v in tree.items()
                                   if k != "readout2"})
    pt = TEQ.params_from_reference(dict(tree, scalar_embed=np.zeros(
        (3, 8), np.float32)))
    assert pt["scalar_embed"].shape == (3, 8)
    pt = TEQ.params_from_reference(tree)
    assert all(x.requires_grad for x in T.leaves(pt))
    assert pt["layers"][1]["self"][2].shape == (8, 8)
    assert len(pt["layers"][0]["radial"]["w"]) == 2
    # the port's own initialisation has the reference's tree and shapes
    own = TEQ.nequip_init(torch.Generator().manual_seed(0), CFG_T)
    assert [(k, tuple(x.shape)) for k, x in T.flatten_with_paths(own)] == [
        (jax.tree_util.keystr(k), tuple(x.shape))
        for k, x in jax.tree_util.tree_flatten_with_path(_ref_params())[0]]


@functools.lru_cache(maxsize=None)
def _j_cell_loss(mode, n):
    shp = {"mode": mode, "d_feat": 0, "n_classes": 2}
    return jax.jit(j_gnn_loss_fn(jconfigs.get("nequip"), shp, CFG_J, n))


@pytest.mark.parametrize("mode", ["batched", "full"])
def test_cell_loss_equals_the_reference(mode):
    """``gnn_loss_fn``'s ``nequip`` branch: the (N, 1) scalar head summed
    per molecule (the sink's ``graph_id`` dropped), or regressed on
    ``labels % 2`` outside the batched mode."""
    b = _loss_batch(_batch("sink"), False)
    n = b["species"].shape[0]
    b["feats"] = np.zeros((n, 0), np.float32)
    if mode == "full":
        b["labels"] = np.random.default_rng(1).integers(
            0, 5, n - 1).astype(np.int32)
    want = _j_cell_loss(mode, n)(_ref_params(), _jb(b))
    shp = {"mode": mode, "d_feat": 0, "n_classes": 2}
    got = TG.gnn_loss_fn(tconfigs.get("nequip"), shp, CFG_T, n)(
        _port_params(), _tb(b))
    close(float(got.detach()), float(want), mode)
