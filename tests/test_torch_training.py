"""Port vs reference: the training stack (``repro_torch.training`` against
``repro.training``) and the training launcher.

Tolerances (float32): ``lr_at`` rtol 1e-6 (one ``cos`` a step); one AdamW
step rtol 1e-6 / atol 1e-7 on parameters and moments, ten steps rtol 1e-5 /
atol 1e-6 (the same formula, rounding compounding); the int8 compressor's
codes equal, its scale and residual rtol 1e-6 / atol 1e-8 at inputs of
0.01, the residual atol 5e-7 at inputs up to 4 (``x - q * scale``: XLA fuses
it, PyTorch rounds the product first, an ulp of x apart); a loss history
of ``train_loop.run`` rtol 1e-4 against the reference's ``TL.run`` (six
AdamW steps of a two-layer GatedGCN, measured at about 2e-7).  Checkpoints
cross between the packages bit for bit; a restart from LATEST is bit for
bit.  The reference's functions are ``jax.jit``'d.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as JDP
from repro.graphs import generators as jgen
from repro.launch.cells import _gnn_loss_fn as j_gnn_loss_fn
from repro.models import gnn as JG
from repro.training import checkpoint as JCK
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.core import mesh as tmesh
from repro_torch.data import pipeline as TDP
from repro_torch.launch import train as tlaunch
from repro_torch.models import gnn as TG
from repro_torch.obs import metrics as tmetrics
from repro_torch.training import checkpoint as TCK
from repro_torch.training import elastic as TEL
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train_loop as TTL

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(HERE, "make_torch_golden.py"))
make_torch_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_torch_golden)


def _tree_np(seed=0):
    """A parameter tree with lists, matrices and vectors (numpy)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": f(6, 4), "blocks": [{"A": f(4, 4), "b": f(4)},
                                         {"A": f(4, 4), "b": f(4)}],
            "scale": f(3)}


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got_tree, want_tree, **tol):
    for (k, g), w in zip(T.flatten_with_paths(got_tree),
                         jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=k,
                                   **tol)


def test_lr_schedule_equals_the_reference():
    cfg_j = JOPT.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                 min_lr_frac=0.1)
    cfg_t = TOPT.OptimizerConfig(**vars(cfg_j))
    j_lr = jax.jit(lambda s: JOPT.lr_at(cfg_j, s))
    want = np.array([float(j_lr(jnp.int32(s))) for s in range(0, 120, 7)])
    got = np.array([float(TOPT.lr_at(cfg_t, torch.tensor(s, dtype=torch.int32)))
                    for s in range(0, 120, 7)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(float(TOPT.lr_at(cfg_t, 7)), want[1],
                               rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 10])
def test_adamw_equals_the_reference(steps):
    """Clipping (the gradients' norm is above clip_norm), bias correction,
    weight decay on matrices only."""
    tol = dict(rtol=1e-6, atol=1e-7) if steps == 1 else dict(rtol=1e-5,
                                                              atol=1e-6)
    cfg_j = JOPT.OptimizerConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                                 clip_norm=0.5)
    cfg_t = TOPT.OptimizerConfig(**vars(cfg_j))
    pj = jax.tree.map(jnp.asarray, _tree_np(0))
    sj = JOPT.init_opt_state(pj)
    pt = _to_torch(_tree_np(0))
    st = TOPT.init_opt_state(pt)
    j_upd = jax.jit(lambda p, g, s: JOPT.adamw_update(cfg_j, p, g, s))
    for i in range(steps):
        g = _tree_np(100 + i)
        pj, sj, mj = j_upd(pj, jax.tree.map(jnp.asarray, g), sj)
        pt, st, mt = TOPT.adamw_update(cfg_t, pt, _to_torch(g), st)
    _close(pt, pj, **tol)
    _close(st["mu"], sj["mu"], **tol)
    _close(st["nu"], sj["nu"], **tol)
    assert int(st["step"]) == int(sj["step"]) == steps
    assert st["step"].dtype == torch.int32
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)


def test_int8_compression_equals_the_reference():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(512) * 0.01).astype(np.float32)
    err = (rng.standard_normal(512) * 1e-4).astype(np.float32)
    qj, sj, ej = jax.jit(JOPT.compress_int8)(g, err)
    qt, s_t, et = TOPT.compress_int8(torch.from_numpy(g),
                                     torch.from_numpy(err))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(float(s_t), float(sj), rtol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(TOPT.decompress_int8(qt, s_t).numpy(),
                               np.asarray(JOPT.decompress_int8(qj, sj)),
                               rtol=1e-6)
    # error feedback: exact on average (the reference's own test)
    gt = torch.from_numpy(g)
    e = torch.zeros_like(gt)
    acc = torch.zeros_like(gt)
    for _ in range(50):
        q, s, e = TOPT.compress_int8(gt, e)
        acc = acc + TOPT.decompress_int8(q, s)
    np.testing.assert_allclose((acc / 50).numpy(), g, atol=5e-5)


def test_compressed_psum_at_four_shards():
    """Each shard's tree against the reference's formula: the shards'
    ``compress_int8`` codes summed in int32, times the largest scale; the
    residual is the shard's own.  Two gathers a leaf."""
    D = 4
    mesh = tmesh.make_mesh((D,), ("data",), device="cpu")
    grads = [_tree_np(10 + d) for d in range(D)]
    errs = [T.tree_map(lambda a: (a * 1e-3).astype(np.float32),
                       _tree_np(20 + d)) for d in range(D)]
    tmetrics.reset()
    got_g, got_e = TOPT.compressed_psum([_to_torch(g) for g in grads],
                                        [_to_torch(e) for e in errs], mesh)
    n_leaves = len(T.leaves(grads[0]))
    assert tmesh.collectives() == 2 * n_leaves
    comp = jax.jit(JOPT.compress_int8)
    for i, key in enumerate(k for k, _ in T.flatten_with_paths(grads[0])):
        c = [comp(T.leaves(grads[d])[i], T.leaves(errs[d])[i])
             for d in range(D)]
        tot = sum(np.asarray(q).astype(np.int32) for q, _, _ in c)
        smax = max(float(s) for _, s, _ in c)
        want = tot.astype(np.float32) * np.float32(smax)
        for d in range(D):
            np.testing.assert_allclose(T.leaves(got_g[d])[i].numpy(), want,
                                       rtol=1e-6, err_msg=key)
            np.testing.assert_allclose(T.leaves(got_e[d])[i].numpy(),
                                       np.asarray(c[d][2]), rtol=1e-6,
                                       atol=5e-7, err_msg=key)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _ckpt_tree():
    """{"params": ..., "opt": {"mu", "nu", "step"}} as train_loop saves."""
    p = _tree_np(1)
    return {"params": p, "opt": {"mu": _tree_np(2), "nu": _tree_np(3),
                                 "step": np.int32(7)}}


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """Written by the reference, restored by the port, and back: the same
    keys and the same bits, the step an int32 scalar."""
    tree = _ckpt_tree()
    JCK.save(str(tmp_path / "j"), 7, jax.tree.map(jnp.asarray, tree),
             extra={"stream": {"seed": 1, "step": 7}})
    like = T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    got, step, extra = TCK.restore(str(tmp_path / "j"), like)
    assert step == 7 and extra == {"stream": {"seed": 1, "step": 7}}
    for (k, g), w in zip(T.flatten_with_paths(got), T.leaves(tree)):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)

    TCK.save(str(tmp_path / "t"), 9, like, extra={"x": 1})
    with np.load(tmp_path / "t" / "step_00000009" / "arrays.npz") as f:
        keys = sorted(f.files)
    assert keys == sorted(k for k, _ in T.flatten_with_paths(tree))
    assert "['params']['blocks'][1]['A']" in keys
    back, step, extra = JCK.restore(str(tmp_path / "t"),
                                    jax.tree.map(jnp.asarray, tree))
    assert step == 9 and extra == {"x": 1}
    for w, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(b).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(b), w)


def test_checkpoint_atomicity_and_gc(tmp_path):
    """The reference's test: five saves keep the two newest; LATEST names
    the last; a stale ``.tmp`` left by a killed writer is ignored."""
    d = str(tmp_path)
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones((2, 2))}}
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    for s in (1, 2, 3, 4, 5):
        TCK.save(d, s, tree, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_")
                   and not x.endswith(".tmp"))
    assert steps == ["step_00000004", "step_00000005"]
    got = TCK.restore(d, tree)
    assert got is not None and got[1] == 5
    assert TCK.restore(str(tmp_path / "none"), tree) is None
    with pytest.raises(ValueError, match="ckpt shape"):
        TCK.restore(d, {"w": torch.zeros(3), "b": {"x": torch.ones((2, 2))}})


def test_async_checkpointer_copies_before_save_returns(tmp_path):
    """``save`` takes its host copies before it returns: an in-place update
    right after does not reach the file."""
    w = torch.arange(6.0)
    ck = TCK.AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, {"w": w})
    w.add_(100.0)
    ck.wait()
    got, step, _ = TCK.restore(str(tmp_path), {"w": w})
    assert step == 1
    assert torch.equal(got["w"], torch.arange(6.0))


def test_elastic_restore_places_each_leaf(tmp_path):
    """Restored values equal the saved ones whatever mesh restores them;
    ``rules`` picks a device of the mesh (None: its first) and may not pick
    one outside it."""
    tree = {"w": torch.arange(16.0).reshape(4, 4), "v": torch.ones(3)}
    TCK.save(str(tmp_path), 7, tree)
    mesh = tmesh.make_mesh((2,), ("data",), device="cpu")
    like = {"w": torch.empty((4, 4), device="meta"),
            "v": torch.empty((3,), device="meta")}
    got, step, _ = TEL.elastic_restore(
        str(tmp_path), like, mesh,
        lambda path, leaf: torch.device("cpu") if "w" in path else None)
    assert step == 7
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["v"],
                                                            tree["v"])
    got, _, _ = TEL.elastic_restore(str(tmp_path), like)   # no mesh
    assert got["w"].device.type == "cpu"
    moved = TEL.reshard_tree(tree, mesh, lambda path, leaf: None)
    assert torch.equal(moved["w"], tree["w"])
    with pytest.raises(ValueError, match="not a device of the mesh"):
        TEL.reshard_tree(tree, mesh, lambda path, leaf: "meta")


# --------------------------------------------------------------------------
# the train loop on the GatedGCN smoke model
# --------------------------------------------------------------------------

CFG = JG.GatedGCNConfig(n_layers=2, d_hidden=8, d_in=16, d_out=3)
STEPS = 6
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=STEPS)


class PairStream:
    """Two ``FullGraphStream``s of one graph (seeds 0 and 1) stacked on a
    leading axis of 2, so ``microbatches=2`` splits the batch into whole
    graphs.  ``dp`` is a package's ``data.pipeline``."""

    def __init__(self, dp, g):
        self.s = [dp.FullGraphStream(g, d_feat=CFG.d_in, n_classes=CFG.d_out,
                                     seed=i, pad_edges_to=1024)
                  for i in range(2)]

    def state(self):
        return {"a": self.s[0].state(), "b": self.s[1].state()}

    def restore(self, st):
        self.s[0].restore(st["a"])
        self.s[1].restore(st["b"])

    def __next__(self):
        a, b = next(self.s[0]), next(self.s[1])
        return {k: np.stack([a[k], b[k]]) for k in a}


def _pair_loss(loss_one):
    """The mean over the leading axis of one graph's loss."""
    def loss(p, b):
        n = b["src"].shape[0]
        return sum(loss_one(p, {k: v[i] for k, v in b.items()})
                   for i in range(n)) / n
    return loss


def _loss_fns(n_nodes):
    arch_j = jconfigs.get("gatedgcn")
    shp = {"mode": "full", "d_feat": CFG.d_in, "n_classes": 3}
    j = j_gnn_loss_fn(arch_j, shp, CFG, n_nodes)
    t = TG.gnn_loss_fn(tconfigs.get("gatedgcn"), shp,
                       TG.GatedGCNConfig(**vars(CFG)), n_nodes)
    return _pair_loss(j), _pair_loss(t)


def _reference_run(g, microbatches):
    """(the initial weights as numpy, the loss history)."""
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), CFG)
    p0 = jax.tree.map(np.asarray, pj)      # the run donates its arguments
    loss_j, _ = _loss_fns(g.n_vertices + 1)
    _, _, hist = JTL.run(loss_j, pj, PairStream(JDP, g),
                         JOPT.OptimizerConfig(**OPT),
                         JTL.TrainLoopConfig(total_steps=STEPS,
                                             microbatches=microbatches,
                                             log_every=1),
                         to_device=lambda b: jax.tree.map(jnp.asarray, b))
    return p0, [h["loss"] for h in hist]


def _port_run(p0, g, microbatches, total=STEPS, ckpt_dir=None):
    pt = TG.params_from_reference("gatedgcn", p0)
    _, loss_t = _loss_fns(g.n_vertices + 1)
    params, opt, hist = TTL.run(
        loss_t, pt, PairStream(TDP, g), TOPT.OptimizerConfig(**OPT),
        TTL.TrainLoopConfig(total_steps=total, microbatches=microbatches,
                            log_every=1, ckpt_every=2, ckpt_dir=ckpt_dir),
        to_device=lambda b: tlaunch.to_device(b, "cpu"))
    return params, opt, [h["loss"] for h in hist]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_loop_equals_the_reference(microbatches):
    g = jgen.mesh2d(12, 12)
    p0, want = _reference_run(g, microbatches)
    _, _, got = _port_run(p0, g, microbatches)
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_restart_is_bit_identical(tmp_path):
    """Kill-and-restart from LATEST (after step 4; checkpoints every 2)
    reproduces the uninterrupted run: parameters, moments, step and the
    loss history, bit for bit."""
    g = jgen.mesh2d(12, 12)
    p0 = jax.tree.map(np.asarray, JG.gatedgcn_init(jax.random.PRNGKey(0),
                                                   CFG))
    p_full, o_full, h_full = _port_run(p0, g, 2, ckpt_dir=str(tmp_path / "a"))
    _, _, h_first = _port_run(p0, g, 2, total=4, ckpt_dir=str(tmp_path / "b"))
    p_res, o_res, h_rest = _port_run(p0, g, 2, ckpt_dir=str(tmp_path / "b"))
    assert h_first + h_rest == h_full
    for a, b in zip(T.leaves({"p": p_full, "o": o_full}),
                    T.leaves({"p": p_res, "o": o_res})):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet", "gatedgcn"])
def test_launcher_trains_each_gnn(arch, tmp_path, capsys):
    assert tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "device=cpu" in out
    assert open(tmp_path / "LATEST").read() == "step_00000003"


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-moe-a2.7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_launcher_refuses_what_is_not_ported(arch, tmp_path, capsys):
    """The MLA / MoE archs, refused until they were ported, train (finite
    losses, a checkpoint at the last step); what the port still lacks, an
    arch the registry does not know, is refused."""
    assert tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu",
                         "--seq-len", "32", "--batch", "2", "--ckpt-dir",
                         str(tmp_path)]) == 0
    out = capsys.readouterr().out
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    assert len(final) == 1 and "device=cpu" in final[0]
    assert np.isfinite(float(final[0].split()[2]))
    assert open(tmp_path / "LATEST").read() == "step_00000003"
    with pytest.raises(KeyError, match="unknown arch"):
        tlaunch.main(["--arch", arch + "-x", "--steps", "1", "--device",
                      "cpu"])


LAUNCH_STEPS = 3


def _launcher_loss_history(arch):
    """(reference, port) loss histories of the launchers' ``build_*`` for
    ``arch`` at the launcher's defaults (batch 8; ``--steps 3``: lr 3e-4,
    one warm-up step), every step logged, from the reference's weights."""
    from repro.launch import train as jlaunch
    ja, ta = jconfigs.get(arch), tconfigs.get(arch)
    if ja.family == "recsys":
        pj, sj, lj = jlaunch.build_recsys(ja, True, 8)
        pt, st, lt = tlaunch.build_recsys(ta, True, 8, "cpu")
    else:
        pj, sj, lj = jlaunch.build_gnn(ja, True, 8)
        pt, st, lt = tlaunch.build_gnn(ta, "cpu", 8)
    assert st.state() == sj.state()     # nequip: one batch drawn already
    vals = dict(zip([jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(pj)[0]],
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, pj))))
    with torch.no_grad():
        for k, x in T.flatten_with_paths(pt):
            x.copy_(torch.from_numpy(np.array(vals[k])))
    opt = dict(lr=3e-4, warmup_steps=1, total_steps=LAUNCH_STEPS)
    loop = dict(total_steps=LAUNCH_STEPS, log_every=1)
    _, _, hj = JTL.run(lj, pj, sj, JOPT.OptimizerConfig(**opt),
                       JTL.TrainLoopConfig(**loop),
                       to_device=lambda b: jax.tree.map(jnp.asarray, b))
    _, _, ht = TTL.run(lt, pt, st, TOPT.OptimizerConfig(**opt),
                       TTL.TrainLoopConfig(**loop),
                       to_device=lambda b: tlaunch.to_device(b, "cpu"))
    return [h["loss"] for h in hj], [h["loss"] for h in ht]


@pytest.mark.parametrize("arch", ["nequip", "dcn-v2"])
def test_launcher_builds_train_as_the_reference(arch):
    """``build_gnn`` (nequip) and ``build_recsys`` (dcn-v2) against the
    reference's, loss for loss over three steps (rtol 1e-4, as the GatedGCN
    history above)."""
    want, got = _launcher_loss_history(arch)
    assert len(got) == LAUNCH_STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("arch", ["nequip", "dcn-v2"])
def test_launcher_trains_nequip_and_dcn_v2(arch, tmp_path, capsys):
    assert tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "device=cpu" in out
    assert open(tmp_path / "LATEST").read() == "step_00000003"


def test_launcher_watchdog_exits_75():
    """A step slower than --step-timeout x the trailing median (0 here:
    every step is) stops the run with exit code 75 at the fifth log."""
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "gatedgcn", "--steps", "20", "--device",
                      "cpu", "--step-timeout", "0"])
    assert e.value.code == 75


def test_launcher_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlaunch.main(["--arch", "gatedgcn", "--steps", "1"])


def test_golden_leaf_values_cover_a_tree():
    vals = make_torch_golden.gnn_leaf_values(
        [("['w']", (4, 2)), ("['ln_scale']", (2,)), ("['b']", (2,))])
    assert vals["['w']"].dtype == np.float32
    assert (vals["['ln_scale']"] == 1).all() and not vals["['b']"].any()
