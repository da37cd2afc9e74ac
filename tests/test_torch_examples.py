"""The port's four example scripts (``repro_torch.examples``) against the
reference's library, on the CPU, at small sizes.

Each example's ``main(argv)`` returns the values it prints.  The reference's
``examples/`` scripts run at import, so the reference side here calls the
library functions those scripts call, with the same arguments (and, where
the weights are random, the reference's weights carried into the port by
``params_from_reference``).  Colourings are held bit-equal, served greedy
tokens equal, losses within ``LOSS_RTOL``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import coloring as jcol
from repro.data.pipeline import FullGraphStream as JFullGraphStream
from repro.data.pipeline import TokenStream as JTokenStream
from repro.dynamic import ColoringService as JService
from repro.graphs import generators as jgen
from repro.models import gnn as JG
from repro.models import transformer as JTF
from repro.resilience import faults as jfaults
from repro.serving.serve_loop import Request as JRequest
from repro.serving.serve_loop import ServeEngine as JServeEngine
from repro.training import train_loop as JTL
from repro.training.optimizer import OptimizerConfig as JOpt
from repro.training.optimizer import adamw_update as j_adamw
from repro.training.optimizer import init_opt_state as j_init_opt
from repro_torch.examples import (color_then_train_gnn, quickstart, serve_lm,
                                  train_lm)
from repro_torch.models import gnn as TG
from repro_torch.models import transformer as TTF

torch.set_num_threads(1)

SIDE = 6            # quickstart's 3D mesh: 216 vertices (the script: 16)
GNN_SIDE = 12       # the GNN example's 2D mesh (the script: 48)
GNN_STEPS = 11      # losses printed at steps 0 and 10 (the script: 60)
N_REQUESTS = 6      # served requests, 4 slots (the script: 12)
# float32 on both sides, the port's AdamW the reference's arithmetic; the
# summation orders of the two packages' matmuls differ
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def qs():
    return quickstart.main(["--device", "cpu", "--side", str(SIDE)])


def test_quickstart_colorings_equal_the_reference(qs):
    g = jgen.mesh3d(SIDE, SIDE, SIDE)
    for key, spec in (("cat", japi.ColoringSpec("cat")),
                      ("rsoc", japi.ColoringSpec("rsoc"))):
        r = japi.color(g, spec, seed=0)
        assert np.array_equal(qs[key]["colors"], r.colors), key
        assert (qs[key]["n_colors"], qs[key]["n_rounds"],
                qs[key]["total_conflicts"], qs[key]["gather_passes"]) == (
            r.n_colors, r.n_rounds, r.total_conflicts, r.gather_passes), key
    r2 = japi.color(g, distance=2, seed=0)
    assert np.array_equal(qs["distance2"]["colors"], r2.colors)
    assert qs["distance2"]["n_rounds"] == r2.n_rounds
    assert qs["serial_colors"] == jcol.n_colors_used(
        jcol.greedy_sequential(g))
    r = japi.color(g, algorithm="rsoc", seed=0)
    assert qs["set_sizes"] == np.bincount(r.colors).tolist()
    assert qs["replay_equal"] and qs["traces"] == 2
    assert "nearest supported spec" in qs["rejected"]


def test_quickstart_service_equals_the_reference(qs):
    """Steps 11-13 of the reference's script, run on its library."""
    svc = JService(seed=0, ell_cap=8, C=32, ovf_cap=256, delta_cap=64)
    for i in range(4):
        svc.add_graph(f"tenant{i}", jgen.erdos_renyi(64, 5.0, seed=i))
    svc.submit("tenant0", inserts=[[0, 9], [3, 17]], deletes=[[0, 1]])
    svc.submit("tenant1", inserts=[[2, 11]])
    stats = svc.step()
    assert qs["tenant0"]["version"] == svc.version("tenant0")
    assert qs["tenant0"]["n_colors"] == stats["tenant0"]["colors"]
    assert np.array_equal(qs["tenant0"]["colors"], svc.colors("tenant0"))
    svc.submit("tenant2", inserts=[[1, 5], [2, 8]])
    with jfaults.inject("service.step:p=1"):
        svc.step("tenant2")
        svc.step("tenant2")
    svc.heal("tenant2")
    assert qs["tenant2"]["healed"]
    assert qs["tenant2"]["version"] == svc.version("tenant2")
    assert np.array_equal(qs["tenant2"]["colors"], svc.colors("tenant2"))
    mesh = jax.make_mesh((1,), ("data",))
    svc.add_graph("sharded0", jgen.erdos_renyi(64, 5.0, seed=9), mesh=mesh)
    svc.submit("sharded0", inserts=[[0, 7], [5, 21]])
    svc.step("sharded0")
    assert qs["sharded0"]["n_shards"] == svc.snapshot("sharded0").n_shards
    assert qs["sharded0"]["version"] == svc.version("sharded0")
    assert np.array_equal(qs["sharded0"]["colors"], svc.colors("sharded0"))


def _lm_cfg_j(cfg_t):
    return JTF.TransformerConfig(**{
        f: getattr(cfg_t, f) for f in ("name", "n_layers", "d_model",
                                       "n_heads", "n_kv_heads", "head_dim",
                                       "d_ff", "vocab", "qk_norm", "dtype",
                                       "remat", "chunk_q", "chunk_k")})


def test_serve_lm_tokens_equal_the_reference():
    cfg_t = serve_lm.CFG
    cfg_j = _lm_cfg_j(cfg_t)
    pj = JTF.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = TTF.params_from_reference(
        cfg_t, jax.tree_util.tree_map(np.asarray, pj), "cpu")
    got = serve_lm.main(["--device", "cpu", "--requests", str(N_REQUESTS)],
                        params=pt)
    reqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for r in serve_lm.requests(cfg_t, N_REQUESTS)]
    JServeEngine(pj, cfg_j, batch=4, max_len=128).run(reqs)
    want = [list(map(int, r.out_tokens)) for r in reqs]
    assert got["out_tokens"] == want
    assert got["tokens"] == sum(len(t) for t in want)


def test_train_lm_tiny_losses_equal_the_reference():
    steps = 2
    cfg_t, batch, seq = train_lm.config(tiny=True)
    cfg_j = _lm_cfg_j(cfg_t)
    pj = JTF.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = TTF.params_from_reference(
        cfg_t, jax.tree_util.tree_map(np.asarray, pj), "cpu",
        trainable=True)
    got = train_lm.main(["--device", "cpu", "--tiny", "--steps", str(steps),
                         "--log-every", "1"], params=pt)
    _, _, hist = JTL.run(
        lambda p, b: JTF.train_step_loss(p, cfg_j, b), pj,
        JTokenStream(batch=batch, seq_len=seq, vocab=cfg_j.vocab),
        JOpt(lr=3e-4, warmup_steps=20, total_steps=steps),
        JTL.TrainLoopConfig(total_steps=steps, microbatches=2,
                            ckpt_every=100, ckpt_dir=None, log_every=1),
        to_device=lambda b: jax.tree.map(jnp.asarray, b))
    assert [m["step"] for m in got["history"]] == [m["step"] for m in hist]
    np.testing.assert_allclose([m["loss"] for m in got["history"]],
                               [m["loss"] for m in hist], rtol=LOSS_RTOL)


def test_color_then_train_gnn_equals_the_reference():
    cfg_j = JG.GatedGCNConfig(n_layers=4, d_hidden=32, d_in=16, d_out=4)
    pj = JG.gatedgcn_init(jax.random.PRNGKey(0), cfg_j)
    pt = TG.params_from_reference(
        "gatedgcn", jax.tree_util.tree_map(np.asarray, pj), "cpu")
    got = color_then_train_gnn.main(
        ["--device", "cpu", "--side", str(GNN_SIDE), "--steps",
         str(GNN_STEPS)], params=pt)
    g = jgen.mesh2d(GNN_SIDE, GNN_SIDE)
    res = japi.color(g, algorithm="rsoc", seed=0)
    assert np.array_equal(got["colors"], res.colors)
    assert (got["n_colors"], got["n_rounds"], got["gather_passes"]) == (
        res.n_colors, res.n_rounds, res.gather_passes)
    # the reference script's jitted step, on its library
    stream = JFullGraphStream(g, d_feat=16, n_classes=4, pad_edges_to=1024)
    ocfg = JOpt(lr=1e-3, warmup_steps=5, total_steps=GNN_STEPS)
    N = g.n_vertices + 1

    @jax.jit
    def step(params, opt, batch):
        def loss_fn(p):
            out = JG.gatedgcn_apply(p, cfg_j, batch["feats"], batch["src"],
                                    batch["dst"], N)
            return JG.node_classification_loss(out, batch["labels"],
                                               batch["train_mask"])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = j_adamw(ocfg, params, grads, opt)
        return params, opt, loss

    opt, want = j_init_opt(pj), {}
    for i in range(GNN_STEPS):
        pj, opt, loss = step(pj, opt, jax.tree.map(jnp.asarray,
                                                   next(stream)))
        if i % 10 == 0:
            want[i] = float(loss)
    assert sorted(got["losses"]) == sorted(want)
    np.testing.assert_allclose([got["losses"][i] for i in sorted(want)],
                               [want[i] for i in sorted(want)],
                               rtol=LOSS_RTOL)
    assert got["deterministic"]
