"""Port vs reference: LM training (``repro_torch.models.layers`` /
``models.transformer`` / ``launch.train`` against ``repro.models`` /
``repro.launch.train``).

The reference's weights are carried into the port by
``params_from_reference``; both packages then run the same numpy inputs.
The reference's functions are ``jax.jit``'d.  Tolerances (float32):

* ``cross_entropy``: 1e-6 relative (one ``logsumexp`` in another order);
* ``chunked_attention`` with ``flash_bwd`` off and on, against the
  reference's with the same flag: outputs 1e-5, gradients of
  ``(o ** 2).sum()`` 2e-4 (absolute, as the reference's own
  ``tests/test_perf_variants.py`` holds its two backwards);
* ``train_step_loss`` of the LM smoke configs — the two qwen3s with
  ``flash_bwd`` and ``remat`` each on and off, the MLA / MoE ones with
  both off and both on — the loss (the MoE aux loss included) 1e-5
  relative, each leaf's gradient within 1e-4 of that leaf's largest
  reference gradient (measured about 1.3e-6: XLA's and PyTorch's products
  and sums in another order; MoE routing is a discrete choice, equal in
  both packages here);
* one AdamW step on bfloat16 leaves: bit for bit (the gradient norm under
  ``clip_norm``, so the clipping scale is exactly 1: the global norm is a
  reduction whose order differs between XLA and PyTorch, which
  ``test_torch_training.py`` holds to its float32 tolerance).

A training restart is bit for bit, and a checkpoint crosses the packages
in both directions to the same next-step loss (1e-5 relative).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as JDP
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.training import checkpoint as JCK
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.data import pipeline as TDP
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics as obs_metrics
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train_loop as TTL

torch.set_num_threads(1)

LM_ARCHS = ("qwen3-1.7b", "qwen3-32b", "minicpm3-4b",
            "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b")
MOE_MLA_ARCHS = LM_ARCHS[2:]
# (arch, flash_bwd, remat): every pair for the qwen3s; both off and both on
# for the MLA / MoE archs (MLA's head dim 12 takes the flash backward too)
TRAIN_CASES = [(a, f, r) for a in LM_ARCHS[:2] for f in (False, True)
               for r in (False, True)] + [
    (a, f, f) for a in MOE_MLA_ARCHS for f in (False, True)]
SEQ = 128            # two 64-token tiles of the smoke configs' chunks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# cross entropy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_equals_the_reference(ignore):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 17, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    if ignore:
        labels[rng.random((3, 17)) < 0.3] = -1
    want = float(jax.jit(JL.cross_entropy)(jnp.asarray(logits),
                                           jnp.asarray(labels)))
    got = TL.cross_entropy(_t(logits), _t(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bfloat16 logits are taken in float32, every label ignored gives 0
    got16 = TL.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels))
    want16 = JL.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                              jnp.asarray(labels))
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)
    none = np.full_like(labels, -1)
    assert float(TL.cross_entropy(_t(logits), _t(none))) == 0.0


# --------------------------------------------------------------------------
# chunked attention, its flash backward
# --------------------------------------------------------------------------

_j_chunked = jax.jit(JL.chunked_attention,
                     static_argnames=("causal", "q_offset", "chunk_q",
                                      "chunk_k", "flash_bwd"))


@functools.partial(jax.jit, static_argnames=("causal", "q_offset", "flash"))
def _j_grads(q, k, v, causal, q_offset, flash):
    return jax.grad(lambda q, k, v: (JL.chunked_attention(
        q, k, v, causal=causal, q_offset=q_offset, chunk_q=32, chunk_k=32,
        flash_bwd=flash) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)


# (B, Hq, Hkv, Lq, Lk, causal): the reference's two flash-backward tests,
# GQA, and a shape whose tiles do not divide (the custom path is not taken)
ATTN_CASES = [(2, 4, 4, 128, 128, True), (2, 4, 4, 128, 128, False),
              (1, 2, 2, 32, 128, True), (1, 4, 2, 64, 96, True),
              (1, 2, 1, 100, 100, True)]


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,causal", ATTN_CASES)
def test_chunked_attention_and_its_backward_equal_the_reference(
        flash, B, Hq, Hkv, Lq, Lk, causal, monkeypatch):
    rng = np.random.default_rng(Lq + Lk + Hkv)
    D = 16
    q = rng.standard_normal((B, Hq, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
    off = Lk - Lq
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(_j_chunked(jq, jk, jv, causal=causal, q_offset=off,
                                 chunk_q=32, chunk_k=32, flash_bwd=flash))
    want_g = _j_grads(jq, jk, jv, causal, off, flash)
    calls = []
    apply = TL.FlashAttention.apply
    monkeypatch.setattr(TL.FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = TL.chunked_attention(tq, tk, tv, causal=causal, q_offset=off,
                             chunk_q=32, chunk_k=32, flash_bwd=flash)
    # the reference's condition: tiles that divide Lq and Lk
    assert bool(calls) == (flash and Lq % 32 == 0 and Lk % 32 == 0)
    np.testing.assert_allclose(o.detach().numpy(), want, atol=1e-5)
    got_g = torch.autograd.grad((o ** 2).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   err_msg=f"d{name}")


def test_flash_backward_keeps_the_input_types():
    """bfloat16 in, bfloat16 gradients out; only (q, k, v, out, lse) are
    kept for the backward."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((1, 2, 64, 16)).astype(np.float32))
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        o = TL.chunked_attention(q, k, v, causal=True, chunk_q=32,
                                 chunk_k=32, flash_bwd=True)
    assert saved == [(1, 2, 64, 16)] * 4 + [(1, 2, 64)]
    gs = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(
        g.float()).all()) for g in gs)


# --------------------------------------------------------------------------
# train_step_loss and its gradients
# --------------------------------------------------------------------------

def _batch(vocab, batch=2, seq=SEQ, seed=0):
    return next(JDP.TokenStream(batch=batch, seq_len=seq, vocab=vocab,
                                seed=seed))


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, flash):
    cfg = dataclasses.replace(jconfigs.get(arch).make_smoke(),
                              flash_bwd=flash)
    pj = JTF.init_params(jax.random.PRNGKey(0), cfg)
    b = jax.tree.map(jnp.asarray, _batch(cfg.vocab))
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: JTF.train_step_loss(p, cfg, b)))(pj, b)
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return (jax.tree.map(np.asarray, pj), float(loss),
            [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat])


@pytest.mark.parametrize("arch,flash,remat", TRAIN_CASES)
def test_train_step_loss_and_gradients_equal_the_reference(arch, flash,
                                                           remat):
    tree, want_loss, want_g = _reference_loss_and_grads(arch, flash)
    cfg = dataclasses.replace(tconfigs.get(arch).make_smoke(),
                              flash_bwd=flash, remat=remat)
    pt = TTF.params_from_reference(cfg, tree, "cpu", trainable=True)
    b = {k: _t(v) for k, v in _batch(cfg.vocab).items()}
    loss = TTF.train_step_loss(pt, cfg, b)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = torch.autograd.grad(loss, T.leaves(pt))
    flat = T.flatten_with_paths(pt)
    # the reference's paths, order and (stacked) shapes
    assert [k for k, _ in flat] == [k for k, _ in want_g]
    for (path, w), g in zip(want_g, got):
        assert tuple(g.shape) == w.shape, path
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ("qwen3-1.7b",) + MOE_MLA_ARCHS)
def test_training_route_never_reaches_the_kernel(arch, monkeypatch):
    """``forward`` (training) takes ``chunked_attention`` and never
    ``prefill_attention``, the serving route that sends a CUDA tensor to
    the kernel; ``prefill`` takes that route once a layer."""
    cfg = tconfigs.get(arch).make_smoke()
    pt = TTF.init_params(torch.Generator().manual_seed(0), cfg,
                         trainable=True)
    toks = torch.randint(1, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    calls = []
    route = TL.prefill_attention
    monkeypatch.setattr(TL, "prefill_attention",
                        lambda *a, **kw: calls.append(1) or route(*a, **kw))
    obs_metrics.reset()
    logits, _ = TTF.forward(pt, cfg, toks)
    assert calls == [] and logits.requires_grad
    with torch.no_grad():
        TTF.prefill(pt, cfg, toks)
    assert len(calls) == cfg.n_layers
    assert obs_metrics.counters_matching("kernels.dispatch") == {}
    obs_metrics.reset()


@pytest.mark.parametrize("arch", ("qwen3-32b",) + MOE_MLA_ARCHS)
def test_params_cross_the_packages_both_ways(arch):
    """Every leaf (MoE's float32 router and nested ``shared`` experts,
    MLA's ``q_norm`` / ``kv_norm`` among them) crosses with its path, order,
    shape and values; the port's own init draws the same tree."""
    cfg_j = dataclasses.replace(jconfigs.get(arch).make_smoke(),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(tconfigs.get(arch).make_smoke(),
                                dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(2),
                                                    cfg_j))
    pt = TTF.params_from_reference(cfg_t, tree, "cpu")
    back = TTF.params_to_reference(pt)
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = T.flatten_with_paths(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == [
        k for k, _ in flat_b]
    for (p, w), (_, b) in zip(flat_w, flat_b):
        assert b.shape == w.shape
        np.testing.assert_array_equal(b.astype(w.dtype), w)
    own = T.flatten_with_paths(TTF.init_params(
        torch.Generator().manual_seed(0), cfg_t))
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in own] == [
        (k, tuple(v.shape), str(v.dtype)) for k, v in T.flatten_with_paths(pt)]
    with pytest.raises(ValueError, match="layers"):
        TTF.params_from_reference(dataclasses.replace(cfg_t, n_layers=3),
                                  tree)


# --------------------------------------------------------------------------
# the optimizer on bfloat16 leaves
# --------------------------------------------------------------------------

def test_adamw_step_on_bfloat16_leaves_is_bit_equal():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((64, 96)).astype(ml_dtypes.bfloat16),
              "s": rng.standard_normal((96,)).astype(ml_dtypes.bfloat16)}
    grads = {"w": (rng.standard_normal((64, 96)) * 1e-3).astype(np.float32),
             "s": (rng.standard_normal((96,)) * 1e-3).astype(np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jp, js, jm = jax.jit(lambda p, g, s: JOPT.adamw_update(
        JOPT.OptimizerConfig(**cfg), p, g, s))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        JOPT.init_opt_state(params))
    assert float(jm["grad_norm"]) < JOPT.OptimizerConfig().clip_norm
    tp = {k: _t(v.view(np.int16)).view(torch.bfloat16)
          for k, v in params.items()}
    tp, ts, _ = TOPT.adamw_update(TOPT.OptimizerConfig(**cfg), tp,
                                  {k: _t(v) for k, v in grads.items()},
                                  TOPT.init_opt_state(tp))
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[k].view(torch.int16).numpy(),
            np.asarray(jp[k]).view(np.int16), err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(ts[m][k].numpy(),
                                          np.asarray(js[m][k]))


# --------------------------------------------------------------------------
# restart and checkpoints (the reference's tests/test_system.py flow)
# --------------------------------------------------------------------------

TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=64, vocab=128, qk_norm=True, dtype="float32",
            remat=False, chunk_q=32, chunk_k=32)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _port_run(steps, ckpt_dir, tree, ckpt_every=4):
    cfg = TTF.TransformerConfig(**TINY)
    params = TTF.params_from_reference(cfg, tree, "cpu", trainable=True)
    stream = TDP.TokenStream(batch=4, seq_len=16, vocab=cfg.vocab, seed=0)
    lcfg = TTL.TrainLoopConfig(total_steps=steps, microbatches=2,
                               ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                               log_every=1)
    return TTL.run(lambda p, b: TTF.train_step_loss(p, cfg, b), params,
                   stream, TOPT.OptimizerConfig(**OPT), lcfg,
                   to_device=lambda b: tlaunch.to_device(b, "cpu"))


def _reference_run(steps, ckpt_dir, ckpt_every=4):
    cfg = JTF.TransformerConfig(**TINY)
    params = JTF.init_params(jax.random.PRNGKey(0), cfg)
    stream = JDP.TokenStream(batch=4, seq_len=16, vocab=cfg.vocab, seed=0)
    lcfg = JTL.TrainLoopConfig(total_steps=steps, microbatches=2,
                               ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                               log_every=1)
    return JTL.run(lambda p, b: JTF.train_step_loss(p, cfg, b), params,
                   stream, JOPT.OptimizerConfig(**OPT), lcfg,
                   to_device=lambda b: jax.tree.map(jnp.asarray, b))


def _tiny_tree():
    return jax.tree.map(np.asarray, JTF.init_params(
        jax.random.PRNGKey(0), JTF.TransformerConfig(**TINY)))


def test_lm_train_restart_is_bit_identical(tmp_path):
    """Kill-and-restart from LATEST reproduces the uninterrupted run:
    parameters, moments and the loss history, bit for bit."""
    tree = _tiny_tree()
    p_full, o_full, h_full = _port_run(8, str(tmp_path / "a"), tree)
    _, _, h_first = _port_run(4, str(tmp_path / "b"), tree)
    p_res, o_res, h_rest = _port_run(8, str(tmp_path / "b"), tree)
    assert [h["loss"] for h in h_first + h_rest] == [
        h["loss"] for h in h_full]
    for a, b in zip(T.leaves({"p": p_full, "o": o_full}),
                    T.leaves({"p": p_res, "o": o_res})):
        assert torch.equal(a, b)


def test_lm_checkpoint_crosses_the_packages(tmp_path):
    """A checkpoint the reference writes after 2 steps restores into the
    port, and one the port writes restores into the reference; either
    package's step 3 then gives the uninterrupted run's step-3 loss."""
    tree = _tiny_tree()
    _, _, want = _port_run(3, None, tree)
    _reference_run(2, str(tmp_path / "j"), ckpt_every=2)
    _, _, got = _port_run(3, str(tmp_path / "j"), tree, ckpt_every=2)
    assert got[0]["step"] == 3
    np.testing.assert_allclose(got[-1]["loss"], want[-1]["loss"], rtol=1e-5)
    _port_run(2, str(tmp_path / "t"), tree, ckpt_every=2)
    _, _, got_j = _reference_run(3, str(tmp_path / "t"), ckpt_every=2)
    assert got_j[0]["step"] == 3
    np.testing.assert_allclose(got_j[-1]["loss"], want[-1]["loss"],
                               rtol=1e-5)


def test_bfloat16_checkpoint_keeps_the_bits(tmp_path):
    """A bfloat16 leaf is stored as the raw 2-byte words the reference's
    ``np.savez`` writes, and restores bit for bit."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    tree = {"w": _t(w.view(np.int16)).view(torch.bfloat16),
            "s": torch.ones(3)}
    TCK.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as f:
        raw = f["['w']"]
    assert raw.dtype == np.dtype("V2")
    assert raw.tobytes() == w.tobytes()
    JCK.save(str(tmp_path / "j"), 1, {"w": jnp.asarray(w),
                                      "s": jnp.ones(3)})
    for d in (tmp_path, tmp_path / "j"):
        back, _, _ = TCK.restore(str(d), tree)
        assert torch.equal(back["w"], tree["w"])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launcher_trains_each_lm(arch, tmp_path, capsys):
    assert tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu",
                         "--seq-len", "32", "--batch", "2", "--ckpt-dir",
                         str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "device=cpu" in out
    assert open(tmp_path / "LATEST").read() == "step_00000003"


def test_build_lm_honours_full_batch_and_seq_len():
    arch = tconfigs.get("qwen3-1.7b")
    params, stream, _ = tlaunch.build_lm(arch, True, 3, 24, "cpu")
    b = next(stream)
    assert b["tokens"].shape == (3, 24) and b["labels"].shape == (3, 24)
    assert all(p.requires_grad for p in T.leaves(params))
    assert params.n_layers == arch.make_smoke().n_layers
    # smoke=False (the launcher's --full) builds make_full()'s config
    small = dataclasses.replace(arch.make_smoke(), name="full-stand-in",
                                n_layers=1)
    fake = dataclasses.replace(arch, make_full=lambda: small)
    full, _, _ = tlaunch.build_lm(fake, False, 1, 8, "cpu")
    assert full.n_layers == 1
