"""Port vs reference: the serving path on the ``qwen3-1.7b`` smoke config,
and on the smoke configs of the MLA / MoE archs (``minicpm3-4b``,
``phi3.5-moe-42b-a6.6b``, ``qwen2-moe-a2.7b``).

The reference's weights (``repro.models.transformer.init_params(PRNGKey)``)
are carried into the port by ``params_from_reference``; then ``forward``,
``prefill``, ``decode_step`` and ``ServeEngine`` of both packages run on the
same tokens.  The smoke config is float32 and runs on the CPU, where the
port's prefill attention is the plain ``chunked_attention`` (on a GPU it is
the attention kernel, held to its plain version by ``chip_smoke.py``).

Tolerance 1e-4 (absolute and relative) on logits and caches: the same
float32 arithmetic in another order (XLA's and PyTorch's matrix products
and reductions sum differently), through two layers, measured at about
1e-6 here.  Greedy tokens must be equal.  The MoE smoke configs route
without drops (capacity factor 8), so a token's route does not depend on
the batch it prefills or decodes in.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JTF
from repro.serving.serve_loop import Request as JRequest
from repro.serving.serve_loop import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CFG_J = jconfigs.get("qwen3-1.7b").make_smoke()
CFG_T = tconfigs.get("qwen3-1.7b").make_smoke()
# the served LM archs: qwen3-1.7b (GQA + qk-norm), MLA, the two MoEs
ARCHS = ("qwen3-1.7b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
         "qwen2-moe-a2.7b")


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    """(reference config, port config, jitted reference forward, prefill
    and decode_step) of ``arch``'s smoke config."""
    cj = jconfigs.get(arch).make_smoke()
    return (cj, tconfigs.get(arch).make_smoke(),
            jax.jit(lambda p, t: JTF.forward(p, cj, t)),
            jax.jit(lambda p, t: JTF.prefill(p, cj, t)),
            jax.jit(lambda p, t, c, l: JTF.decode_step(p, cj, t, c, l)))


def _params(seed, arch="qwen3-1.7b"):
    """(reference params, the same weights as port params)."""
    cfg_j, cfg_t = _smoke(arch)[:2]
    pj = JTF.init_params(jax.random.PRNGKey(seed), cfg_j)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, TTF.params_from_reference(cfg_t, tree, "cpu")


def _seq(cfg, buf):
    """``buf``'s (n_layers, B, ...) view with the sequence axis next:
    MLA's latents are (n_layers, B, S, r), GQA's K / V (n_layers, B, Hkv,
    S, Dh)."""
    return buf if cfg.attn_type == "mla" else buf.swapaxes(2, 3)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    ja, ta = jconfigs.get(arch), tconfigs.get(arch)
    for f in ("name", "family", "notes", "extras"):
        assert getattr(ja, f) == getattr(ta, f), f
    for make in ("make_full", "make_smoke"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        jf = [f.name for f in dataclasses.fields(jc)]
        assert jf == [f.name for f in dataclasses.fields(tc)], make
        for name in jf:
            a, b = getattr(jc, name), getattr(tc, name)
            if name in ("moe", "mla") and a is not None:
                # each package's own config class: field by field
                assert type(a).__name__ == type(b).__name__, (make, name)
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (make, name)
        if jc.moe is not None:
            assert jc.moe.e_pad == tc.moe.e_pad
        assert jc.n_params() == tc.n_params()
        assert jc.n_active_params() == tc.n_active_params()
        assert dataclasses.asdict(jc.attn_cfg()) == dataclasses.asdict(
            tc.attn_cfg())
    if arch == "qwen3-1.7b":
        assert ja.make_full().n_params() == 1_720_567_808
    for shapes in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert getattr(jconfigs, shapes) == getattr(tconfigs, shapes)


def test_unported_archs_and_settings_raise():
    """Every arch of the reference is in the registry and an unknown name
    raises.  The mesh's knobs are accepted and change no value on one
    device: the training ones (``act_shard``, ``fsdp_inner``; trained on a
    mesh in ``tests/test_torch_train_mesh.py``) and the serving ones
    (``tests/test_torch_sharding.py`` runs them on meshes)."""
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("no-such-arch")
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    assert not hasattr(tconfigs, "NOT_PORTED")
    base = CFG_T
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, base.vocab, (2, 9)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    p0 = TTF.init_params(torch.Generator().manual_seed(0), base)
    loss0 = TTF.train_step_loss(p0, base, batch)
    for knob in ("act_shard", "fsdp_inner"):
        cfg = dataclasses.replace(base, **{knob: True})
        p = TTF.init_params(torch.Generator().manual_seed(0), cfg)
        assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                     p0.parameters()))
        cache = TTF.make_empty_cache(cfg, 1, 8)
        assert cache["k"].shape == TTF.make_empty_cache(base, 1, 8)[
            "k"].shape and not cache["k"].any()
        assert torch.equal(TTF.train_step_loss(p, cfg, batch), loss0)
    moe = tconfigs.get("qwen2-moe-a2.7b").make_smoke().moe
    for change in (dict(moe=dataclasses.replace(
                       moe, ep_axes=("model", "data"))),
                   dict(wire_barrier=True), dict(decode_seq_axis="model"),
                   dict(decode_write_then_attend=True)):
        cfg = dataclasses.replace(base, **change)
        TTF.init_params(torch.Generator().manual_seed(0), cfg)
        assert TTF.make_empty_cache(cfg, 1, 8)["k"].shape[3] == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_match_the_reference(arch):
    cfg_j, cfg_t, j_forward, j_prefill, _ = _smoke(arch)
    pj, pt = _params(0, arch)
    toks = np.random.default_rng(0).integers(1, cfg_j.vocab, (2, 37)).astype(
        np.int32)
    lj, aux_j = j_forward(pj, jnp.asarray(toks))
    lt, aux_t = TTF.forward(pt, cfg_t, torch.from_numpy(toks))
    _close(lt, lj, "forward logits")
    if cfg_j.moe is None:
        assert float(aux_t) == float(aux_j) == 0.0
    else:       # the MoE layers' aux losses, summed over the layers
        assert float(aux_j) > 0
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    lj, cj = j_prefill(pj, jnp.asarray(toks))
    lt, ct = TTF.prefill(pt, cfg_t, torch.from_numpy(toks))
    _close(lt, lj, "prefill logits")
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape
        _close(ct[k], cj[k], f"prefill cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference(arch):
    cfg_j, cfg_t, _, j_prefill, j_decode = _smoke(arch)
    pj, pt = _params(1, arch)
    rng = np.random.default_rng(1)
    B, S, L0 = 3, 24, 9
    toks = rng.integers(1, cfg_j.vocab, (B, L0)).astype(np.int32)
    _, cj = j_prefill(pj, jnp.asarray(toks))
    _, ct = TTF.prefill(pt, cfg_t, torch.from_numpy(toks))
    cache_j = {k: _seq(cfg_j, _seq(cfg_j, v).at[:, :, :L0].set(
                   _seq(cfg_j, cj[k])))
               for k, v in JTF.make_empty_cache(cfg_j, B, S).items()}
    cache_t = TTF.make_empty_cache(cfg_t, B, S)
    for k in cache_t:
        _seq(cfg_t, cache_t[k])[:, :, :L0] = _seq(cfg_t, ct[k])
    length = np.array([L0, 4, S + 3], np.int32)   # the last one is clipped
    for step in range(3):
        tok = rng.integers(1, cfg_j.vocab, B).astype(np.int32)
        lj, cache_j = j_decode(pj, jnp.asarray(tok), cache_j,
                               jnp.asarray(length))
        lt, cache_t = TTF.decode_step(pt, cfg_t, torch.from_numpy(tok),
                                      cache_t, torch.from_numpy(length))
        _close(lt, lj, f"decode logits, step {step}")
        for k in cache_j:
            _close(cache_t[k], cache_j[k], f"decode cache {k}, step {step}")
        length = length + 1


def test_write_at_matches_the_reference():
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((3, 2, 5, 4)).astype(np.float32)
    val = rng.standard_normal((3, 2, 4)).astype(np.float32)
    length = np.array([0, 4, 9], np.int32)
    want = JTF._write_at(jnp.asarray(buf), jnp.asarray(val),
                         jnp.asarray(length), axis=2)
    got = TTF._write_at(torch.from_numpy(buf.copy()), torch.from_numpy(val),
                        torch.from_numpy(length), axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve_both(seed, batch, max_len, reqs, arch="qwen3-1.7b"):
    """Run the request set through both engines; returns both lists."""
    cfg_j, cfg_t, _, j_prefill, _ = _smoke(arch)
    pj, pt = _params(seed, arch)
    jr = [JRequest(prompt=p, max_new_tokens=m) for p, m in reqs]
    tr = [Request(prompt=p, max_new_tokens=m) for p, m in reqs]
    JServeEngine(pj, cfg_j, batch=batch, max_len=max_len).run(jr)
    ServeEngine(pt, cfg_t, batch=batch, max_len=max_len, device="cpu").run(tr)
    for p, _ in reqs:             # the same prefill logits, prompt by prompt
        lj, _ = j_prefill(pj, jnp.asarray(p, jnp.int32)[None])
        lt, _ = TTF.prefill(pt, cfg_t, torch.as_tensor(p, dtype=torch.int32)[
            None])
        _close(lt, lj, f"prefill logits of a {len(p)}-token prompt")
    return jr, tr


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_continuous_batching_matches_the_reference(arch):
    """The request set of tests/test_system.py's continuous-batching test:
    7 prompts of 5..11 tokens, 4-6 new tokens each, through 3 slots.  (An
    MLA prefill's latents go into their slot along the sequence axis: a
    cut along the latent axis gives other tokens from the first step.)"""
    rng = np.random.default_rng(0)
    vocab = _smoke(arch)[0].vocab
    reqs = [(rng.integers(1, vocab, 5 + i), 4 + (i % 3)) for i in range(7)]
    jr, tr = _serve_both(0, 3, 64, reqs, arch)
    for a, b in zip(jr, tr):
        assert b.done and len(b.out_tokens) == b.max_new_tokens
        assert b.out_tokens == a.out_tokens
        assert b.slot == a.slot


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_the_reference_and_a_forward_rollout(arch):
    """The request of tests/test_system.py's forward-oracle test: the engine's
    greedy tokens equal the reference engine's and an argmax rollout of the
    port's full forward pass."""
    prompt = np.asarray([3, 5, 7, 11, 13])
    jr, tr = _serve_both(1, 2, 64, [(prompt, 5)], arch)
    assert tr[0].out_tokens == jr[0].out_tokens
    _, pt = _params(1, arch)
    cfg_t = _smoke(arch)[1]
    toks = list(prompt)
    for _ in range(5):
        logits, _ = TTF.forward(pt, cfg_t, torch.tensor([toks],
                                                        dtype=torch.int32))
        toks.append(int(torch.argmax(logits[0, -1])))
    assert tr[0].out_tokens == toks[len(prompt):]


def test_engine_device_rule_and_sampling():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None would run there")
    _, pt = _params(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(pt, CFG_T, batch=1, max_len=16)
    # sampling: seeded, reproducible, in range
    outs = []
    for _ in range(2):
        eng = ServeEngine(pt, CFG_T, batch=2, max_len=32, greedy=False,
                          seed=3, device="cpu")
        reqs = [Request(prompt=np.array([1, 2, 3]), max_new_tokens=6)
                for _ in range(3)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < CFG_T.vocab for r in outs[0] for t in r)


def test_params_from_reference_bfloat16_and_layout():
    cfg_j = dataclasses.replace(CFG_J, dtype="bfloat16")
    cfg_t = dataclasses.replace(CFG_T, dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, JTF.init_params(jax.random.PRNGKey(5), cfg_j))
    pt = TTF.params_from_reference(cfg_t, tree, "cpu")
    # the layers stay stacked, as in the reference's tree; a layer is a view
    assert tuple(pt.layers["attn"]["wq"].shape) == (cfg_t.n_layers, 64, 64)
    wq = pt.layer_views()[1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == (64, 64)
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(tree["layers"]["attn"]["wq"][1], np.float32))
    n = sum(p.numel() for p in pt.parameters())
    # n_params() leaves out the qk-norm scales, as the reference's does
    assert n == cfg_t.n_params() + cfg_t.n_layers * 2 * cfg_t.head_dim
    # the port's own init draws the same shapes, types and count
    own = TTF.init_params(torch.Generator().manual_seed(0), cfg_t)
    assert {k: (v.shape, v.dtype) for k, v in own.named_parameters()} == {
        k: (v.shape, v.dtype) for k, v in pt.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_prefill_attention_routes_by_device():
    """On a CPU tensor the prefill attention is the plain chunked_attention
    (no dispatch through ops); a CUDA tensor would take ops.attention."""
    from repro_torch.obs import metrics as obs_metrics
    obs_metrics.reset()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 6, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 6, 16)).astype(
        np.float32))
    got = TL.prefill_attention(q, k, k, causal=True, chunk_q=64, chunk_k=64)
    want = TL.chunked_attention(q, k, k, causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert obs_metrics.counters_matching("kernels.dispatch") == {}
