"""Port vs reference: the serving path on the ``qwen3-1.7b`` smoke config.

The reference's weights (``repro.models.transformer.init_params(PRNGKey)``)
are carried into the port by ``params_from_reference``; then ``forward``,
``prefill``, ``decode_step`` and ``ServeEngine`` of both packages run on the
same tokens.  The smoke config is float32 and runs on the CPU, where the
port's prefill attention is the plain ``chunked_attention`` (on a GPU it is
the attention kernel, held to its plain version by ``chip_smoke.py``).

Tolerance 1e-4 (absolute and relative) on logits and caches: the same
float32 arithmetic in another order (XLA's and PyTorch's matrix products
and reductions sum differently), through two layers, measured at about
1e-6 here.  Greedy tokens must be equal.
"""
import dataclasses

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

_j_forward = jax.jit(lambda p, t: JTF.forward(p, CFG_J, t))
_j_prefill = jax.jit(lambda p, t: JTF.prefill(p, CFG_J, t))
_j_decode = jax.jit(lambda p, t, c, l: JTF.decode_step(p, CFG_J, t, c, l))


def _params(seed):
    """(reference params, the same weights as port params)."""
    pj = JTF.init_params(jax.random.PRNGKey(seed), CFG_J)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, TTF.params_from_reference(CFG_T, tree, "cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def test_configs_equal_the_reference_field_by_field():
    ja, ta = jconfigs.get("qwen3-1.7b"), tconfigs.get("qwen3-1.7b")
    for f in ("name", "family", "notes", "extras"):
        assert getattr(ja, f) == getattr(ta, f), f
    for make in ("make_full", "make_smoke"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        jf = [f.name for f in dataclasses.fields(jc)]
        assert jf == [f.name for f in dataclasses.fields(tc)], make
        for name in jf:
            assert getattr(jc, name) == getattr(tc, name), (make, name)
        assert jc.n_params() == tc.n_params()
        assert dataclasses.asdict(jc.attn_cfg()) == dataclasses.asdict(
            tc.attn_cfg())
    assert ja.make_full().n_params() == 1_720_567_808
    for shapes in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert getattr(jconfigs, shapes) == getattr(tconfigs, shapes)


def test_unported_archs_and_settings_raise():
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get("minicpm3-4b")
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get("qwen2-moe-a2.7b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("no-such-arch")
    assert set(tconfigs.NOT_PORTED) | set(tconfigs.ARCHS) == set(
        jconfigs.ARCHS)
    base = CFG_T
    # MLA and MoE name their ROADMAP item; the mesh knobs have no
    # counterpart in the single-device port
    for change, why in ((dict(attn_type="mla"), "ROADMAP"),
                        (dict(moe=object()), "ROADMAP"),
                        (dict(wire_barrier=True), "not ported"),
                        (dict(act_shard=True), "not ported"),
                        (dict(fsdp_inner=True), "not ported"),
                        (dict(decode_seq_axis="model"), "not ported"),
                        (dict(decode_write_then_attend=True), "not ported")):
        cfg = dataclasses.replace(base, **change)
        with pytest.raises(NotImplementedError, match=why):
            TTF.init_params(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(NotImplementedError, match=why):
            TTF.make_empty_cache(cfg, 1, 8)


def test_forward_prefill_match_the_reference():
    pj, pt = _params(0)
    toks = np.random.default_rng(0).integers(1, CFG_J.vocab, (2, 37)).astype(
        np.int32)
    lj, aux_j = _j_forward(pj, jnp.asarray(toks))
    lt, aux_t = TTF.forward(pt, CFG_T, torch.from_numpy(toks))
    _close(lt, lj, "forward logits")
    assert float(aux_t) == float(aux_j) == 0.0
    lj, cj = _j_prefill(pj, jnp.asarray(toks))
    lt, ct = TTF.prefill(pt, CFG_T, torch.from_numpy(toks))
    _close(lt, lj, "prefill logits")
    for k in ("k", "v"):
        assert tuple(ct[k].shape) == cj[k].shape
        _close(ct[k], cj[k], f"prefill cache {k}")


def test_decode_step_matches_the_reference():
    pj, pt = _params(1)
    rng = np.random.default_rng(1)
    B, S, L0 = 3, 24, 9
    toks = rng.integers(1, CFG_J.vocab, (B, L0)).astype(np.int32)
    _, cj = _j_prefill(pj, jnp.asarray(toks))
    _, ct = TTF.prefill(pt, CFG_T, torch.from_numpy(toks))
    cache_j = {k: v.at[:, :, :, :L0].set(cj[k])
               for k, v in JTF.make_empty_cache(CFG_J, B, S).items()}
    cache_t = TTF.make_empty_cache(CFG_T, B, S)
    for k in cache_t:
        cache_t[k][:, :, :, :L0] = ct[k]
    length = np.array([L0, 4, S + 3], np.int32)   # the last one is clipped
    for step in range(3):
        tok = rng.integers(1, CFG_J.vocab, B).astype(np.int32)
        lj, cache_j = _j_decode(pj, jnp.asarray(tok), cache_j,
                                jnp.asarray(length))
        lt, cache_t = TTF.decode_step(pt, CFG_T, torch.from_numpy(tok),
                                      cache_t, torch.from_numpy(length))
        _close(lt, lj, f"decode logits, step {step}")
        for k in ("k", "v"):
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


def _serve_both(seed, batch, max_len, reqs):
    """Run the request set through both engines; returns both lists."""
    pj, pt = _params(seed)
    jr = [JRequest(prompt=p, max_new_tokens=m) for p, m in reqs]
    tr = [Request(prompt=p, max_new_tokens=m) for p, m in reqs]
    JServeEngine(pj, CFG_J, batch=batch, max_len=max_len).run(jr)
    ServeEngine(pt, CFG_T, batch=batch, max_len=max_len, device="cpu").run(tr)
    for p, _ in reqs:             # the same prefill logits, prompt by prompt
        lj, _ = _j_prefill(pj, jnp.asarray(p, jnp.int32)[None])
        lt, _ = TTF.prefill(pt, CFG_T, torch.as_tensor(p, dtype=torch.int32)[
            None])
        _close(lt, lj, f"prefill logits of a {len(p)}-token prompt")
    return jr, tr


def test_serving_continuous_batching_matches_the_reference():
    """The request set of tests/test_system.py's continuous-batching test:
    7 prompts of 5..11 tokens, 4-6 new tokens each, through 3 slots."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, CFG_J.vocab, 5 + i), 4 + (i % 3))
            for i in range(7)]
    jr, tr = _serve_both(0, 3, 64, reqs)
    for a, b in zip(jr, tr):
        assert b.done and len(b.out_tokens) == b.max_new_tokens
        assert b.out_tokens == a.out_tokens
        assert b.slot == a.slot


def test_serving_matches_the_reference_and_a_forward_rollout():
    """The request of tests/test_system.py's forward-oracle test: the engine's
    greedy tokens equal the reference engine's and an argmax rollout of the
    port's full forward pass."""
    prompt = np.asarray([3, 5, 7, 11, 13])
    jr, tr = _serve_both(1, 2, 64, [(prompt, 5)])
    assert tr[0].out_tokens == jr[0].out_tokens
    _, pt = _params(1)
    toks = list(prompt)
    for _ in range(5):
        logits, _ = TTF.forward(pt, CFG_T, torch.tensor([toks],
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


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--requests", "3",
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
