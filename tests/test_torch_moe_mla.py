"""Port vs reference: MoE and MLA (``repro_torch.models.moe`` / ``.mla``
against ``repro.models.moe`` / ``.mla``), and the three LM smoke configs
that use them.

The reference's weights are carried into the port as numpy arrays; both
packages then run the same numpy inputs, the reference ``jax.jit``'d.
Tolerances (float32 on the CPU):

* ``moe_apply``: the output within 1e-5 (absolute and relative), the aux
  loss 1e-6 relative; gradients within 1e-5 of each leaf's largest
  reference gradient (XLA's and PyTorch's products in another order,
  measured about 1e-7);
* routing (``eidx``, ``pos``, ``keep``) equal as integers, ties included:
  the reference's values are read where it computes them (its two
  ``jnp.where(keep, ...)`` calls, the dispatch's indices, watched while
  it traces);
* MLA's latents and attention outputs within 1e-5;
* prefill / decode consistency of the port with itself: 2e-2, as the
  reference's own ``tests/test_models_smoke.py`` holds it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEW_ARCHS = ("minicpm3-4b", "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(np.asarray(tree))


def _port_moe_cfg(cfg_j):
    return TMOE.MoEConfig(**dataclasses.asdict(cfg_j))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _smoke_moe(arch):
    c = jconfigs.get(arch).make_smoke()
    return c.d_model, c.moe


# (name, d, reference MoEConfig, tokens): both smoke configs (qwen2-moe's
# pads 6 experts to 8 and has shared experts), qwen2-moe's smoke MoE at
# GShard's 1.25 (drops, padded), and tests/test_models_smoke.py's case at
# capacity 10.0 and 0.01 (nearly every pair dropped)
MOE_CASES = [
    ("phi3.5-moe smoke", *_smoke_moe("phi3.5-moe-42b-a6.6b"), 64),
    ("qwen2-moe smoke", *_smoke_moe("qwen2-moe-a2.7b"), 64),
    ("qwen2-moe smoke cap 1.25", _smoke_moe("qwen2-moe-a2.7b")[0],
     dataclasses.replace(_smoke_moe("qwen2-moe-a2.7b")[1],
                         capacity_factor=1.25), 96),
    ("mass conservation cap 10", 32,
     JMOE.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                    capacity_factor=10.0), 64),
    ("mass conservation cap 0.01", 32,
     JMOE.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                    capacity_factor=0.01), 64),
]


def _reference_routing(params, cfg, x):
    """(out, aux, eidx, pos, keep) of the reference's ``moe_apply``,
    jitted with ``jnp.where`` watched while it traces: its calls
    ``where(keep, eidx, 0)`` and ``where(keep, pos, 0)`` (the dispatch's
    indices) hand over the routing it computes, as extra outputs."""
    where = jnp.where

    def run(p, x):
        seen = []

        def watch(c, *a, **kw):
            if (len(a) == 2 and getattr(c, "dtype", None) == jnp.bool_
                    and np.shape(c) == np.shape(a[0]) and np.ndim(c) == 2):
                seen.append((c, a[0]))
            return where(c, *a, **kw)

        jnp.where = watch
        try:
            out, aux = JMOE.moe_apply(p, cfg, x)
        finally:
            jnp.where = where
        (keep, eidx), (keep2, pos) = seen
        return out, aux, eidx, pos, keep, keep2

    out, aux, eidx, pos, keep, keep2 = jax.jit(run)(params, x)
    assert (np.asarray(keep) == np.asarray(keep2)).all()
    return (np.asarray(out), float(aux), np.asarray(eidx), np.asarray(pos),
            np.asarray(keep))


def _moe_inputs(d, cfg, T, seed):
    pj = JMOE.moe_init(jax.random.PRNGKey(seed), d, cfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)
    return pj, x


@pytest.mark.parametrize("name,d,cfg,T", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_apply_and_routing_equal_the_reference(name, d, cfg, T):
    pj, x = _moe_inputs(d, cfg, T, seed=T + d)
    out_j, aux_j, eidx_j, pos_j, keep_j = _reference_routing(
        pj, cfg, jnp.asarray(x))
    cfg_t = _port_moe_cfg(cfg)
    pt = _tree_t(pj)
    probs, gate, eidx, pos, keep, cap = TMOE.moe_route(pt, cfg_t, _t(x))
    assert cap == max(1, int(cfg.capacity_factor * T * cfg.top_k
                             / cfg.n_experts))
    np.testing.assert_array_equal(eidx.numpy(), eidx_j)
    np.testing.assert_array_equal(pos.numpy(), pos_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    out, aux = TMOE.moe_apply(pt, cfg_t, _t(x))
    np.testing.assert_allclose(out.numpy(), out_j, err_msg=name, **TOL)
    np.testing.assert_allclose(float(aux), aux_j, rtol=1e-6)
    if cfg.e_pad > cfg.n_experts:      # padding experts take nothing
        assert float(probs[:, cfg.n_experts:].abs().max()) == 0.0
        assert int(eidx.max()) < cfg.n_experts
    if cfg.capacity_factor < 1:
        assert not keep.all()          # the drop case drops


def test_moe_top_k_ties_take_the_lower_expert_first():
    """A router whose columns repeat, on inputs whose products are exact:
    equal logits, equal probabilities, and ``jax.lax.top_k``'s order
    (the lower expert first), which the capacity rank depends on."""
    d, T = 16, 48
    cfg = JMOE.MoEConfig(n_experts=6, top_k=3, d_ff_expert=8,
                         capacity_factor=1.0)
    pj, _ = _moe_inputs(d, cfg, T, seed=4)
    rng = np.random.default_rng(4)
    half = rng.integers(-4, 5, (d, 3)).astype(np.float32) / 8
    router = np.repeat(half, 2, axis=1)            # columns 0=1, 2=3, 4=5
    pj = dict(pj, router=jnp.asarray(router))
    x = rng.integers(-2, 3, (T, d)).astype(np.float32)
    _, _, eidx_j, pos_j, keep_j = _reference_routing(pj, cfg, jnp.asarray(x))
    _, _, eidx, pos, keep, _ = TMOE.moe_route(_tree_t(pj),
                                              _port_moe_cfg(cfg), _t(x))
    np.testing.assert_array_equal(eidx.numpy(), eidx_j)
    np.testing.assert_array_equal(pos.numpy(), pos_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    # every token's first two choices are a tied pair, lower index first
    e = eidx.numpy()
    assert (e[:, 0] // 2 == e[:, 1] // 2).all() and (e[:, 0] < e[:, 1]).all()
    assert not keep.all()


@functools.partial(jax.jit, static_argnames=("cfg",))
def _j_moe_grads(params, x, w, cfg):
    def loss(p, x):
        out, aux = JMOE.moe_apply(p, cfg, x)
        return (out * w).sum() + aux
    return jax.grad(loss, argnums=(0, 1))(params, x)


@pytest.mark.parametrize("name,d,cfg,T", MOE_CASES[1:3],
                         ids=[c[0] for c in MOE_CASES[1:3]])
def test_moe_gradients_equal_the_reference(name, d, cfg, T):
    pj, x = _moe_inputs(d, cfg, T, seed=7)
    w = np.random.default_rng(8).standard_normal((T, d)).astype(np.float32)
    gp_j, gx_j = _j_moe_grads(pj, jnp.asarray(x), jnp.asarray(w), cfg)
    pt = _tree_t(pj)
    leaves = [("router",), ("w_gate",), ("w_up",), ("w_down",)]
    leaves += [("shared", k) for k in ("w_gate", "w_up", "w_down")]
    xt = _t(x).requires_grad_()
    tensors = [xt]
    for path in leaves:
        leaf = pt[path[0]] if len(path) == 1 else pt[path[0]][path[1]]
        tensors.append(leaf.requires_grad_())
    out, aux = TMOE.moe_apply(pt, _port_moe_cfg(cfg), xt)
    grads = torch.autograd.grad((out * _t(w)).sum() + aux, tensors)
    wants = [gx_j] + [gp_j[p[0]] if len(p) == 1 else gp_j[p[0]][p[1]]
                      for p in leaves]
    for path, g, want in zip([("x",)] + leaves, grads, wants):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=str(path))


def test_moe_mesh_knob_raises():
    cfg = dataclasses.replace(_port_moe_cfg(_smoke_moe(
        "phi3.5-moe-42b-a6.6b")[1]), ep_axes=("model", "data"))
    with pytest.raises(NotImplementedError, match="mesh knob"):
        TMOE.moe_init(torch.Generator().manual_seed(0), 64, cfg)
    tcfg = dataclasses.replace(
        tconfigs.get("phi3.5-moe-42b-a6.6b").make_smoke(), moe=cfg)
    with pytest.raises(NotImplementedError, match="mesh knob"):
        TTF.make_empty_cache(tcfg, 1, 8)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

MLA_SMOKE_J = jconfigs.get("minicpm3-4b").make_smoke().mla
MLA_SMOKE_T = TMLA.MLAConfig(**dataclasses.asdict(MLA_SMOKE_J))


def _mla_inputs(B, L, seed=0):
    pj = JMLA.mla_init(jax.random.PRNGKey(seed), MLA_SMOKE_J, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (B, L, MLA_SMOKE_J.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    return pj, x, pos


def test_rope_at_both_of_mla_shapes():
    """``k_rope`` is roped at (B, L, dr) with positions (B, L), ``q_rope``
    at (B, H, L, dr) with positions (B, 1, L)."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 900, (2, 7)).astype(np.int32)
    for shape, p in (((2, 7, 4), pos), ((2, 3, 7, 4), pos[:, None, :])):
        x = rng.standard_normal(shape).astype(np.float32)
        want = jax.jit(JL.rope)(jnp.asarray(x), jnp.asarray(p))
        np.testing.assert_allclose(TL.rope(_t(x), _t(p)).numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("training", [False, True])
def test_mla_latents_and_prefill_equal_the_reference(training):
    pj, x, pos = _mla_inputs(2, 37)
    pt = _tree_t(pj)
    lat_j = jax.jit(lambda p, x, q: JMLA.mla_latents(p, MLA_SMOKE_J, x, q))(
        pj, jnp.asarray(x), jnp.asarray(pos))
    lat_t = TMLA.mla_latents(pt, MLA_SMOKE_T, _t(x), _t(pos))
    for a, b in zip(lat_t, lat_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    out_j, (c_j, k_j) = jax.jit(lambda p, x, q: JMLA.mla_attend_prefill(
        p, MLA_SMOKE_J, x, q, chunk_q=16, chunk_k=16))(
        pj, jnp.asarray(x), jnp.asarray(pos))
    out_t, (c_t, k_t) = TMLA.mla_attend_prefill(
        pt, MLA_SMOKE_T, _t(x), _t(pos), chunk_q=16, chunk_k=16,
        training=training)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **TOL)


def _decode_inputs():
    B, S = 3, 20
    pj, x, _ = _mla_inputs(B, 1, seed=2)
    rng = np.random.default_rng(3)
    c = rng.standard_normal((B, S, MLA_SMOKE_J.kv_lora_rank)).astype(
        np.float32)
    kr = rng.standard_normal((B, S, MLA_SMOKE_J.qk_rope_dim)).astype(
        np.float32)
    length = np.array([5, 1, S], np.int32)
    pos = np.minimum(length, S - 1)[:, None].astype(np.int32)
    return pj, x, pos, c, kr, length


def test_mla_attend_decode_equals_the_reference():
    pj, x, pos, c, kr, length = _decode_inputs()
    jfn = jax.jit(lambda p, x, q, c, k, n: JMLA.mla_attend_decode(
        p, MLA_SMOKE_J, x, q, (c, k), n))
    out_j, new_j = jfn(pj, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(c),
                       jnp.asarray(kr), jnp.asarray(length))
    out_t, new_t = TMLA.mla_attend_decode(
        _tree_t(pj), MLA_SMOKE_T, _t(x), _t(pos), (_t(c), _t(kr)),
        _t(length))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("knob", [dict(prewritten=True),
                                  dict(seq_axis="model")])
def test_mla_attend_decode_refuses_the_mesh_knobs(knob):
    """The reference's write-then-attend and sequence-sharded decode are
    mesh schedules this single-device port does not have."""
    pj, x, pos, c, kr, length = _decode_inputs()
    with pytest.raises(NotImplementedError, match="mesh knob"):
        TMLA.mla_attend_decode(_tree_t(pj), MLA_SMOKE_T, _t(x), _t(pos),
                               (_t(c), _t(kr)), _t(length), **knob)


# --------------------------------------------------------------------------
# the smoke configs: prefill, then decode, against the full forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_prefill_decode_consistency(arch):
    """Greedy decode after prefill == the full forward's next-token logits
    (the reference's tests/test_models_smoke.py check, on the port)."""
    cfg = tconfigs.get(arch).make_smoke()
    params = TTF.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    B, L, S = 2, 16, 32
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, L)).astype(
        np.int32))
    with torch.no_grad():
        logits, cache = TTF.prefill(params, cfg, toks)
        full = TTF.make_empty_cache(cfg, B, S)
        for k, v in cache.items():
            if cfg.attn_type == "mla":
                full[k][:, :, :L] = v
            else:
                full[k][:, :, :, :L] = v
        nxt = torch.argmax(logits, -1).to(torch.int32)
        length = torch.full((B,), L, dtype=torch.int32)
        logits2, _ = TTF.decode_step(params, cfg, nxt, full, length)
        ext = torch.cat([toks, nxt[:, None]], dim=1)
        logits_full, _ = TTF.forward(params, cfg, ext)
    np.testing.assert_allclose(logits2.numpy(), logits_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# the attention kernel at MLA's head dims
# --------------------------------------------------------------------------

def test_attention_wrapper_admits_mla_head_dims_on_the_cpu():
    """D 96 (minicpm3-4b) and D 12 (its smoke config) pass the wrapper's
    checks and, on CPU tensors, give the plain version; the routing rule
    sends both to the fma design."""
    rng = np.random.default_rng(5)
    for D in (96, 12):
        q, k, v = (_t(rng.standard_normal((1, 4, 9, D)).astype(np.float32))
                   for _ in range(3))
        want = ref.flash_attention_ref(q, k, v, causal=True)
        np.testing.assert_array_equal(ops.attention(q, k, v).numpy(),
                                      want.numpy())
        assert FA.design(torch.bfloat16, D) == "fma"
    # D 12 is padded into new tensors before the layout check: any layout,
    # bfloat16's 24-byte rows and a strided view included
    q = q.to(torch.bfloat16)
    assert ops.attention(q, q, q).shape == q.shape
    view = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        ops.attention(view, q, q).float().numpy(),
        ref.flash_attention_ref(q, q, q, causal=True).float().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_head_dims_launch_fma(cuda_device, dtype, D):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(D)
    for causal in (True, False):
        q, k, v = (_t(rng.standard_normal((2, 40, L, D)).astype(np.float32))
                   .to(cuda_device).to(dt) for L in (65, 70, 70))
        before = FA.flash_attention.launches_fma
        got = ops.attention(q, k, v, causal=causal)
        assert FA.flash_attention.launches_fma == before + 1
        assert got.shape == q.shape and got.is_contiguous()
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        tol = (dict(rtol=2e-5, atol=2e-5) if dt == torch.float32
               else dict(rtol=1e-2, atol=2e-2))
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
