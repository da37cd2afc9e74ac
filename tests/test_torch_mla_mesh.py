"""Port vs reference: MLA on the model mesh (``minicpm3-4b``'s smoke
config, float32, CPU meshes).

* The prefill and decode cells (``repro_torch.launch.cells.build_cell``)
  against the reference's ``prefill`` / ``decode_step`` under a 1 x 1 mesh
  (its sharding constraints need one), the reference's
  ``init_params(PRNGKey(0))`` carried across by ``params_from_reference``,
  inputs from ``np.random.default_rng``: logits and the latent caches
  (``c_kv`` / ``k_rope``, assembled from their blocks) within ``TOL``
  (1e-4: float32 in another order — the gathered latent projections, the
  sequence blocks' softmax statistics merged by log-sum-exp and their
  ``o_c`` summed; measured about 1e-6).  Meshes
  (1, 2), (2, 2) and (1, 3): at ``model`` 3 ``w_uq``'s 48 columns split
  and cut the 4 heads, so every position computes every head from the
  gathered weights.  Decode with write-then-attend on (the cache's
  sequence over ``model``) and off (the step's own latent one more block
  of the merge), at a batch of 4 and of 1, which on (2, 2) is below the
  data axis (the sequence then over every axis).
* The train cell with no knob (1, 2), ``fsdp_inner`` (2, 2) and
  ``act_shard`` (1, 3), against the reference's ``_lm_train_cell`` step
  (``jax.jit``'d): loss, ``grad_norm``, every new parameter and
  moment leaf within rtol 1e-4 and atol 1e-4 of the leaf's largest
  magnitude, as ``tests/test_torch_train_mesh.py`` holds the GQA ones.
* ``models.mla.mla_attend_decode(seq_axis=)`` on ``Sharded`` latent blocks
  against the reference's unsharded function (write-then-attend and
  append).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import cells as JC
from repro.models import mla as JMLA
from repro.models import transformer as JTF
from repro.training import optimizer as JOPT
from repro_torch import configs as tconfigs
from repro_torch import tree as TT
from repro_torch.core import mesh as TM
from repro_torch.launch import cells as TC
from repro_torch.launch import sharding as TSH
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics

torch.set_num_threads(1)

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-4, atol=1e-4)
ONE_BY_ONE = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
MESHES = ((1, 2), (2, 2), (1, 3))
LQ, S = 12, 24


def _ids(shape):
    return "x".join(map(str, shape))


def _mesh(shape):
    return TM.make_mesh(shape, ("data", "model"), device="cpu")


def _cfgs(**knobs):
    return (dataclasses.replace(jconfigs.get(ARCH).make_smoke(), **knobs),
            dataclasses.replace(tconfigs.get(ARCH).make_smoke(), **knobs))


@functools.lru_cache(maxsize=None)
def _weights():
    cj, ct = _cfgs()
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return pj, jax.tree_util.tree_map(np.asarray, pj)


def _port_weights():
    _, ct = _cfgs()
    return TTF.params_from_reference(ct, _weights()[1], "cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@functools.lru_cache(maxsize=None)
def _reference_prefill(B):
    cj, _ = _cfgs()
    toks = np.random.default_rng(1).integers(1, cj.vocab, (B, LQ)).astype(
        np.int32)
    with ONE_BY_ONE:
        out = jax.jit(lambda p, t: JTF.prefill(p, cj, t))(
            _weights()[0], jnp.asarray(toks))
    return toks, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_prefill_cell_equals_the_reference(shape):
    toks, (lj, cj) = _reference_prefill(4)
    mesh = _mesh(shape)
    cell = TC.build_cell(ARCH, "prefill_32k", mesh, batch=4, seq_len=LQ,
                         smoke=True, params=_port_weights(),
                         inputs={"tokens": torch.from_numpy(toks)})
    metrics.reset()
    logits, cache = cell.run()
    assert TM.collectives() > 0
    _close(logits, lj, "logits")
    want = TSH.lm_cache_spec(mesh, "mla", 4, 4)
    for k in ("c_kv", "k_rope"):
        assert tuple(cache.specs[f"['{k}']"]) == tuple(TSH.sanitize_spec(
            want[k], cj[k].shape, mesh))
        _close(cache.gather(f"['{k}']"), cj[k], k)
    # a shard holds its block of the sequence (dim 2) where it divides
    m = shape[1]
    assert cache.shards[0]["c_kv"].shape[2] == (LQ // m if LQ % m == 0
                                                else LQ)


def _decode_inputs(cfg, B):
    rng = np.random.default_rng(5)
    m = cfg.mla
    cache = {"c_kv": rng.standard_normal((cfg.n_layers, B, S,
                                          m.kv_lora_rank)),
             "k_rope": rng.standard_normal((cfg.n_layers, B, S,
                                            m.qk_rope_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    # a slot mid-cache, an empty cache, the last slot, one more
    length = np.array([5, 0, S - 1, 17][:B], np.int32)
    token = rng.integers(1, cfg.vocab, (B,)).astype(np.int32)
    return cache, length, token


@functools.lru_cache(maxsize=None)
def _reference_decode(knobs, B):
    cj, _ = _cfgs(**dict(knobs))
    cache, length, token = _decode_inputs(cj, B)
    with ONE_BY_ONE:
        out = jax.jit(lambda p, t, c, n: JTF.decode_step(p, cj, t, c, n))(
            _weights()[0], jnp.asarray(token),
            {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(length))
    return jax.tree_util.tree_map(np.asarray, out)


DECODE_KNOBS = {"write_then_attend": (("decode_write_then_attend", True),
                                      ("decode_seq_axis", "model")),
                "append": (("decode_write_then_attend", False),)}
DECODE_CASES = ([(s, k, 4) for s in MESHES for k in DECODE_KNOBS]
                + [((2, 2), k, 1) for k in DECODE_KNOBS])


@pytest.mark.parametrize("shape,knob,B", DECODE_CASES, ids=[
    f"{_ids(s)}-{k}-B{b}" for s, k, b in DECODE_CASES])
def test_decode_cell_equals_the_reference(shape, knob, B):
    knobs = DECODE_KNOBS[knob]
    cj, _ = _cfgs(**dict(knobs))
    cache, length, token = _decode_inputs(cj, B)
    mesh = _mesh(shape)
    cell = TC.build_cell(
        ARCH, "decode_32k", mesh, dict(knobs), batch=B, seq_len=S,
        smoke=True, params=_port_weights(),
        inputs={"cache": {k: torch.from_numpy(v.copy())
                          for k, v in cache.items()},
                "length": torch.from_numpy(length),
                "token": torch.from_numpy(token)})
    pc = cell.args[2]
    seq = pc.split("['c_kv']", 2)
    assert seq == (("model",) if B >= shape[0] and S % shape[1] == 0
                   else ("data", "model") if B < shape[0] else ())
    logits, pc = cell.run()
    lj, cjc = _reference_decode(knobs, B)
    _close(logits, lj, "logits")
    for k in ("c_kv", "k_rope"):
        _close(pc.gather(f"['{k}']"), cjc[k], k)


# (mesh, knobs, microbatches)
TRAIN_CASES = [((1, 2), (), 1),
               ((2, 2), (("fsdp_inner", True),), 1),
               ((1, 3), (("act_shard", True),), 1)]
B_TRAIN, L_TRAIN = 4, 24


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _train_batch(cfg):
    rng = np.random.default_rng(1)
    return {k: rng.integers(1, cfg.vocab, (B_TRAIN, L_TRAIN)).astype(
        np.int32) for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _reference_train(knobs, microbatches):
    cj, _ = _cfgs(**dict(knobs))
    pj = _weights()[0]
    batch = {k: jnp.asarray(v) for k, v in _train_batch(cj).items()}
    with ONE_BY_ONE:
        cell = JC._lm_train_cell(ARCH, {"batch": B_TRAIN,
                                        "seq_len": L_TRAIN},
                                 ONE_BY_ONE, cj, microbatches=microbatches)
        p, o, m = jax.jit(cell.step)(pj, JOPT.init_opt_state(pj), batch)
    return ({k: float(v) for k, v in m.items()}, _by_path(p),
            _by_path(o["mu"]), _by_path(o["nu"]))


@pytest.mark.parametrize("shape,knobs,microbatches", TRAIN_CASES, ids=[
    f"{_ids(s)}-{'+'.join(n for n, _ in k) or 'plain'}-mb{m}"
    for s, k, m in TRAIN_CASES])
def test_train_cell_equals_the_reference(shape, knobs, microbatches):
    cj, _ = _cfgs(**dict(knobs))
    mesh = _mesh(shape)
    cell = TC.build_cell(
        ARCH, "train_4k", mesh, dict(knobs, microbatches=microbatches),
        batch=B_TRAIN, seq_len=L_TRAIN, smoke=True,
        params=_port_weights(),
        inputs={k: torch.from_numpy(v) for k, v in _train_batch(cj).items()})
    metrics.reset()
    _, state, m = cell.run()
    assert TM.collectives() > 0
    want, wp, wmu, wnu = _reference_train(knobs, microbatches)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    for tree, ref in ((cell.args[0], wp), (state["mu"], wmu),
                      (state["nu"], wnu)):
        for path, w in ref.items():
            np.testing.assert_allclose(
                tree.gather(path).detach().numpy(), w, rtol=1e-4,
                atol=1e-4 * max(float(np.abs(w).max()), 1e-30),
                err_msg=path)


@pytest.mark.parametrize("prewritten", [True, False],
                         ids=["write_then_attend", "append"])
def test_sharded_attend_decode_equals_the_reference(prewritten):
    """Latent blocks over a (2, 2) mesh's two axes (4 blocks of 6 slots):
    every position's output equals the reference's unsharded decode, after
    two collectives (the softmax statistics' gather, the ``o_c`` psum)."""
    cj, ct = _cfgs()
    rng = np.random.default_rng(7)
    B, d = 3, cj.d_model
    layer = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                   _weights()[1]["layers"]["attn"])
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    c = rng.standard_normal((B, S, cj.mla.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, cj.mla.qk_rope_dim)).astype(np.float32)
    length = np.array([5, 1, S if prewritten else S - 1], np.int32)
    pos = np.minimum(length, S - 1)[:, None].astype(np.int32)
    mesh = _mesh((2, 2))
    n = S // mesh.size

    def blocks(a):
        return TM.Sharded(mesh, tuple(torch.from_numpy(
            a[:, i * n:(i + 1) * n].copy()) for i in range(mesh.size)))

    metrics.reset()
    out, new = TMLA.mla_attend_decode(
        TT.tree_map(lambda a: torch.from_numpy(np.array(a)), layer), ct.mla, torch.from_numpy(x),
        torch.from_numpy(pos), (blocks(c), blocks(kr)),
        torch.from_numpy(length), prewritten=prewritten,
        seq_axis="data,model")
    assert TM.collectives() == 2
    out_j, new_j = jax.jit(lambda p, x, q, c, k, n: JMLA.mla_attend_decode(
        p, cj.mla, x, q, (c, k), n, prewritten=prewritten))(
        layer, x, pos, c, kr, length)
    for b in out.blocks:
        _close(b, out_j, "out")
    if prewritten:
        assert new == (None, None)
    else:
        for got, want in zip(new, new_j, strict=True):
            for b in got.blocks:
                _close(b, want, "new latents")
