"""Port vs reference: LM training on the model mesh.

* The train cell (``repro_torch.launch.cells.build_cell(arch, "train_4k",
  mesh, ...)``) against the reference's ``_lm_train_cell`` step under a
  1 x 1 mesh (its sharding constraints need one), with the same knobs, on
  the smoke configs (float32) cut to 4 x 24 tokens: the reference's
  ``init_params(PRNGKey(0))`` carried across by ``params_from_reference``,
  tokens and labels from ``np.random.default_rng(1)``.  Compared: loss,
  ``grad_norm``, ``lr``, every new parameter leaf and every ``mu`` / ``nu``
  leaf, each assembled from its blocks, within rtol 1e-4 and atol 1e-4
  times the leaf's largest magnitude: float32 in another order
  (tensor-parallel partial sums, the vocab-parallel log-sum-exp, the
  gradient's reduce-scatter), measured at about 1e-6.
* ``reshard``: the storage layout moved to the compute one equals the
  compute placement block for block; a storage block's gradient is the sum
  of the compute blocks' gradients that cover it.  ``psum_scatter``: each
  position's block of its group's sum, and an all-gather backward.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import cells as JC
from repro.models import transformer as JTF
from repro.training import optimizer as JOPT
from repro_torch import configs as tconfigs
from repro_torch import tree as TT
from repro_torch.core import mesh as TM
from repro_torch.launch import cells as TC
from repro_torch.launch import sharding as TSH
from repro_torch.models import spmd as TSPMD
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
B, L = 4, 24
ONE_BY_ONE = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
ALL = (("fsdp_inner", True), ("act_shard", True), ("remat", True))
# (arch, mesh, knobs, microbatches, steps)
CASES = [
    ("qwen3-1.7b", (2, 2), (), 1, 1),
    ("qwen3-1.7b", (2, 2), (("fsdp_inner", True),), 1, 1),
    ("qwen3-1.7b", (2, 2), (("act_shard", True),), 1, 1),
    ("qwen3-1.7b", (2, 2), ALL, 2, 2),
    # model 4 cuts the 2 K / V heads
    ("qwen3-1.7b", (1, 4), (("fsdp_inner", True),), 1, 1),
    # 6 query heads split over model 3, the 2 K / V heads not (C.4's)
    ("qwen3-32b", (1, 3), (), 1, 1),
    ("qwen3-32b", (2, 2), (("fsdp_inner", True), ("act_shard", True)), 1, 1),
    # experts over model, capacity over data; capacity 1.0 drops pairs
    ("qwen2-moe-a2.7b", (2, 2), (), 1, 1),
    ("qwen2-moe-a2.7b", (2, 2), ALL, 2, 1),
]


def _ids(case):
    arch, shape, knobs, m, steps = case
    k = "+".join(n for n, _ in knobs) or "plain"
    return f"{arch}-{shape[0]}x{shape[1]}-{k}-mb{m}-steps{steps}"


def _cfgs(arch, knobs):
    cj, ct = jconfigs.get(arch).make_smoke(), tconfigs.get(arch).make_smoke()
    if cj.moe is not None:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(
            cj.moe, ep_axes=("model", "data"), capacity_factor=1.0))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(
            ct.moe, ep_axes=("model", "data"), capacity_factor=1.0))
    return (dataclasses.replace(cj, **dict(knobs)),
            dataclasses.replace(ct, **dict(knobs)))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cj, ct = _cfgs(arch, ())
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return pj, jax.tree_util.tree_map(np.asarray, pj)


def _batch(cfg):
    rng = np.random.default_rng(1)
    return {k: rng.integers(1, cfg.vocab, (B, L)).astype(np.int32)
            for k in ("tokens", "labels")}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _reference(arch, knobs, microbatches, steps, opt=None):
    """The reference's train step under a 1 x 1 mesh, ``steps`` times, with
    its cells' ``OPT`` or ``opt``: (metrics a step, new params, mu, nu by
    path)."""
    cj, _ = _cfgs(arch, knobs)
    pj, _ = _weights(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cj).items()}
    with ONE_BY_ONE, mock.patch.object(JC, "OPT", opt or JC.OPT):
        cell = JC._lm_train_cell(arch, {"batch": B, "seq_len": L},
                                 ONE_BY_ONE, cj, microbatches=microbatches)
        step = jax.jit(cell.step)
        p, o, mets = pj, JOPT.init_opt_state(pj), []
        for _ in range(steps):
            p, o, m = step(p, o, batch)
            mets.append({k: float(v) for k, v in m.items()})
    return mets, _by_path(p), _by_path(o["mu"]), _by_path(o["nu"])


def _close(got, want, what):
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(float(np.abs(want).max()),
                                               1e-30), err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_cell_equals_the_reference(case, monkeypatch):
    _check_train_cell(case, monkeypatch)


# past warmup: lr 3e-4 at the first step (``OPT``'s is 3e-6, an update
# below the parameters' tolerance), so a step that does not reach the
# stored parameters fails the comparison
PAST_WARMUP = ("qwen3-1.7b", (2, 2), (("fsdp_inner", True),), 1, 2)


def test_train_cell_updates_the_stored_parameters(monkeypatch):
    opt = dataclasses.replace(JC.OPT, warmup_steps=1)
    monkeypatch.setattr(TC, "OPT", dataclasses.replace(
        TC.OPT, warmup_steps=1))
    _check_train_cell(PAST_WARMUP, monkeypatch, opt)
    arch, _, knobs, microbatches, steps = PAST_WARMUP
    old = _by_path(_weights(arch)[0])
    for path, w in _reference(arch, knobs, microbatches, steps,
                              opt)[1].items():
        assert not np.allclose(old[path], w, rtol=RTOL,
                               atol=ATOL * np.abs(w).max()), path


def _check_train_cell(case, monkeypatch, opt=None):
    arch, shape, knobs, microbatches, steps = case
    cj, ct = _cfgs(arch, knobs)
    over = dict(knobs, microbatches=microbatches)
    if ct.moe is not None:
        over.update(moe_ep=True, moe=ct.moe)
    pt = TTF.params_from_reference(ct, _weights(arch)[1], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cj).items()}
    mesh = TM.make_mesh(shape, ("data", "model"), device="cpu")
    cell = TC.build_cell(arch, "train_4k", mesh, over, batch=B, seq_len=L,
                         smoke=True, params=pt, inputs=batch)
    assert cell.kind == "train"
    assert cell.static_notes == ("batch cut from 256 to 4; seq_len cut from "
                                 "4096 to 24")
    for k in ("fsdp_inner", "act_shard", "remat"):
        assert getattr(cell.cfg, k) == dict(knobs).get(k, getattr(ct, k))
    params = cell.args[0]
    assert all(tuple(params.specs[p]) == tuple(TSH.sanitize_spec(
        TSH.lm_param_spec(p, x), x.shape, mesh))
        for p, x in TT.flatten_with_paths(pt))
    kept = []
    if ct.moe is not None:           # the routes' keep flags, to see drops
        moe = TSPMD._moe

        def watch(*a, **kw):
            outs, routes = moe(*a, **kw)
            kept.extend(bool(r[2].all()) for r in routes)
            return outs, routes
        monkeypatch.setattr(TSPMD, "_moe", watch)
    metrics.reset()
    mets = [cell.run()[2] for _ in range(steps)]
    assert TM.collectives() > 0
    if ct.moe is not None:
        assert kept and not all(kept)        # some pairs dropped
    want, wp, wmu, wnu = _reference(arch, knobs, microbatches, steps, opt)
    for got, ref in zip(mets, want, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[k]), ref[k], rtol=RTOL,
                                       err_msg=k)
    params, state = cell.args[0], cell.args[1]
    assert int(state["step"]) == steps
    old = _by_path(_weights(arch)[0])
    for path in wp:
        new = params.gather(path)
        _close(new, wp[path], path)
        # the update reached the stored blocks wherever the reference's
        # moved the leaf
        if not np.array_equal(old[path], wp[path]):
            assert not np.array_equal(new.detach().float().numpy(),
                                      old[path]), path
        _close(state["mu"].gather(path), wmu[path], "mu " + path)
        _close(state["nu"].gather(path), wnu[path], "nu " + path)
        assert state["mu"].gather(path).dtype == torch.float32
    # the weights handed in are not trained (the cell trains copies)
    np.testing.assert_array_equal(pt["embed"]["table"].numpy(),
                                  _weights(arch)[1]["embed"]["table"])


def test_forward_on_a_placed_tree_equals_the_reference():
    """``transformer.forward`` on the storage layout gathers the logits
    whole; they and the aux loss equal the reference's ``forward``."""
    arch = "qwen2-moe-a2.7b"
    knobs = (("act_shard", True),)
    cj, ct = _cfgs(arch, knobs)
    pj, tree = _weights(arch)
    toks = _batch(cj)["tokens"]
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = TSH.place(TTF.params_from_reference(ct, tree, "cpu"), mesh,
                       TSH.lm_param_spec)
    with torch.no_grad():
        logits, aux = TTF.forward(placed, ct, torch.from_numpy(toks))
    with ONE_BY_ONE:
        lj, aj = jax.jit(lambda p, t: JTF.forward(p, cj, t))(
            pj, jnp.asarray(toks))
    _close(logits, np.asarray(lj), "logits")
    np.testing.assert_allclose(float(aux), float(aj), rtol=RTOL)


# --------------------------------------------------------------------------
# reshard and psum_scatter
# --------------------------------------------------------------------------

def _moe_params():
    ct = _cfgs("qwen2-moe-a2.7b", ())[1]
    return TTF.params_from_reference(ct, _weights("qwen2-moe-a2.7b")[1],
                                     "cpu")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_reshard_equals_the_compute_placement(shape):
    params = _moe_params()
    mesh = TM.make_mesh(shape, ("data", "model"), device="cpu")
    storage = TSH.place(params, mesh, TSH.lm_param_spec)
    metrics.reset()
    got = TSH.reshard(storage, mesh, TSH.lm_param_spec_tp)
    want = TSH.place(params, mesh, TSH.lm_param_spec_tp)
    assert got.specs == want.specs and got.shapes == want.shapes
    for pos in range(mesh.size):
        for (p, g), (q, w) in zip(TT.flatten_with_paths(got.shards[pos]),
                                  TT.flatten_with_paths(want.shards[pos]),
                                  strict=True):
            assert p == q and torch.equal(g, w), (pos, p)
    # one gather a leaf whose storage split differs from its compute split
    # over axes of more than one position; none for the rest
    moved = 0
    for p, src in storage.specs.items():
        dst = want.specs[p]
        axes = set()
        for d in range(len(storage.shapes[p])):
            s_ax = TSH.entry_axes(src[d] if d < len(src) else None)
            if s_ax != TSH.entry_axes(dst[d] if d < len(dst) else None):
                axes |= set(s_ax)
        moved += int(np.prod([mesh.shape[a] for a in axes])) > 1
    assert TM.collectives() == moved > 0


def test_reshard_gradient_reaches_storage_as_the_group_sum():
    """A storage block's gradient is the sum of the gradients of the
    compute blocks that cover it: the reduce-scatter back to storage (a
    replicated block sums every position's)."""
    params = _moe_params()
    mesh = TM.make_mesh((2, 2), ("data", "model"), device="cpu")
    storage = TSH.trainable(TSH.place(params, mesh, TSH.lm_param_spec))
    comp = TSH.reshard(storage, mesh, TSH.lm_param_spec_tp)
    gen = torch.Generator().manual_seed(0)
    total, expect = 0.0, {}
    for pos in range(mesh.size):
        for path, blk in TT.flatten_with_paths(comp.shards[pos]):
            r = torch.randn(blk.shape, generator=gen)
            total = total + (blk * r).sum()
            full = expect.setdefault(path, torch.zeros(comp.shapes[path]))
            idx = tuple(slice(*comp.range(path, d, pos))
                        for d in range(len(blk.shape)))
            full[idx] += r
    leaves = TSH.distinct(storage)
    grads = torch.autograd.grad(total, [b for _, b in leaves])
    seen = 0
    for pos in range(mesh.size):
        for path, blk in TT.flatten_with_paths(storage.shards[pos]):
            g = grads[next(i for i, (_, b) in enumerate(leaves) if b is blk)]
            idx = tuple(slice(*storage.range(path, d, pos))
                        for d in range(len(blk.shape)))
            torch.testing.assert_close(g, expect[path][idx], rtol=1e-5,
                                       atol=1e-5)
            seen += 1
    assert seen == 4 * len(storage.specs)
    # a replicated norm is one leaf of the four positions
    norms = [s["final_norm"]["scale"] for s in storage.shards]
    assert all(n is norms[0] for n in norms) and norms[0].requires_grad


def test_psum_scatter_gives_each_position_its_block():
    mesh = TM.make_mesh((2, 3), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((2, 6, 3), generator=gen, requires_grad=True)
          for _ in range(mesh.size)]
    metrics.reset()
    out = TM.psum_scatter(mesh, "model", xs, 1)
    assert TM.collectives() == 1
    assert TM.gathered_bytes() == 6 * 2 * 6 * 3 * 4
    rs = [torch.randn(o.shape, generator=gen) for o in out]
    grads = torch.autograd.grad(sum((o * r).sum() for o, r in
                                    zip(out, rs)), xs)
    for g in mesh.groups("model"):
        total = sum(xs[i] for i in g)
        for j, i in enumerate(g):
            assert out[i].shape == (2, 2, 3)
            torch.testing.assert_close(out[i], total[:, 2 * j:2 * j + 2])
        # the backward is an all-gather of the blocks' gradients
        for i in g:
            torch.testing.assert_close(grads[i], torch.cat(
                [rs[k] for k in g], 1))
    same = TM.psum_scatter(mesh, (), xs, 1)           # groups of one
    assert all(a is b for a, b in zip(same, xs, strict=True))
    with pytest.raises(ValueError, match="divide"):
        TM.psum_scatter(mesh, "model", [x[:, :4] for x in xs], 1)
