"""Port vs reference: the model mesh for serving.

* The sharding rules (``repro_torch.launch.sharding`` against
  ``repro.launch.sharding``): every leaf (path, shape) of the five LM
  configs at full width, and of the GNN and recsys smoke trees, fed to both
  packages' rules; the sanitized specs compared on the (16, 16),
  (2, 16, 16), (2, 2) and (1, 4) mesh shapes.  The reference's
  ``sanitize_spec`` / ``lm_cache_spec`` read only ``mesh.shape`` and
  ``mesh.axis_names``, so a stand-in mesh serves both (no 256 devices).
* The mesh's groups and grouped collectives, and the placement (blocks
  assemble to the leaf; a replicated leaf is one tensor a device).
* The sharded routes: ``prefill`` and ``decode_step`` on placed smoke
  weights on CPU meshes (1, 2), (1, 4) and (2, 2), against the reference's
  ``prefill`` / ``decode_step`` with the same knobs, run unsharded under a
  1 x 1 mesh (its sharding constraints need one), within ``TOL``: float32
  in another order (tensor-parallel partial sums, the log-sum-exp merge),
  measured at about 1e-6.  At ``model`` 4 the smoke configs' heads split
  (qwen3-1.7b's 2 K / V heads, qwen3-32b's 6 query heads), so the weights
  of the cut heads are gathered; at ``model`` 3 qwen3-32b's ``wq`` splits
  and its ``wk`` / ``wv`` do not (a decode case of its own).  The MoE
  layer with ``ep_axes`` on tokens split over ``data``, at a capacity that
  drops: routing equal to the reference's as integers, the output within
  1e-5.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.models import equivariant as JEQ
from repro.models import gnn as JGNN
from repro.models import moe as JMOE
from repro.models import recsys as JRS
from repro.models import transformer as JTF
from repro_torch import configs as tconfigs
from repro_torch import tree as TT
from repro_torch.core import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.models import moe as TMOE
from repro_torch.models import spmd as TSPMD
from repro_torch.models import transformer as TTF
from repro_torch.obs import metrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
LM_ARCHS = ("qwen3-1.7b", "minicpm3-4b", "qwen3-32b",
            "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b")
MESH_SHAPES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "2x2": ((2, 2), ("data", "model")),
               "1x4": ((1, 4), ("data", "model"))}
ONE_BY_ONE = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)


def _stand_in(name):
    shape, axes = MESH_SHAPES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _leaves(tree):
    """(path, shape) of every leaf of an abstract reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(l.shape)) for p, l in flat]


def _abstract_lm(arch):
    cfg = jconfigs.get(arch).make_full()
    return cfg, jax.eval_shape(lambda k: JTF.init_params(k, cfg),
                               jax.random.PRNGKey(0))


def _abstract_other():
    out = {}
    for arch, init in (("gat-cora", JGNN.gat_init),
                       ("meshgraphnet", JGNN.mgn_init),
                       ("gatedgcn", JGNN.gatedgcn_init),
                       ("nequip", JEQ.nequip_init),
                       ("dcn-v2", JRS.dcnv2_init)):
        cfg = jconfigs.get(arch).make_smoke()
        out[arch] = jax.eval_shape(lambda k: init(k, cfg),
                                   jax.random.PRNGKey(0))
    return out


def _same(t_spec, j_spec, what):
    assert isinstance(t_spec, TSH.P), what
    assert tuple(t_spec) == tuple(j_spec), (what, t_spec, j_spec)


def _check_rules(leaves, mesh, rules):
    for path, shape in leaves:
        leaf = types.SimpleNamespace(ndim=len(shape), shape=shape)
        for t_rule, j_rule in rules:
            t, j = t_rule(path, leaf), j_rule(path, leaf)
            _same(t, j, (path, t_rule.__name__))
            _same(TSH.sanitize_spec(t, shape, mesh),
                  JSH.sanitize_spec(j, shape, mesh),
                  (path, shape, t_rule.__name__, mesh.shape))


@pytest.mark.parametrize("mesh_name", MESH_SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_rules_equal_the_reference(arch, mesh_name):
    mesh = _stand_in(mesh_name)
    cfg, tree = _abstract_lm(arch)
    _check_rules(_leaves(tree), mesh,
                 [(TSH.lm_param_spec, JSH.lm_param_spec),
                  (TSH.lm_param_spec_tp, JSH.lm_param_spec_tp)])
    _same(TSH.lm_batch_spec(mesh), JSH.lm_batch_spec(mesh), "batch")
    for shp in tconfigs.LM_SHAPES.values():
        B, S = shp["batch"], shp["seq_len"]
        t = TSH.lm_cache_spec(mesh, cfg.attn_type, B, cfg.n_kv_heads)
        j = JSH.lm_cache_spec(mesh, cfg.attn_type, B, cfg.n_kv_heads)
        assert sorted(t) == sorted(j)
        shapes = jax.eval_shape(lambda: JTF.make_empty_cache(cfg, B, S))
        for k in t:
            _same(t[k], j[k], (k, B))
            _same(TSH.sanitize_spec(t[k], shapes[k].shape, mesh),
                  JSH.sanitize_spec(j[k], shapes[k].shape, mesh), (k, B, S))


@pytest.mark.parametrize("mesh_name", MESH_SHAPES)
def test_gnn_and_recsys_rules_equal_the_reference(mesh_name):
    mesh = _stand_in(mesh_name)
    for arch, tree in _abstract_other().items():
        rule = ((TSH.recsys_param_spec, JSH.recsys_param_spec)
                if arch == "dcn-v2" else
                (TSH.gnn_param_spec, JSH.gnn_param_spec))
        _check_rules(_leaves(tree), mesh, [rule])
        family = "recsys" if arch == "dcn-v2" else "gnn"
        assert TSH.PARAM_RULES[family].__name__ == \
            JSH.PARAM_RULES[family].__name__
    _same(TSH.gnn_edge_spec(mesh), JSH.gnn_edge_spec(mesh), "edges")
    assert sorted(TSH.PARAM_RULES) == sorted(JSH.PARAM_RULES)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_paths_are_the_reference_paths(arch):
    """The rules key on paths: the port's tree flattens to the reference's
    ``keystr`` paths, leaf for leaf (the smoke configs; the full ones have
    the same tree)."""
    cj = jconfigs.get(arch).make_smoke()
    ref = _leaves(jax.eval_shape(lambda k: JTF.init_params(k, cj),
                                 jax.random.PRNGKey(0)))
    pt = TTF.init_params(torch.Generator().manual_seed(0),
                         tconfigs.get(arch).make_smoke())
    assert [(p, tuple(l.shape)) for p, l in TT.flatten_with_paths(pt)] == ref


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(), (None,), (("data",),), ((),), ("model", None),
                    (None, ("data", "model")), (("pod", "data"), None)]:
        assert tuple(TSH.P(*entries)) == tuple(JP(*entries)), entries


# --------------------------------------------------------------------------
# the mesh and the placement
# --------------------------------------------------------------------------

def test_groups_and_grouped_collectives():
    mesh = TM.make_mesh((2, 3), ("data", "model"), device="cpu")
    assert mesh.groups("model") == ((0, 1, 2), (3, 4, 5))
    assert mesh.groups("data") == ((0, 3), (1, 4), (2, 5))
    assert mesh.groups("data,model") == ((0, 1, 2, 3, 4, 5),)
    assert mesh.groups(()) == tuple((i,) for i in range(6))
    assert [mesh.group_index(p, "model") for p in range(6)] == [0, 1, 2] * 2
    assert [mesh.group_index(p, ("data", "model")) for p in range(6)] == \
        list(range(6))
    # the whole-mesh view of the coloring engines is unchanged
    assert mesh.shard_devices("data,model") == mesh.devices
    with pytest.raises(ValueError, match="every axis"):
        mesh.shard_devices("data")
    metrics.reset()
    vals = [torch.full((2,), float(p)) for p in range(6)]
    sums = TM.psum(mesh, "model", vals)
    assert [float(s[0]) for s in sums] == [3.0] * 3 + [12.0] * 3
    g = TM.all_gather_groups(mesh, "data", vals)
    assert g[1].tolist() == [[1.0, 1.0], [4.0, 4.0]]
    assert TM.collectives() == 2 and TM.gathered_bytes() == 2 * 6 * 2 * 4
    TM.psum(mesh, (), vals)                       # groups of one: nothing
    assert TM.collectives() == 2


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_placement_assembles_every_leaf(shape):
    cfg = tconfigs.get("qwen2-moe-a2.7b").make_smoke()
    params = TTF.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = TM.make_mesh(shape, ("data", "model"), device="cpu")
    placed = TSH.place(params, mesh, TSH.lm_param_spec_tp)
    for path, leaf in TT.flatten_with_paths(params):
        assert tuple(placed.specs[path]) == tuple(TSH.sanitize_spec(
            TSH.lm_param_spec_tp(path, leaf), leaf.shape, mesh))
        assert torch.equal(placed.gather(path), leaf), path
    m = shape[1]
    wq = "['layers']['attn']['wq']"
    assert placed.split(wq, 2) == ("model",)
    assert placed.shards[0]["layers"]["attn"]["wq"].shape == (
        2, cfg.d_model, cfg.n_heads * cfg.head_dim // m)    # layers kept
    # a replicated leaf is one tensor for the positions of one device
    norms = [s["final_norm"]["scale"] for s in placed.shards]
    assert all(n is norms[0] for n in norms)
    per = placed.bytes_per_shard()
    total = sum(l.numel() * l.element_size() for l in TT.leaves(params))
    assert len(set(per)) == 1 and total / m <= per[0] < total


# --------------------------------------------------------------------------
# the sharded routes against the reference
# --------------------------------------------------------------------------

ROUTE_ARCHS = ("qwen3-1.7b", "qwen3-32b", "phi3.5-moe-42b-a6.6b",
               "qwen2-moe-a2.7b")
ROUTE_MESHES = ((1, 2), (1, 4), (2, 2))
# (decode_write_then_attend, decode_seq_axis)
DECODE_KNOBS = ((True, "model"), (True, None), (False, None))
B, LQ, S = 4, 13, 32


def _cfgs(arch, **knobs):
    cj, ct = jconfigs.get(arch).make_smoke(), tconfigs.get(arch).make_smoke()
    if cj.moe is not None:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(
            cj.moe, ep_axes=("model", "data")))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(
            ct.moe, ep_axes=("model", "data")))
    return (dataclasses.replace(cj, **knobs),
            dataclasses.replace(ct, **knobs))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cj, ct = _cfgs(arch)
    pj = JTF.init_params(jax.random.PRNGKey(0), cj)
    return pj, TTF.params_from_reference(
        ct, jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab, (B, LQ)).astype(np.int32)
    cache = {k: rng.standard_normal((cfg.n_layers, B, cfg.n_kv_heads, S,
                                     cfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    # a slot mid-cache, an empty cache, the last slot, one more
    length = np.array([5, 0, S - 1, 17], np.int32)
    tok = rng.integers(1, cfg.vocab, (B,)).astype(np.int32)
    return toks, cache, length, tok


@functools.lru_cache(maxsize=None)
def _reference(arch, kind, knobs=()):
    cj, _ = _cfgs(arch, **dict(knobs))
    pj, _ = _weights(arch)
    toks, cache, length, tok = _inputs(cj)
    with ONE_BY_ONE:
        if kind == "prefill":
            out = jax.jit(lambda p, t: JTF.prefill(p, cj, t))(
                pj, jnp.asarray(toks))
        else:
            out = jax.jit(lambda p, t, c, n: JTF.decode_step(
                p, cj, t, c, n))(pj, jnp.asarray(tok),
                                 {k: jnp.asarray(v) for k, v in
                                  cache.items()}, jnp.asarray(length))
    return jax.tree_util.tree_map(np.asarray, out)


def _mesh(shape):
    return TM.make_mesh(shape, ("data", "model"), device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what,
                               **TOL)


@pytest.mark.parametrize("shape", ROUTE_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ROUTE_ARCHS)
def test_sharded_prefill_equals_the_reference(arch, shape):
    _, ct = _cfgs(arch)
    _, pt = _weights(arch)
    mesh = _mesh(shape)
    placed = TSH.place(pt, mesh, TSH.lm_param_spec_tp)
    toks = _inputs(ct)[0]
    metrics.reset()
    with torch.no_grad():
        logits, cache = TTF.prefill(placed, ct, torch.from_numpy(toks))
    assert TM.collectives() > 0
    lj, cj = _reference(arch, "prefill")
    _close(logits, lj, "logits")
    want = TSH.sanitize_spec(TSH.lm_cache_spec(mesh, "gqa", B,
                                               ct.n_kv_heads)["k"],
                             cj["k"].shape, mesh)
    for k in ("k", "v"):
        assert tuple(cache.specs[f"['{k}']"]) == tuple(want)
        _close(cache.gather(f"['{k}']"), cj[k], k)
    # laid out by sequence over model: a shard holds LQ / |model| slots
    # when they divide, all of them otherwise
    m = shape[1]
    assert cache.shards[0]["k"].shape[3] == (LQ // m if LQ % m == 0 else LQ)


@pytest.mark.parametrize("knobs", DECODE_KNOBS,
                         ids=["write_then_attend-seq_axis",
                              "write_then_attend", "append"])
@pytest.mark.parametrize("shape", ROUTE_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ROUTE_ARCHS)
def test_sharded_decode_equals_the_reference(arch, shape, knobs):
    _check_decode(arch, shape, knobs)


@pytest.mark.parametrize("knobs", DECODE_KNOBS,
                         ids=["write_then_attend-seq_axis",
                              "write_then_attend", "append"])
def test_sharded_decode_with_query_heads_split_alone(knobs):
    """qwen3-32b's smoke config (6 / 2 heads, Dh 16) on (1, 3): ``model``
    divides ``wq``'s 96 columns but not ``wk`` / ``wv``'s 32, so the
    placement splits ``wq`` alone and the decode gathers each projection
    over its own axes (ROADMAP C.4)."""
    _check_decode("qwen3-32b", (1, 3), knobs)


def _check_decode(arch, shape, knobs):
    wta, seq_axis = knobs
    kn = (("decode_write_then_attend", wta), ("decode_seq_axis", seq_axis))
    _, ct = _cfgs(arch, **dict(kn))
    _, pt = _weights(arch)
    mesh = _mesh(shape)
    placed = TSH.place(pt, mesh, TSH.lm_param_spec_tp)
    _, cache, length, tok = _inputs(ct)
    cspec = TSH.lm_cache_spec(mesh, "gqa", B, ct.n_kv_heads)
    pc = TSH.place({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
                   mesh, cspec)
    assert pc.split("['k']", 3) == (("model",) if S % shape[1] == 0
                                     else ())
    with torch.no_grad():
        logits, pc = TTF.decode_step(placed, ct, torch.from_numpy(tok), pc,
                                     torch.from_numpy(length))
    lj, cj = _reference(arch, "decode", kn)
    _close(logits, lj, "logits")
    for k in ("k", "v"):
        _close(pc.gather(f"['{k}']"), cj[k], k)
    # the unsharded route with the same knobs
    full = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        l1, full = TTF.decode_step(pt, ct, torch.from_numpy(tok), full,
                                   torch.from_numpy(length))
    _close(l1, lj, "unsharded logits")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 1)],
                         ids=["2x2", "4x1", "2x1"])
def test_sharded_moe_routes_and_drops_as_the_reference(shape):
    """The MoE layer with ``ep_axes`` on tokens split over ``data``, at
    capacity 1.0 (drops): the capacity rank crosses the data shards (a
    shard's pairs rank after the earlier shards'), the same pairs drop."""
    d, T = 64, 96
    cj = dataclasses.replace(jconfigs.get("qwen2-moe-a2.7b").make_smoke().moe,
                             capacity_factor=1.0, ep_axes=("model", "data"))
    ct = TMOE.MoEConfig(**dataclasses.asdict(cj))
    pj = JMOE.moe_init(jax.random.PRNGKey(3), d, cj, jnp.float32)
    x = np.random.default_rng(3).standard_normal((T, d)).astype(np.float32)
    with ONE_BY_ONE:
        out_j, _ = jax.jit(lambda p, x: JMOE.moe_apply(p, cj, x))(
            pj, jnp.asarray(x))
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(
        np.array(a)[None]), pj)
    mesh = _mesh(shape)
    placed = TSH.place({"layers": {"ffn": pt}}, mesh, TSH.lm_param_spec_tp)
    D = shape[0]
    xs = [torch.from_numpy(x[mesh.group_index(p, "data") * (T // D):][
        :T // D]) for p in range(mesh.size)]
    metrics.reset()
    with torch.no_grad():
        outs, routes = TSPMD.moe_apply_sharded(placed, ct, 0, xs, ("data",))
    # the unsharded port route's routing is the reference's as integers
    # (tests/test_torch_moe_mla.py); here the sharded one equals it
    _, _, eidx, pos, keep, cap = TMOE.moe_route(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), pj),
        ct, torch.from_numpy(x))
    assert cap == int(1.0 * T * cj.top_k / cj.n_experts)
    assert not keep.all()
    for p in range(mesh.size):
        rows = slice(mesh.group_index(p, "data") * (T // D),
                     (mesh.group_index(p, "data") + 1) * (T // D))
        for got, want in zip(routes[p], (eidx, pos, keep)):
            assert torch.equal(got, want[rows]), p
        np.testing.assert_allclose(outs[p].numpy(), np.asarray(out_j)[rows],
                                   rtol=1e-5, atol=1e-5)
    assert TM.collectives() > 0


def test_mla_and_training_knobs_refused_on_a_mesh():
    """The sharded MoE refuses an ``ep_axes`` it does not run (MLA on a
    mesh runs: ``tests/test_torch_mla_mesh.py``)."""
    mesh = _mesh((1, 2))
    bad = dataclasses.replace(_cfgs("phi3.5-moe-42b-a6.6b")[1].moe,
                              ep_axes=("data",))
    with pytest.raises(NotImplementedError, match="capacity"):
        TSPMD.moe_apply_sharded(TSH.place(
            {"layers": {"ffn": _weights("phi3.5-moe-42b-a6.6b")[1]["layers"][
                "ffn"]}}, mesh, TSH.lm_param_spec_tp), bad, 0,
            [torch.zeros((4, 64))] * 2, ())
