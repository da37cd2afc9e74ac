"""Cell builders: (architecture x input shape) on a mesh -> a runnable step
(the port's counterpart of the reference's ``launch/cells.py``).

A *cell* is one entry of the reference's (arch x shape) grid.  The
reference's ``Cell`` holds ``ShapeDtypeStruct``s and only lowers (nothing
is allocated); the port has no XLA to lower through, so its ``Cell`` holds
real tensors placed on the mesh (``launch.sharding.place``) and
``Cell.run()`` runs the step.  Step kinds, all of the reference's:

  lm.train        the full update step: loss -> gradients -> AdamW, weights
                  and moments stored by ``lm_param_spec`` (FSDP x TP),
                  ``microbatches`` static slices of the global batch
  lm.prefill      tokens (B, L) -> (last logits, caches placed by
                  ``lm_cache_spec``), weights by ``lm_param_spec_tp``
  lm.decode       one token against a placed seq_len cache (GQA's K / V or
                  MLA's latents)
  gnn.train       the full update step, edges split over the mesh, nodes
                  and weights replicated (``models/gnn_mesh.py``); with
                  ``{"halo": True}`` GatedGCN on a block partition with
                  one boundary gather a layer
  recsys.train    the CTR loss's update step, tables row-sharded over
                  ``model`` (``models/recsys_mesh.py``)
  recsys.serve    batched scoring; recsys.retrieval 1 query against the
                  candidates split over the mesh, top 100

A train cell runs on any mesh.  Where its positions sit on different
devices, a replicated block has a copy a device: each replica set's
gradients are summed across its copies (``launch.sharding.
reduce_replicas``), the global norm counts each set once, and each set is
updated once and copied to its other copies (``_adamw_update_placed``).

On a mesh of ``meta`` positions (the dry run, ``launch/dryrun.py``) a
cell holds empty meta tensors at the shape's full sizes: weights made with
no generator, inputs never drawn, a GNN batch shaped by
``_gnn_batch_shapes``, the halo cell sized by ``boundary_frac``;
``launch/cost.py`` counts its step.  The full shapes are large
(``train_4k`` is 256 x 4096 tokens, ``long_500k`` a 524,288-slot cache,
``ogb_products`` 61.9M edges): ``batch=`` / ``seq_len=`` / ``sizes=`` cut
them, and a cut is written into the cell's ``static_notes``;
``overrides`` cut an LM's depth (``n_layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.common import shapes_for
from repro_torch.core.mesh import Mesh
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import transformer as TF
from repro_torch.training import optimizer as OPTIM

# the reference's cell optimizer (``src/repro/launch/cells.py``'s ``OPT``)
OPT = OPTIM.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple             # placed tensors (``launch.sharding.Placed``)
    cfg: object = None
    static_notes: str = ""

    def run(self):
        """One step on the placed arguments.  Inference runs without grad;
        a train step runs with it, returns ``(params, opt_state, metrics)``
        and keeps them as the next step's arguments (the reference donates
        its)."""
        if self.kind == "train":
            out = self.step(*self.args)
            self.args = (out[0], out[1]) + tuple(self.args[2:])
            return out
        with torch.no_grad():
            return self.step(*self.args)


def _generator(dev):
    """The default weights' generator: seed 0 on ``dev``; none on meta,
    which has no generator (nothing is drawn there)."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(0)


def _drawn(dev, make, shape, dtype):
    """``make()``'s numpy array on ``dev``; on meta an empty tensor of its
    ``shape`` and ``dtype``, never drawn."""
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.from_numpy(make()).to(dev)


def _place(x, mesh: Mesh, rule) -> SH.Placed:
    """``x`` placed by ``rule`` (a rule function, a dict of specs or one
    spec for every leaf); a ``Placed`` already is kept as it is."""
    if isinstance(x, SH.Placed):
        return x
    if isinstance(rule, SH.P):
        spec = rule
        rule = lambda path, leaf: spec                  # noqa: E731
    return SH.place(x, mesh, rule)


def _lm_config(arch_def, mesh: Mesh, overrides: dict, smoke: bool):
    moe_ep = overrides.pop("moe_ep", False)
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    if moe_ep and cfg.moe is not None:          # EP: experts x capacity
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axes=("model", "data")))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.act_shard and not cfg.act_batch_axes:
        cfg = dataclasses.replace(cfg, act_batch_axes=batch_axes(mesh))
    if cfg.fsdp_inner:
        cfg = dataclasses.replace(cfg, model_axis_size=mesh.shape["model"])
    return cfg


def _cut(shp: dict, sizes: dict, notes: list) -> dict:
    """``shp`` with the entries of ``sizes`` replaced, each change noted."""
    shp = dict(shp)
    for key, val in sizes.items():
        if key not in shp or key == "kind":
            raise ValueError(f"no size {key!r} to cut in this shape "
                             f"({sorted(shp)})")
        if val != shp[key]:
            notes.append(f"{key} cut from {shp[key]} to {val}")
            shp[key] = val
    return shp


def build_cell(arch: str, shape: str, mesh: Mesh,
               overrides: Optional[dict] = None, *,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               sizes: Optional[dict] = None, smoke: bool = False,
               params=None, inputs: Optional[dict] = None) -> Cell:
    """The cell of ``arch`` at ``shape`` on ``mesh``.

    ``overrides``: config fields to replace (``n_layers``, the perf knobs
    such as ``decode_write_then_attend`` / ``decode_seq_axis``,
    ``fsdp_inner``, ``act_shard``, ``remat``), plus ``moe_ep``
    (``ep_axes=("model", "data")``) and the train cell's ``microbatches``,
    as in the reference; a GNN cell's are its knobs (``halo``,
    ``boundary_frac``).  ``batch`` / ``seq_len`` / ``sizes`` (any entry of
    the shape: ``n_nodes``, ``n_edges``, ``d_feat``, ``n_candidates``, ...)
    cut the shape, each cut written into ``static_notes``.  ``smoke``: the
    arch's smoke config (a GNN's input and output widths then follow the
    shape's ``d_feat`` / ``n_classes``).  ``params``: the weights (the
    family's parameter tree, placed here, or a ``Placed`` one in the
    cell's layout); by default random weights from ``torch.Generator``
    seed 0 on the mesh's first device.  A train cell trains copies of
    them.  ``inputs``: tensors (an LM's may be ``Placed`` ones) in place of
    the seeded defaults — LM train ``tokens`` / ``labels`` (B, L), prefill
    ``tokens``, decode ``token`` (B,), ``length`` (B,) (default: zeros) and
    ``cache`` (a ``make_empty_cache`` dict; default: zeros); recsys
    ``dense`` / ``sparse`` / ``labels`` and retrieval's ``cand``; a GNN
    batch's arrays (``_gnn_batch``'s keys; the halo cell's ``src`` /
    ``dst`` / ``feats`` / ``labels`` / ``train_mask`` of the whole
    graph)."""
    arch_def = configs.get(arch)
    notes = []
    shp = dict(shapes_for(arch_def.family)[shape])
    if batch is not None:
        shp = _cut(shp, {"batch": batch}, notes)
    if seq_len is not None:
        shp = _cut(shp, {"seq_len": seq_len}, notes)
    shp = _cut(shp, dict(sizes or {}), notes)
    overrides = dict(overrides or {})
    inputs = dict(inputs or {})
    if arch_def.family == "gnn":
        return _gnn_cell(arch, shape, shp, mesh, arch_def, overrides, smoke,
                         params, inputs, notes)
    if arch_def.family == "recsys":
        if overrides:
            raise ValueError(f"{arch}: a recsys cell takes no overrides "
                             f"({sorted(overrides)})")
        return _recsys_cell(arch, shape, shp, mesh, arch_def, smoke, params,
                            inputs, notes)
    microbatches = int(overrides.pop("microbatches", 1))
    cfg = _lm_config(arch_def, mesh, overrides, smoke)
    B, L = shp["batch"], shp["seq_len"]
    full_layers = (arch_def.make_smoke() if smoke
                   else arch_def.make_full()).n_layers
    if cfg.n_layers != full_layers:
        notes.append(f"n_layers cut from {full_layers} to {cfg.n_layers}")
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    if params is None:
        params = TF.init_params(_generator(dev), cfg, dev)
    if shp["kind"] == "train":
        return _train_cell(arch, shape, mesh, cfg, params, inputs, rng, B, L,
                           microbatches, "; ".join(notes))
    placed = _place(params, mesh, SH.lm_param_spec_tp)
    if shp["kind"] == "prefill":
        tokens = inputs.get("tokens")
        if tokens is None:
            tokens = _drawn(dev, lambda: rng.integers(
                1, cfg.vocab, (B, L)).astype(np.int32), (B, L), torch.int32)
        args = (placed, _place(tokens, mesh, SH.lm_batch_spec(mesh)))
        step = lambda p, t: TF.prefill(p, cfg, t)       # noqa: E731
        kind = "prefill"
    else:
        b_axes = batch_axes(mesh)
        bspec = SH.P(b_axes) if B >= int(np.prod(
            [mesh.shape[a] for a in b_axes])) else SH.P()
        token = inputs.get("token")
        if token is None:
            token = _drawn(dev, lambda: rng.integers(
                1, cfg.vocab, (B,)).astype(np.int32), (B,), torch.int32)
        length = inputs.get("length")
        if length is None:
            length = torch.zeros((B,), dtype=torch.int32, device=dev)
        cache = inputs.get("cache")
        if cache is None:
            cache = TF.make_empty_cache(cfg, B, L, dev)
        args = (placed, _place(token, mesh, bspec),
                _place(cache, mesh, SH.lm_cache_spec(
                    mesh, cfg.attn_type, B, cfg.n_kv_heads)),
                _place(length, mesh, bspec))
        step = lambda p, t, c, n: TF.decode_step(p, cfg, t, c, n)  # noqa
        kind = "decode"
    return Cell(arch, shape, kind, step, args, cfg, "; ".join(notes))


def _init_opt_state_placed(placed) -> dict:
    """The moments of a placed tree: float32 zeros a distinct block, placed
    as the blocks are (``mu`` / ``nu`` are ``Placed`` trees of the same
    shapes, specs and sharing), and an int32 step on the first device."""
    zeros = OPTIM.init_opt_state([b for _, b in SH.distinct(placed)])
    return {"mu": SH.with_blocks(placed, zeros["mu"]),
            "nu": SH.with_blocks(placed, zeros["nu"]),
            "step": zeros["step"]}


def _adamw_update_placed(cfg: OPTIM.OptimizerConfig, placed, sets, grads,
                         state):
    """``OPTIM.adamw_update`` on a placed tree: ``grads`` holds one gradient
    a replica set (``sets``: ``SH.replica_sets(placed)``, summed over the
    set's copies by ``SH.reduce_replicas``), and each set is one leaf: the
    global norm sums each set once (on its first copy's device, moved to
    the first set's device), the update runs on each set's first copy,
    written into it, and its new value and moments are copied into the
    set's other copies, so that the copies stay bit-equal whatever devices
    they sit on.  A block's weight decay follows its ndim, which is its
    global leaf's.  Returns ``(placed, new_state, metrics)``; the moments
    stay in the blocks' layout.  On a one-device mesh every set is one
    block."""
    blocks = [b for _, b in SH.distinct(placed)]
    mu = [b for _, b in SH.distinct(state["mu"])]
    nu = [b for _, b in SH.distinct(state["nu"])]
    first = [copies[0][1] for _, copies in sets]
    _, new, metrics = OPTIM.adamw_update(
        cfg, [blocks[i] for i in first], list(grads),
        {"mu": [mu[i] for i in first], "nu": [nu[i] for i in first],
         "step": state["step"]})
    devices = placed.mesh.devices
    with torch.no_grad():
        for (_, copies), m, n in zip(sets, new["mu"], new["nu"]):
            (_, lead), rest = copies[0], copies[1:]
            mu[lead], nu[lead] = m, n
            for pos, i in rest:
                blocks[i].copy_(blocks[lead])
                mu[i], nu[i] = m.to(devices[pos]), n.to(devices[pos])
    return placed, {"mu": SH.with_blocks(state["mu"], mu),
                    "nu": SH.with_blocks(state["nu"], nu),
                    "step": new["step"]}, metrics


def _grad(mesh: Mesh, loss, leaves) -> tuple:
    """``loss``'s gradient for every leaf (zeros for an unused one).  Where
    the mesh's positions sit on several devices the backward runs on the
    calling thread, as the forward's host loop does: the autograd engine's
    thread a device would otherwise run one remat region's recompute
    (``torch.utils.checkpoint``, a frame spanning the devices) from two
    threads at once, which the checkpoint's bookkeeping does not allow."""
    with torch.autograd.set_multithreading_enabled(
            len(set(mesh.devices)) == 1):
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)


def _train_cell(arch, shape, mesh: Mesh, cfg, params, inputs: dict, rng,
                B: int, L: int, microbatches: int, notes: str) -> Cell:
    """The reference's ``_lm_train_cell``: weights and moments stored by
    ``lm_param_spec``, the batch by ``lm_batch_spec``; a step takes the
    loss of each microbatch (rows ``[i·B/M, (i+1)·B/M)`` of the global
    batch, placed by ``lm_batch_spec``) on the storage tree — the sharded
    route moves it to the compute layout, and the gradient comes back to
    storage — sums the gradients in float32, divides by M, sums each
    replica set's over its copies (``SH.reduce_replicas``), and ends with
    ``OPT``'s AdamW on the replica sets.  Metrics: ``loss`` (the mean of
    the microbatch losses), ``grad_norm``, ``lr``."""
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    dev = mesh.devices[0]
    bspec = SH.lm_batch_spec(mesh)
    batch = {}
    for key in ("tokens", "labels"):
        x = inputs.get(key)
        if x is None:
            x = _drawn(dev, lambda: rng.integers(1, cfg.vocab, (B, L)).astype(
                np.int32), (B, L), torch.int32)
        batch[key] = _place(x, mesh, bspec)
    placed = SH.trainable(_place(params, mesh, SH.lm_param_spec))
    leaves = [b for _, b in SH.distinct(placed)]
    sets = SH.replica_sets(placed)

    def value_and_grad(p, b):
        loss = TF.train_step_loss(p, cfg, b)
        return loss, _grad(mesh, loss, leaves)

    def step(p, opt_state, b):
        if microbatches == 1:
            loss, grads = value_and_grad(p, b)
        else:
            whole = {k: v.gather("") for k, v in b.items()}
            n = B // microbatches
            grads = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in leaves]
            loss = 0.0
            for i in range(microbatches):
                mb = {k: _place(v[i * n:(i + 1) * n], mesh, bspec)
                      for k, v in whole.items()}
                loss_i, g = value_and_grad(p, mb)
                grads = [a + x.float() for a, x in zip(grads, g)]
                loss = loss + loss_i.detach()
            grads = [g / microbatches for g in grads]
            loss = loss / microbatches
        grads = SH.reduce_replicas(mesh, sets, grads)
        p, opt_state, m = _adamw_update_placed(OPT, p, sets, grads,
                                               opt_state)
        m["loss"] = loss.detach()
        return p, opt_state, m

    return Cell(arch, shape, "train", step,
                (placed, _init_opt_state_placed(placed), batch), cfg,
                notes)


def _placed_train_cell(arch, shape, mesh: Mesh, placed: SH.Placed, batch,
                       loss_of: Callable, cfg, notes: str) -> Cell:
    """A train cell on a placed tree: ``loss_of(params, batch)`` (the first
    position's loss), its gradient for every distinct block, summed over
    each replica set (``SH.reduce_replicas``), ``OPT``'s AdamW on the
    replica sets (``_adamw_update_placed``)."""
    placed = SH.trainable(placed)
    leaves = [b for _, b in SH.distinct(placed)]
    sets = SH.replica_sets(placed)

    def step(p, opt_state, b):
        loss = loss_of(p, b)
        grads = SH.reduce_replicas(mesh, sets, _grad(mesh, loss, leaves))
        p, opt_state, m = _adamw_update_placed(OPT, p, sets, grads,
                                               opt_state)
        m["loss"] = loss.detach()
        return p, opt_state, m

    return Cell(arch, shape, "train", step,
                (placed, _init_opt_state_placed(placed), batch), cfg, notes)


# --------------------------------------------------------------------------
# recsys cells: tables row-sharded over model
# --------------------------------------------------------------------------

def _sparse_ids(rng, cfg, B: int) -> np.ndarray:
    """(B, n_sparse, max_hots) int32 ids, each field's in its table, the
    hots after the first -1 (a pad) with probability 1/2."""
    ids = np.stack([rng.integers(0, v, (B, cfg.max_hots))
                    for v in cfg.vocabs], 1)
    pad = rng.random(ids.shape) < 0.5
    pad[..., 0] = False
    return np.where(pad, -1, ids).astype(np.int32)


def _recsys_cell(arch, shape, shp, mesh: Mesh, arch_def, smoke: bool,
                 params, inputs: dict, notes: list) -> Cell:
    """The reference's ``_recsys_cells``: ``train`` (``ctr_loss`` and
    ``OPT``'s AdamW), ``serve`` (``predict``) and ``retrieval`` (one query
    against ``n_candidates`` candidates split over the whole mesh, top
    100), on the weights placed by ``recsys_param_spec``; the batch's rows
    over the data axes from 32 rows up, replicated below."""
    from repro_torch.models import recsys as RS
    from repro_torch.models import recsys_mesh as RSM
    from repro_torch.models import spmd
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    if params is None:
        params = RS.dcnv2_init(_generator(dev), cfg, dev)
    placed = _place(params, mesh, SH.recsys_param_spec)
    kind, B = shp["kind"], shp["batch"]
    bspec = SH.P(batch_axes(mesh))
    rows = bspec if B >= 32 else SH.P()

    def get(key, make, shape, dtype):
        x = inputs.get(key)
        return _drawn(dev, make, shape, dtype) if x is None else x

    arrays = {"dense": get("dense", lambda: rng.standard_normal(
        (B, cfg.n_dense)).astype(np.float32), (B, cfg.n_dense),
        torch.float32),
        "sparse": get("sparse", lambda: _sparse_ids(rng, cfg, B),
                      (B, cfg.n_sparse, cfg.max_hots), torch.int32)}
    notes = "; ".join(notes)
    if kind == "train":
        arrays["labels"] = get("labels", lambda: rng.integers(
            0, 2, (B,)).astype(np.int32), (B,), torch.int32)
        batch = SH.place(arrays, mesh, {"dense": rows, "sparse": rows,
                                        "labels": bspec})
        return _placed_train_cell(
            arch, shape, mesh, placed, batch,
            lambda p, b: RSM.ctr_loss(p, cfg, b)[0], cfg, notes)
    if kind == "serve":
        batch = _place(arrays, mesh, rows)

        def serve(p, b):
            return spmd._assemble(mesh, RSM.predict(p, cfg, b), rows, (B,))

        return Cell(arch, shape, "serve", serve, (placed, batch), cfg, notes)
    NC = shp["n_candidates"]

    def candidates():
        c = rng.standard_normal((NC, cfg.mlp_dims[-1])).astype(np.float32)
        return c / np.linalg.norm(c, axis=1, keepdims=True)

    cand = _place(get("cand", candidates, (NC, cfg.mlp_dims[-1]),
                      torch.float32), mesh, SH.P(mesh.axis_names))
    args = (placed, _place(arrays["dense"], mesh, rows),
            _place(arrays["sparse"], mesh, rows), cand)
    return Cell(arch, shape, "retrieval", lambda p, d, s, c:
                RSM.retrieval_scores(p, cfg, d, s, c, top_k=100), args, cfg,
                notes)


# --------------------------------------------------------------------------
# GNN train cells: edges split over the mesh, nodes replicated
# --------------------------------------------------------------------------

EDGE_PAD = 8192      # GNN edge arrays pad to this multiple (even sharding)
# a config's input and output widths, set from the shape in smoke mode
_GNN_WIDTHS = {"gat": ("d_in", "n_classes"), "mgn": ("d_in", "d_out"),
               "gatedgcn": ("d_in", "d_out"), "nequip": ("d_scalar_in", None)}


def _gnn_config(arch_def, shp: dict, smoke: bool):
    if not smoke:
        return arch_def.make_full(d_in=shp["d_feat"],
                                  n_classes=shp["n_classes"])
    d_in, d_out = _GNN_WIDTHS[arch_def.extras["model"]]
    over = {d_in: shp["d_feat"]}
    if d_out:
        over[d_out] = shp["n_classes"]
    return dataclasses.replace(arch_def.make_smoke(), **over)


def _gnn_init(model: str, cfg, dev):
    from repro_torch.models import equivariant as EQ
    from repro_torch.models import gnn as G
    init = {"gat": G.gat_init, "mgn": G.mgn_init,
            "gatedgcn": G.gatedgcn_init, "nequip": EQ.nequip_init}[model]
    return init(_generator(dev), cfg, dev)


_GNN_DTYPES = {"feats": torch.float32, "edge_feats": torch.float32,
               "positions": torch.float32, "energy": torch.float32,
               "train_mask": torch.float32}


def _gnn_batch_shapes(model: str, shp: dict) -> tuple:
    """The reference's ``_gnn_batch_shapes``: the shape of every array of
    one GNN cell's batch, and N.  Every graph gets one SINK padding node
    (index N - 1) and edge arrays padded to a multiple of ``EDGE_PAD`` with
    sink -> sink self-loops, so edge arrays shard evenly over the mesh and
    padding never reaches a real node."""
    from repro_torch.graphs.sampler import union_caps
    mode = shp["mode"]
    if mode == "full":
        N, E = shp["n_nodes"] + 1, shp["n_edges"]
        B = None
    elif mode == "sampled":
        fan = tuple(reversed(shp["fanouts"]))
        caps = union_caps(shp["batch_nodes"], fan)
        N = caps[-1] + 1
        E = sum(c * f for c, f in zip(caps[:-1], fan))
        B = shp["batch_nodes"]
    else:                                     # batched molecules
        B = shp["batch"]
        N, E = B * shp["n_nodes"] + 1, B * shp["n_edges"]
    E = -(-E // EDGE_PAD) * EDGE_PAD
    out = {"src": (E,), "dst": (E,), "feats": (N, shp["d_feat"])}
    if mode != "batched":                     # batched target = energy
        out["labels"] = (B,) if mode == "sampled" else (N,)
    if model == "mgn":
        out["edge_feats"] = (E, 4)
    if model == "nequip":
        out["positions"] = (N, 3)
        out["species"] = (N,)
    if mode == "batched":
        out["graph_id"] = (N,)
        out["energy"] = (B,)
    if mode == "full":
        out["train_mask"] = (N,)
    return out, N


def _gnn_batch(model: str, shp: dict, cfg, rng) -> dict:
    """A seeded batch of the reference's ``_gnn_batch_shapes`` (numpy): the
    shape's nodes plus one SINK node (index N - 1) and its edges padded to
    a multiple of ``EDGE_PAD`` by sink -> sink self-loops.  Full graph:
    ``n_edges`` random edges over ``n_nodes``; sampled: the union subgraph
    of ``graphs.sampler.union_caps``, each hop's ``fanout`` edges into its
    destinations from the next hop's nodes; batched: ``batch`` molecules
    of ``n_nodes`` / ``n_edges`` each, block-diagonal, the sink's
    ``graph_id`` ``batch`` (outside the graphs)."""
    from repro_torch.graphs.sampler import union_caps
    mode = shp["mode"]
    B = None
    if mode == "full":
        n = shp["n_nodes"]
        src = rng.integers(0, n, shp["n_edges"])
        dst = rng.integers(0, n, shp["n_edges"])
    elif mode == "sampled":
        fan = tuple(reversed(shp["fanouts"]))
        caps = union_caps(shp["batch_nodes"], fan)
        n, B = caps[-1], shp["batch_nodes"]
        src = np.concatenate([rng.integers(0, caps[i + 1], caps[i] * f)
                              for i, f in enumerate(fan)])
        dst = np.concatenate([np.repeat(np.arange(caps[i]), f)
                              for i, f in enumerate(fan)])
    else:
        B, nm, em = shp["batch"], shp["n_nodes"], shp["n_edges"]
        n = B * nm
        off = np.repeat(np.arange(B) * nm, em)
        src = off + rng.integers(0, nm, B * em)
        dst = off + rng.integers(0, nm, B * em)
    N = n + 1
    E = -(-len(src) // EDGE_PAD) * EDGE_PAD
    pad = np.full(E - len(src), n)
    feats = rng.standard_normal((N, shp["d_feat"])).astype(np.float32)
    feats[n] = 0
    out = {"src": np.concatenate([src, pad]).astype(np.int32),
           "dst": np.concatenate([dst, pad]).astype(np.int32),
           "feats": feats}
    if mode != "batched":
        out["labels"] = rng.integers(0, shp["n_classes"], B or N).astype(
            np.int32)
    if model == "mgn":
        ef = rng.standard_normal((E, 4)).astype(np.float32)
        ef[len(src):] = 0
        out["edge_feats"] = ef
    if model == "nequip":
        out["positions"] = rng.standard_normal((N, 3)).astype(np.float32)
        out["species"] = rng.integers(0, cfg.n_species, N).astype(np.int32)
    if mode == "batched":
        out["graph_id"] = np.append(np.repeat(np.arange(B), shp["n_nodes"]),
                                    B).astype(np.int32)
        out["energy"] = rng.standard_normal(B).astype(np.float32)
    if mode == "full":
        mask = (rng.random(N) < 0.5).astype(np.float32)
        mask[n] = 0
        out["train_mask"] = mask
    return out


def _gnn_cell(arch, shape, shp, mesh: Mesh, arch_def, overrides: dict,
              smoke: bool, params, inputs: dict, notes: list) -> Cell:
    """The reference's ``_gnn_train_cell``: the parameters replicated
    (``gnn_param_spec``), the edge arrays over the mesh
    (``gnn_edge_spec``), the node arrays replicated; one step is the
    edge-parallel loss (``models/gnn_mesh.py``), its gradient and ``OPT``'s
    AdamW.  ``{"halo": True}`` (GatedGCN, full graph): ``_gnn_halo_cell``."""
    from repro_torch.models import gnn_mesh as GM
    model = arch_def.extras["model"]
    opts = dict(overrides)
    halo = opts.pop("halo", False)
    boundary_frac = float(opts.pop("boundary_frac", 0.10))
    if opts:
        raise ValueError(f"{arch}: unknown GNN cell knobs {sorted(opts)}")
    if halo and (model != "gatedgcn" or shp["mode"] != "full"):
        raise ValueError("halo variant: gatedgcn full-graph cells only")
    cfg = _gnn_config(arch_def, shp, smoke)
    dev = mesh.devices[0]
    if params is None:
        params = _gnn_init(model, cfg, dev)
    placed = _place(params, mesh, SH.gnn_param_spec)
    if halo:
        return _gnn_halo_cell(arch, shape, shp, mesh, cfg, placed, inputs,
                              notes, boundary_frac)
    if dev.type == "meta":
        arrays = {k: torch.empty(s, dtype=_GNN_DTYPES.get(k, torch.int32),
                                 device=dev)
                  for k, s in _gnn_batch_shapes(model, shp)[0].items()}
    else:
        arrays = _gnn_batch(model, shp, cfg, np.random.default_rng(0))
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    arrays.update({k: v for k, v in inputs.items() if k in arrays})
    espec = SH.gnn_edge_spec(mesh)
    rule = {k: (espec if k in ("src", "dst") else SH.P(espec[0])
                if k == "edge_feats" else SH.P()) for k in arrays}
    batch = SH.place(arrays, mesh, rule)
    n_nodes = batch.shapes["['feats']"][0]
    axes = batch.split("['src']", 0)
    mode = shp["mode"]

    def loss_of(p, b):
        edges = GM.EdgeShards(mesh, axes, [s["src"] for s in b.shards],
                              [s["dst"] for s in b.shards], n_nodes)
        return GM.loss(model, mode, cfg, list(p.shards), list(b.shards),
                       edges)[0]

    return _placed_train_cell(arch, shape, mesh, placed, batch, loss_of, cfg,
                              "; ".join(notes))


def halo_batch(src, dst, feats, labels, mask, n: int, D: int) -> tuple:
    """The halo GatedGCN's inputs of a graph of ``n`` nodes (numpy; the
    edges are symmetrized, deduplicated and their self-loops dropped, as
    ``graphs.csr.from_edges`` builds a graph) at ``D`` shards: (the
    partition (``core.partition.block_partition``, seed 0), its plan
    (``build_halo``), per shard its batch — its owned rows of the relabeled
    ``feats`` / ``labels`` / ``train_mask``, its ELL's live slots as (src,
    dst) edges with src a local slot or a ghost slot n_loc + g, its
    boundary list, each ghost's index into the gathered (D * max_b,)
    boundary payload —, and the replicated graph's (src, dst, feats,
    labels, mask) over the ``n_pad`` relabeled nodes)."""
    from repro_torch.core import partition as PT
    from repro_torch.graphs import csr as CSR
    part = PT.block_partition(CSR.from_edges(n, np.stack([src, dst], 1)), D,
                              seed=0)
    plan = PT.build_halo(part)

    def relabeled(a):
        out = np.zeros((part.n_pad,) + a.shape[1:], a.dtype)
        out[part.perm] = a
        return out

    feats, labels, mask = relabeled(feats), relabeled(labels), \
        relabeled(mask)
    n_loc = part.n_loc
    W = plan.ell_local.shape[-1]
    ghost_flat = np.where(plan.ghost_owner >= 0,
                          plan.ghost_owner * plan.max_b + plan.ghost_slot,
                          -1).astype(np.int32)
    shards = []
    for d in range(D):
        srcs = plan.ell_local[d].reshape(-1)
        keep = srcs >= 0
        rows = slice(d * n_loc, (d + 1) * n_loc)
        shards.append({"feats": feats[rows], "labels": labels[rows],
                       "train_mask": mask[rows],
                       "src": srcs[keep].astype(np.int32),
                       "dst": np.repeat(np.arange(n_loc, dtype=np.int32),
                                        W)[keep],
                       "boundary": plan.boundary[d].astype(np.int32),
                       "ghost_flat": ghost_flat[d]})
    e = CSR.to_edge_list(part.graph)
    return part, plan, shards, (e[:, 0].astype(np.int32),
                                e[:, 1].astype(np.int32), feats, labels, mask)


def _halo_meta_batch(shp: dict, cfg, mesh: Mesh, notes: list,
                     boundary_frac: float) -> tuple:
    """The halo cell's per-shard batch on a meta mesh, sized as the
    reference's ``_gnn_halo_train_cell`` sizes it: ``n_loc`` nodes and
    ``e_loc`` edges a shard (rounded up to 128 / 512), ``boundary_frac`` of
    a shard's nodes on its boundary and as many ghosts.  There is no graph
    to plan on meta (``core.partition.build_halo`` reads the edges)."""
    D, dev = mesh.size, mesh.devices[0]
    n_loc = -(-shp["n_nodes"] // (D * 128)) * 128
    e_loc = -(-shp["n_edges"] // (D * 512)) * 512
    max_b = max(128, int(n_loc * boundary_frac) // 128 * 128)
    shapes = {"feats": ((n_loc, cfg.d_in), torch.float32),
              "labels": ((n_loc,), torch.int32),
              "train_mask": ((n_loc,), torch.float32),
              "src": ((e_loc,), torch.int32), "dst": ((e_loc,), torch.int32),
              "boundary": ((max_b,), torch.int32),
              "ghost_flat": ((max_b,), torch.int32)}
    batch = [{k: torch.empty(s, dtype=t, device=dev)
              for k, (s, t) in shapes.items()} for _ in range(D)]
    return batch, notes + [
        f"halo over {D} shards sized by boundary_frac {boundary_frac}: "
        f"n_loc {n_loc}, e_loc {e_loc}, max_b = max_g {max_b} (a meta "
        f"mesh has no graph to plan)"]


def _gnn_halo_cell(arch, shape, shp, mesh: Mesh, cfg, placed, inputs: dict,
                   notes: list, boundary_frac: float) -> Cell:
    """The reference's ``_gnn_halo_train_cell``: GatedGCN with its nodes
    block-partitioned over every mesh position, each shard's scatter its
    own and one boundary all-gather a layer (``gnn.gatedgcn_halo_loss``).
    The reference sizes the boundary by ``boundary_frac``; here the plan is
    real (``halo_batch`` on the cell's graph) and ``static_notes`` records
    its largest boundary against ``boundary_frac``."""
    from repro_torch.models import gnn as G
    D, n = mesh.size, shp["n_nodes"]
    axis = ",".join(mesh.axis_names)
    if mesh.devices[0].type == "meta":
        batch, notes = _halo_meta_batch(shp, cfg, mesh, notes, boundary_frac)
        return _placed_train_cell(
            arch, shape, mesh, placed, batch,
            lambda p, b: G.gatedgcn_halo_loss(p.shards[0], cfg, b, mesh,
                                              axis),
            cfg, "; ".join(notes))
    rng = np.random.default_rng(0)
    arrays = {"src": rng.integers(0, n, shp["n_edges"]),
              "dst": rng.integers(0, n, shp["n_edges"]),
              "feats": rng.standard_normal((n, shp["d_feat"])).astype(
                  np.float32),
              "labels": rng.integers(0, shp["n_classes"], n).astype(
                  np.int32),
              "train_mask": (rng.random(n) < 0.5).astype(np.float32)}
    arrays.update({k: np.asarray(v.cpu()) if torch.is_tensor(v) else v
                   for k, v in inputs.items()})
    part, plan, shards, _ = halo_batch(
        arrays["src"], arrays["dst"], arrays["feats"], arrays["labels"],
        arrays["train_mask"], n, D)
    batch = [{k: torch.from_numpy(v).to(mesh.devices[d])
              for k, v in s.items()} for d, s in enumerate(shards)]
    real = int(plan.n_boundary.max()) / part.n_loc
    notes = notes + [f"halo over {D} shards: a real plan "
                     f"(core.partition.build_halo), n_loc {part.n_loc}, the "
                     f"largest boundary {int(plan.n_boundary.max())} nodes "
                     f"({real:.4f} of n_loc) against boundary_frac "
                     f"{boundary_frac}"]
    return _placed_train_cell(
        arch, shape, mesh, placed, batch,
        lambda p, b: G.gatedgcn_halo_loss(p.shards[0], cfg, b, mesh, axis),
        cfg, "; ".join(notes))
