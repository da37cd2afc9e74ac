"""GNN architectures: GAT, MeshGraphNet, GatedGCN (the port of the
reference's ``models/gnn.py``).

Message passing runs over COO edge lists with two primitives, ``gather``
(rows of a node table per edge) and ``segment_sum`` (edge rows summed into
their destination node), the counterparts of ``h[src]`` and
``jax.ops.segment_sum``.  Full-graph batches (cora, ogb_products) are COO;
batched small graphs are flattened block-diagonally by the data pipeline.

Parameters are ``ParamTree``s (``models/transformer.py``) with the
reference's tree and weight layout: a dense weight is ``(d_in, d_out)``,
applied as ``x @ w``; ``params_from_reference`` carries the reference's
arrays across.  The apply functions read a ``ParamTree`` or the same tree of
plain dicts and lists.

Determinism.  ``gather``, ``segment_sum`` and ``atomic_scatter`` come from
``scatter.py``: on the card both scatters are sorted, so a training step,
and a restart from a checkpoint, repeat bit for bit.
``colored_segment_sum`` needs neither: within one colour class every
destination appears once.

Coloring hook (the paper's technique, DESIGN.md §5): ``colored_segment_sum``
aggregates colour class by colour class (``core.schedule.
edge_color_by_dst``): each class is a conflict-free scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core import mesh as M
from repro_torch.models.layers import _init_dense
from repro_torch.models.scatter import (  # noqa: F401 (re-exported)
    _ATOMIC, atomic_scatter, gather, segment_sum)
from repro_torch.models.transformer import ParamTree, _tensor


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def segment_max(data: torch.Tensor, seg: torch.Tensor, n: int):
    """``jax.ops.segment_max``: -inf for an empty segment.  (A max does not
    depend on the order of its operands: no atomics question.)"""
    out = torch.full((n,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    index = seg.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(
        data)
    return out.scatter_reduce(0, index, data, "amax", include_self=False)


def mlp_init(generator, dims, device=None, layernorm=False) -> dict:
    p = {"w": [], "b": []}
    for a, b in zip(dims[:-1], dims[1:]):
        p["w"].append(_init_dense(generator, a, b, device=device))
        p["b"].append(torch.zeros((b,), dtype=torch.float32, device=device))
    if layernorm:
        p["ln_scale"] = torch.ones((dims[-1],), dtype=torch.float32,
                                   device=device)
        p["ln_bias"] = torch.zeros((dims[-1],), dtype=torch.float32,
                                   device=device)
    return p


def _bn_free_norm(x):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)    # jnp's var
    return (x - mu) * torch.rsqrt(var + 1e-6)


def mlp_apply(p, x, act=torch.relu):
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = act(x)
    if "ln_scale" in p:
        x = _bn_free_norm(x) * p["ln_scale"] + p["ln_bias"]
    return x


def segment_softmax(scores, seg_ids, n_segments):
    """Softmax over edges grouped by destination (numerically stable), per
    column of ``scores`` (E, ...).  The shift by the segment's max is held
    constant for the gradient: the softmax does not depend on it."""
    smax = segment_max(scores.detach(), seg_ids, n_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    e = torch.exp(scores - gather(smax, seg_ids))
    ssum = segment_sum(e, seg_ids, n_segments)
    return e / torch.clamp(gather(ssum, seg_ids), min=1e-16)


# --------------------------------------------------------------------------
# GAT  (arXiv:1710.10903) — SDDMM-style edge scores + segment softmax
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    final_heads: int = 1          # final layer averages heads


def gat_init(generator: torch.Generator, cfg: GATConfig,
             device=None) -> ParamTree:
    layers = []
    d_in = cfg.d_in
    H = cfg.n_heads
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w": _init_dense(generator, d_in, H * d_out, device=device),
            "a_src": torch.randn((H, d_out), generator=generator,
                                 device=device) * 0.1,
            "a_dst": torch.randn((H, d_out), generator=generator,
                                 device=device) * 0.1,
        })
        d_in = d_out * (1 if last else H)
    return ParamTree({"layers": layers}, trainable=True)


def gat_apply(params, cfg: GATConfig, feats, src, dst, n_nodes):
    x = feats
    H = cfg.n_heads
    for i, lp in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        d_out = lp["w"].shape[1] // H
        h = (x @ lp["w"]).reshape(-1, H, d_out)
        hs = gather(h, src)
        e = F.leaky_relu((hs * lp["a_src"]).sum(-1)
                         + (gather(h, dst) * lp["a_dst"]).sum(-1), 0.2)
        alpha = segment_softmax(e, dst, n_nodes)           # (E, H)
        agg = segment_sum(hs * alpha[..., None], dst, n_nodes)
        x = agg.mean(1) if last else F.elu(agg.reshape(n_nodes, H * d_out))
    return x


# --------------------------------------------------------------------------
# MeshGraphNet (arXiv:2010.03409) — encode-process-decode with edge state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGNConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in: int = 3
    d_edge_in: int = 4
    d_out: int = 3


def _mlp_dims(d_in, d_h, n_hidden):
    return [d_in] + [d_h] * n_hidden + [d_h]


def mgn_init(generator: torch.Generator, cfg: MGNConfig,
             device=None) -> ParamTree:
    d = cfg.d_hidden
    hid = cfg.mlp_layers - 1
    g = dict(generator=generator, device=device)
    p = {
        "node_enc": mlp_init(dims=_mlp_dims(cfg.d_in, d, hid),
                             layernorm=True, **g),
        "edge_enc": mlp_init(dims=_mlp_dims(cfg.d_edge_in, d, hid),
                             layernorm=True, **g),
        "decoder": mlp_init(dims=[d] * cfg.mlp_layers + [cfg.d_out], **g),
        "blocks": [{
            "edge_mlp": mlp_init(dims=_mlp_dims(3 * d, d, hid),
                                 layernorm=True, **g),
            "node_mlp": mlp_init(dims=_mlp_dims(2 * d, d, hid),
                                 layernorm=True, **g),
        } for _ in range(cfg.n_layers)],
    }
    return ParamTree(p, trainable=True)


def mgn_apply(params, cfg: MGNConfig, feats, edge_feats, src, dst, n_nodes):
    h = mlp_apply(params["node_enc"], feats)
    e = mlp_apply(params["edge_enc"], edge_feats)
    for blk in params["blocks"]:
        e = e + mlp_apply(blk["edge_mlp"], torch.cat(
            [e, gather(h, src), gather(h, dst)], -1))
        agg = segment_sum(e, dst, n_nodes)
        h = h + mlp_apply(blk["node_mlp"], torch.cat([h, agg], -1))
    return mlp_apply(params["decoder"], h)


# --------------------------------------------------------------------------
# GatedGCN (arXiv:1711.07553 / benchmarking-gnns 2003.00982)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_out: int = 7


def gatedgcn_init(generator: torch.Generator, cfg: GatedGCNConfig,
                  device=None) -> ParamTree:
    d = cfg.d_hidden
    g = dict(generator=generator, device=device)
    p = {"embed": _init_dense(d_in=cfg.d_in, d_out=d, **g),
         "readout": _init_dense(d_in=d, d_out=cfg.d_out, **g),
         "blocks": [{n: _init_dense(d_in=d, d_out=d, **g) for n in "ABCDE"}
                    for _ in range(cfg.n_layers)]}
    return ParamTree(p, trainable=True)


def _gated_layer(blk, h, e, tab, src, dst, n_nodes):
    """One GatedGCN layer: ``tab`` is the table ``src`` indexes (``h``, or
    in the halo form ``h`` with the ghosts' rows below it).  The edge-side
    products ``h[src] @ D`` of the reference are taken per node and then
    gathered, ``(tab @ D)[src]``: the same sums, and an (E, d) tensor less
    for autograd to keep."""
    d = h.shape[1]
    e_new = e + gather(tab @ blk["D"], src) + gather(h @ blk["E"], dst)
    eta = torch.sigmoid(e_new)
    msg = eta * gather(tab @ blk["B"], src)
    s = segment_sum(torch.cat([eta, msg], 1), dst, n_nodes)   # one scatter
    agg = s[:, d:] / (s[:, :d] + 1e-6)
    h_new = h @ blk["A"] + agg
    return h + torch.relu(_bn_free_norm(h_new)), e_new


def gatedgcn_apply(params, cfg: GatedGCNConfig, feats, src, dst, n_nodes):
    h = feats @ params["embed"]
    e = h.new_zeros((src.shape[0], cfg.d_hidden))
    for blk in params["blocks"]:
        h, e = _gated_layer(blk, h, e, h, src, dst, n_nodes)
    return h @ params["readout"]


# --------------------------------------------------------------------------
# GatedGCN with HALO EXCHANGE — the paper's partition/boundary insight
# applied to full-graph training.  With nodes block-partitioned
# (core/partition.py) each shard owns its dst scatter entirely; only
# BOUNDARY node features cross shards, via one all-gather of (max_b, d) per
# layer — the replicated->halo trade of core/distributed.py.
#
# The reference runs one program per shard under ``shard_map``; the port
# loops over the mesh's shards on the host, layer by layer, each shard's
# tensors on its device, and gathers with ``core.mesh.all_gather``.
# Gradients flow through plain autograd across the loop and the gathers.
# --------------------------------------------------------------------------

def _shard_params(params, mesh: M.Mesh, axis: str) -> list:
    """The parameters as seen by each shard: on the shard's device (a
    differentiable copy where it is another device than theirs)."""
    return [T.tree_map(lambda t, dev=dev: t.to(dev), params)
            for dev in mesh.shard_devices(axis)]


def _exchange(hs: list, shards: Sequence[dict], max_b: int) -> list:
    """Each shard's table: its ``h`` with its ghosts' rows below, read from
    one all-gather of every shard's (max_b, d) boundary payload."""
    D = len(hs)
    payloads = []
    for h, b in zip(hs, shards):
        bnd = b["boundary"].long()
        rows = h.index_select(0, bnd.clamp(0, h.shape[0] - 1))
        payloads.append(torch.where((bnd >= 0)[:, None], rows, 0.0))
    gathered = M.all_gather(payloads)                   # 1 collective/layer
    tabs = []
    for h, b, allp in zip(hs, shards, gathered):
        gf = b["ghost_flat"].long()
        allp = allp.reshape(D * max_b, h.shape[1])
        ghosts = allp.index_select(0, gf.clamp(0, D * max_b - 1))
        tabs.append(torch.cat([h, torch.where((gf >= 0)[:, None], ghosts,
                                              0.0)], 0))
    return tabs


def gatedgcn_halo_apply(params, cfg: GatedGCNConfig, shards: Sequence[dict],
                        mesh: M.Mesh, axis: str = "data") -> list:
    """Per-shard GatedGCN forward over the shards of ``axis``.

    ``shards[d]`` holds shard d's tensors, on its device:
      feats:      (n_loc, d_in) owned nodes' features
      src:        (E_d,) local slot [0, n_loc) or ghost slot n_loc + g
      dst:        (E_d,) local slot (every edge's dst is owned)
      boundary:   (max_b,) local slots this shard publishes (-1 pad)
      ghost_flat: (max_g,) index into the gathered (D * max_b,) payload
    Shards may hold different edge counts (no padding is needed).  Returns
    each shard's (n_loc, d_out) logits."""
    D = len(mesh.shard_devices(axis))
    if len(shards) != D:
        raise ValueError(f"{len(shards)} shard batches for {D} shards")
    ps = _shard_params(params, mesh, axis)
    max_b = shards[0]["boundary"].shape[0]
    hs = [b["feats"] @ p["embed"] for b, p in zip(shards, ps)]
    es = [h.new_zeros((b["src"].shape[0], cfg.d_hidden))
          for h, b in zip(hs, shards)]
    for i in range(cfg.n_layers):
        tabs = _exchange(hs, shards, max_b)
        for d in range(D):
            hs[d], es[d] = _gated_layer(
                ps[d]["blocks"][i], hs[d], es[d], tabs[d],
                shards[d]["src"], shards[d]["dst"], hs[d].shape[0])
    return [h @ p["readout"] for h, p in zip(hs, ps)]


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), -1)
    return -logp.gather(1, labels.long().clamp(min=0)[:, None])[:, 0]


def gatedgcn_halo_loss(params, cfg: GatedGCNConfig, shards: Sequence[dict],
                       mesh: M.Mesh, axis: str = "data") -> torch.Tensor:
    """Mean node-classification loss over all shards' nodes (the
    reference's two ``psum``s as one gather of each shard's (masked nll
    sum, mask sum) and a sum).  Returned on the first shard's device."""
    logits = gatedgcn_halo_apply(params, cfg, shards, mesh, axis)
    parts = []
    for lg, b in zip(logits, shards):
        mask = b["train_mask"].to(torch.float32)
        parts.append(torch.stack([(_nll(lg, b["labels"]) * mask).sum(),
                                  mask.sum()]))
    tot = M.all_gather(parts)[0].sum(0)
    return tot[0] / torch.clamp(tot[1], min=1.0)


# --------------------------------------------------------------------------
# losses (per task kind)
# --------------------------------------------------------------------------

def node_classification_loss(logits, labels, mask=None):
    nll = _nll(logits, labels)
    if mask is None:
        mask = labels >= 0
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def node_regression_loss(pred, target, mask=None):
    se = ((pred - target) ** 2).sum(-1)
    if mask is not None:
        return (se * mask).sum() / torch.clamp(mask.sum(), min=1)
    return se.mean()


def gnn_loss_fn(arch_def, shp: dict, cfg, n_nodes: int):
    """``loss(params, batch)`` of a GNN train cell (the reference's
    ``launch/cells.py::_gnn_loss_fn``): node classification for the full
    and sampled modes, a per-graph energy regression for batched molecules
    (the sink's ``graph_id``, outside the graphs, is dropped); ``nequip``'s
    scalar head regresses ``labels % 2`` outside the batched mode."""
    model = arch_def.extras["model"]
    mode = shp["mode"]
    if model not in ("gat", "mgn", "gatedgcn", "nequip"):
        raise ValueError(model)

    def forward(params, batch):
        if model == "gat":
            return gat_apply(params, cfg, batch["feats"], batch["src"],
                             batch["dst"], n_nodes)
        if model == "mgn":
            return mgn_apply(params, cfg, batch["feats"],
                             batch["edge_feats"], batch["src"], batch["dst"],
                             n_nodes)
        if model == "nequip":
            from repro_torch.models import equivariant as EQ
            e = EQ.nequip_apply(params, cfg, batch["species"],
                                batch["positions"], batch["src"],
                                batch["dst"], n_nodes,
                                scalar_feats=batch.get("feats"))
            return e[:, None]                     # (N, 1) scalar head
        return gatedgcn_apply(params, cfg, batch["feats"], batch["src"],
                              batch["dst"], n_nodes)

    def loss(params, batch):
        out = forward(params, batch)
        if mode == "batched":
            e_graph = segment_sum(out.mean(-1), batch["graph_id"],
                                  batch["energy"].shape[0])
            return ((e_graph - batch["energy"]) ** 2).mean()
        if model == "nequip":                     # regression head elsewhere
            tgt = (batch["labels"] % 2).to(torch.float32)
            pred = out[: tgt.shape[0], 0]
            return ((pred - tgt) ** 2).mean()
        n_lab = batch["labels"].shape[0]
        mask = batch.get("train_mask")
        mask = mask[:n_lab] if mask is not None else None
        return node_classification_loss(out[:n_lab], batch["labels"], mask)

    return loss


# --------------------------------------------------------------------------
# coloring-scheduled aggregation (the paper's technique plugged into GNNs)
# --------------------------------------------------------------------------

def colored_segment_sum(msg, dst, n_nodes, edge_color, n_colors: int):
    """Aggregate messages colour class by colour class.

    ``edge_color`` comes from colouring the conflict graph of the edges
    (edges conflict iff they share a dst: ``core.schedule.
    edge_color_by_dst``); within a colour every dst appears once, so each
    class is one ``index_add_`` without collisions — no atomics race, the
    same bits every run, on the card too.  Classes are added in colour
    order, as the reference's loop does; edges with a colour outside [0,
    n_colors) are left out, as there."""
    out = msg.new_zeros((n_nodes,) + tuple(msg.shape[1:]))
    ok = (edge_color >= 0) & (edge_color < n_colors)
    ids = torch.nonzero(ok)[:, 0]
    ids = ids[torch.argsort(edge_color[ids], stable=True)]
    counts = torch.bincount(edge_color[ids].long(),
                            minlength=n_colors).tolist()
    start = 0
    for c in counts:
        cls = ids[start:start + c]
        out.index_add_(0, dst[cls], msg[cls])
        start += c
    return out


# --------------------------------------------------------------------------
# the reference's parameters
# --------------------------------------------------------------------------

_TOP_KEYS = {"gat": {"layers"},
             "mgn": {"node_enc", "edge_enc", "decoder", "blocks"},
             "gatedgcn": {"embed", "readout", "blocks"}}


def params_from_reference(model: str, tree: dict, device=None) -> ParamTree:
    """The reference's parameter tree of ``model`` ("gat", "mgn" or
    "gatedgcn"; ``repro.models.gnn.<model>_init``), its leaves as numpy
    arrays, as trainable port parameters: the same tree, every array in
    its layout."""
    if model not in _TOP_KEYS:
        raise ValueError(f"unknown GNN model {model!r}; ported: "
                         f"{sorted(_TOP_KEYS)}")
    if set(tree) != _TOP_KEYS[model]:
        raise ValueError(f"{model}: the tree has keys {sorted(tree)}, "
                         f"expected {sorted(_TOP_KEYS[model])}")
    return ParamTree(T.tree_map(lambda a: _tensor(np.asarray(a), device),
                                tree), trainable=True)
