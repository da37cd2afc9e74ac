"""The GNN train cells on a mesh, edge-parallel: the reference's
``launch/cells.py::_gnn_train_cell`` under GSPMD, with the parameters and
the node arrays replicated (``gnn_param_spec``) and the edge arrays
(``src``, ``dst``, ``edge_feats``) split over the mesh (``gnn_edge_spec``).

As ``models/spmd.py`` runs the LM, a host loop over the mesh positions runs
each model: every position computes the node side of a layer on its own
copy of the (replicated) node arrays and the messages of its own edge
block; each scatter into the nodes (``segment_sum``) is the position's
block's partial sum, ``psum``-ed over the axes the edges are split over
(``EdgeShards.sum``).  GAT's ``segment_softmax`` needs every block's
per-node max and sum: the max is one gather of the blocks' per-node maxima
and an ``amax`` over them (``EdgeShards.max``; ``core.mesh`` has no max
collective), the sum a ``psum``.  Every position ends with the same
outputs and the same loss; the backward starts from the first position's
loss, as the LM's training route does, and autograd takes it through the
collectives to every block.

The models' node and edge halves are those of ``models/gnn.py`` and
``models/equivariant.py`` (``gated_edges`` / ``gated_nodes``,
``messages`` / ``node_update``): the same arithmetic, the scatters split.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import mesh as M
from repro_torch.models import equivariant as EQ
from repro_torch.models import gnn as G
from repro_torch.models.scatter import gather, segment_sum


class EdgeShards:
    """Per mesh position its block of the edges (``src`` / ``dst``, global
    node ids), the axes the blocks are split over, and the node count."""

    def __init__(self, mesh: M.Mesh, axes: tuple, src: list, dst: list,
                 n_nodes: int):
        self.mesh, self.axes = mesh, tuple(axes)
        self.src, self.dst, self.n = list(src), list(dst), n_nodes

    def sum(self, parts: list) -> list:
        """``segment_sum`` of every block's edge rows into the nodes: each
        position's partial, ``psum``-ed over the edge axes."""
        return M.psum(self.mesh, self.axes, [
            segment_sum(p, d, self.n) for p, d in zip(parts, self.dst)])

    def max(self, parts: list) -> list:
        """``segment_max`` over every block: each position's per-node
        maxima, gathered over the edge axes and reduced by ``amax``."""
        local = [G.segment_max(p, d, self.n) for p, d in zip(parts,
                                                              self.dst)]
        return [g.amax(0) for g in M.all_gather_groups(self.mesh, self.axes,
                                                       local)]

    def softmax(self, scores: list) -> list:
        """``gnn.segment_softmax`` of each block's edge scores over every
        block's edges into the same destination."""
        smax = [torch.where(torch.isfinite(m), m, torch.zeros_like(m))
                for m in self.max([s.detach() for s in scores])]
        ex = [torch.exp(s - gather(m, d))
              for s, m, d in zip(scores, smax, self.dst)]
        ssum = self.sum(ex)
        return [e / torch.clamp(gather(t, d), min=1e-16)
                for e, t, d in zip(ex, ssum, self.dst)]


def gat_apply(ps: list, cfg, feats: list, E: EdgeShards) -> list:
    xs, H = list(feats), cfg.n_heads
    n_layers = len(ps[0]["layers"])
    for li in range(n_layers):
        last = li == n_layers - 1
        scores, msgs = [], []
        for pos, x in M.each(xs):
            lp = ps[pos]["layers"][li]
            h = (x @ lp["w"]).reshape(-1, H, lp["w"].shape[1] // H)
            hs = gather(h, E.src[pos])
            scores.append(F.leaky_relu(
                (hs * lp["a_src"]).sum(-1)
                + (gather(h, E.dst[pos]) * lp["a_dst"]).sum(-1), 0.2))
            msgs.append(hs)
        alpha = E.softmax(scores)                          # (E_blk, H)
        agg = E.sum([m * a[..., None] for m, a in zip(msgs, alpha)])
        xs = [a.mean(1) if last else F.elu(a.reshape(E.n, -1)) for a in agg]
    return xs


def mgn_apply(ps: list, cfg, feats: list, edge_feats: list,
              E: EdgeShards) -> list:
    hs = [G.mlp_apply(p["node_enc"], f) for p, f in zip(ps, feats)]
    es = [G.mlp_apply(p["edge_enc"], f) for p, f in zip(ps, edge_feats)]
    for bi in range(len(ps[0]["blocks"])):
        es = [e + G.mlp_apply(ps[pos]["blocks"][bi]["edge_mlp"], torch.cat(
            [e, gather(h, E.src[pos]), gather(h, E.dst[pos])], -1))
            for pos, (e, h) in M.each(zip(es, hs))]
        agg = E.sum(es)
        hs = [h + G.mlp_apply(ps[pos]["blocks"][bi]["node_mlp"],
                              torch.cat([h, a], -1))
              for pos, (h, a) in M.each(zip(hs, agg))]
    return [G.mlp_apply(p["decoder"], h) for p, h in zip(ps, hs)]


def gatedgcn_apply(ps: list, cfg, feats: list, E: EdgeShards) -> list:
    hs = [f @ p["embed"] for p, f in zip(ps, feats)]
    es = [h.new_zeros((s.shape[0], cfg.d_hidden)) for h, s in zip(hs, E.src)]
    for bi in range(len(ps[0]["blocks"])):
        out = [G.gated_edges(ps[pos]["blocks"][bi], h, e, h, E.src[pos],
                             E.dst[pos])
               for pos, (h, e) in M.each(zip(hs, es))]
        es = [e for _, e in out]
        summed = E.sum([m for m, _ in out])
        hs = [G.gated_nodes(ps[pos]["blocks"][bi], h, s)
              for pos, (h, s) in M.each(zip(hs, summed))]
    return [h @ p["readout"] for p, h in zip(ps, hs)]


def nequip_apply(ps: list, cfg, species: list, positions: list,
                 E: EdgeShards, scalar_feats=None) -> list:
    """Per position the per-node energies (N,)."""
    sf = scalar_feats or [None] * len(ps)
    feats = [EQ.embed_nodes(p, cfg, s, E.n, f)
             for p, s, f in zip(ps, species, sf)]
    basis = [EQ.edge_basis(cfg, x, s, d)
             for x, s, d in zip(positions, E.src, E.dst)]
    dst_safe = [b[3] for b in basis]
    E = EdgeShards(E.mesh, E.axes, E.src, dst_safe, E.n)
    for li in range(len(ps[0]["layers"])):
        msgs = []
        for pos, (sh, rbf, valid, _) in M.each(basis):
            lp = ps[pos]["layers"][li]
            msgs.append(EQ.messages(cfg, feats[pos], sh, EQ.radial_weights(
                lp, cfg, rbf, valid), E.src[pos]))
        aggs = [{} for _ in ps]
        for l in range(cfg.l_max + 1):
            if msgs[0][l] is None:
                for a in aggs:
                    a[l] = None
                continue
            for a, t in zip(aggs, E.sum([m[l] for m in msgs])):
                a[l] = t
        feats = [EQ.node_update(ps[pos]["layers"][li], cfg, f, a)
                 for pos, (f, a) in M.each(zip(feats, aggs))]
    return [EQ.readout(p, f) for p, f in zip(ps, feats)]


def loss(model: str, mode: str, cfg, ps: list, batch: list,
         E: EdgeShards) -> list:
    """Per position the train cell's loss (``gnn.output_loss``) of the
    edge-parallel forward: ``ps`` / ``batch`` hold per position its
    parameters and its batch (node arrays whole, edge arrays its block)."""
    if model == "gat":
        out = gat_apply(ps, cfg, [b["feats"] for b in batch], E)
    elif model == "mgn":
        out = mgn_apply(ps, cfg, [b["feats"] for b in batch],
                        [b["edge_feats"] for b in batch], E)
    elif model == "gatedgcn":
        out = gatedgcn_apply(ps, cfg, [b["feats"] for b in batch], E)
    elif model == "nequip":
        out = [e[:, None] for e in nequip_apply(
            ps, cfg, [b["species"] for b in batch],
            [b["positions"] for b in batch], E,
            [b.get("feats") for b in batch])]
    else:
        raise ValueError(model)
    return [G.output_loss(model, mode, o, b) for o, b in zip(out, batch)]
