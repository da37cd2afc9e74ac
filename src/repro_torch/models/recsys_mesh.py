"""DCN-v2 on a mesh: the reference's recsys cells under GSPMD, with the
tables row-sharded over ``model`` and the deep tower's ``mlp_w`` split by
its columns (``launch.sharding.recsys_param_spec``), the rest replicated.

As ``models/spmd.py`` runs the LM, a host loop over the mesh positions
runs the model on a ``launch.sharding.Placed`` tree:

* Lookups: each position looks up, in its block of every table, the ids
  that fall in its row range (ids clipped into the table and -1 pads
  masked, the reference's ``embedding_bag`` contract), zeros elsewhere;
  the fields' bags are ``psum``-ed over the axes their table is split
  over (one collective for the fields that share them).
* Cross layers on the position's rows with the replicated weights; each
  deep layer's column block of ``relu(h @ w + b)``, the blocks gathered.
* The batch's rows: split over the data axes where the cell places them
  so, the same across ``model``.  ``ctr_loss`` sums each position's rows
  and ``psum``s the sums over the batch's axes, so every position holds
  the mean; the backward starts from the first position's.
* Retrieval: the candidates split over the mesh; each position scores its
  block and keeps its top-k (a stable descending sort: ties in index
  order); one gather merges the blocks' top-k into the global one, whose
  ties come out in index order too, as ``jax.lax.top_k`` orders them.
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import recsys as RS
from repro_torch.models.scatter import gather
from repro_torch.models.spmd import _concat_gathered


def build_x0(placed: SH.Placed, cfg, dense: list, sparse: list) -> list:
    """Per position ``recsys.build_x0`` of its rows (dense (B_loc, n_dense),
    sparse (B_loc, n_sparse[, H]))."""
    mesh = placed.mesh
    by_axes = {}
    for f in range(cfg.n_sparse):
        by_axes.setdefault(placed.split(f"['tables'][{f}]", 0), []).append(f)
    embs = [[None] * cfg.n_sparse for _ in range(mesh.size)]
    for axes, fields in by_axes.items():
        parts = []
        for pos in M.positions(mesh.size):
            sp = sparse[pos] if sparse[pos].dim() == 3 else sparse[pos][
                ..., None]
            bags = []
            for f in fields:
                path = f"['tables'][{f}]"
                tab = placed.shards[pos]["tables"][f]
                V, n = placed.shapes[path][0], tab.shape[0]
                idx = sp[:, f]
                loc = idx.clamp(0, V - 1) - placed.range(path, 0, pos)[0]
                hit = (idx >= 0) & (loc >= 0) & (loc < n)
                rows = gather(tab, loc.clamp(0, n - 1).reshape(-1)).reshape(
                    idx.shape + (tab.shape[1],))
                bags.append((rows * hit[..., None].to(rows.dtype)).sum(1))
            parts.append(torch.cat(bags, -1))
        for pos, t in M.each(M.psum(mesh, axes, parts)):
            for f, b in zip(fields, t.split(cfg.embed_dim, -1)):
                embs[pos][f] = b
    return [torch.cat([d] + e, -1) for d, e in zip(dense, embs)]


def deep(placed: SH.Placed, hs: list) -> list:
    """The deep tower on per position its rows: each layer's column block,
    gathered."""
    mesh = placed.mesh
    for j in range(len(placed.shards[0]["mlp_w"])):
        path = f"['mlp_w'][{j}]"
        parts = []
        for pos, h in M.each(hs):
            sh = placed.shards[pos]
            c0, c1 = placed.range(path, 1, pos)
            parts.append(torch.relu(h @ sh["mlp_w"][j] + sh["mlp_b"][j][c0:c1]))
        hs = _concat_gathered(mesh, placed.split(path, 1), parts)
    return hs


def forward(placed: SH.Placed, cfg, dense: list, sparse: list) -> list:
    """Per position ``recsys.dcnv2_forward``'s logits of its rows."""
    x0 = build_x0(placed, cfg, dense, sparse)
    xs = list(x0)
    for i in range(len(placed.shards[0]["cross"])):
        xs = [RS.cross_layer(placed.shards[pos]["cross"][i], x0[pos], x)
              for pos, x in M.each(xs)]
    hs = deep(placed, xs)
    if cfg.structure == "parallel":
        hs = [torch.cat([h, x], -1) for h, x in zip(hs, xs)]
    return [(h @ sh["w_logit"] + sh["b_logit"])[..., 0]
            for h, sh in zip(hs, placed.shards)]


def _rows(batch: SH.Placed, key: str) -> list:
    return [sh[key] for sh in batch.shards]


def ctr_loss(placed: SH.Placed, cfg, batch: SH.Placed) -> list:
    """Per position the batch's mean binary cross entropy (the same float32
    scalar on every position)."""
    logits = forward(placed, cfg, _rows(batch, "dense"),
                     _rows(batch, "sparse"))
    parts = []
    for lg, y in zip(logits, _rows(batch, "labels")):
        lg = lg.to(torch.float32)
        y = y.to(torch.float32)
        bce = (torch.clamp(lg, min=0) - lg * y
               + torch.log1p(torch.exp(-torch.abs(lg))))
        parts.append(torch.stack([bce.sum(), torch.full(
            (), float(y.numel()), device=y.device)]))
    axes = batch.split("['labels']", 0)
    return [t[0] / t[1] for t in M.psum(placed.mesh, axes, parts)]


def predict(placed: SH.Placed, cfg, batch: SH.Placed) -> list:
    """Per position the click probabilities of its rows."""
    return [torch.sigmoid(lg) for lg in forward(
        placed, cfg, _rows(batch, "dense"), _rows(batch, "sparse"))]


def retrieval_scores(placed: SH.Placed, cfg, dense: SH.Placed,
                     sparse: SH.Placed, cand: SH.Placed, top_k: int = 100):
    """``recsys.retrieval_scores`` with the candidates split over the mesh:
    (scores (n_cand,), top-k values, top-k indices), assembled on the
    first position's device (a fetch to the caller)."""
    mesh = placed.mesh
    qs = [RS._unit_rows(h) for h in deep(placed, build_x0(
        placed, cfg, list(dense.shards), list(sparse.shards)))]
    axes = cand.split("", 0)
    scores, vals, ids = [], [], []
    for pos, (q, c) in M.each(zip(qs, cand.shards)):
        s = (c @ q[0]).to(torch.float32)
        v, i = torch.sort(s, descending=True, stable=True)
        k = min(top_k, s.shape[0])
        scores.append(s)
        vals.append(v[:k])
        ids.append(i[:k] + cand.range("", 0, pos)[0])
    # the blocks in group order hold ascending ids, each block's top-k ties
    # in id order: a stable sort of the concatenation keeps ties in id order
    merged = []
    for v, i in zip(M.all_gather_groups(mesh, axes, vals),
                    M.all_gather_groups(mesh, axes, ids)):
        v, i = v.reshape(-1), i.reshape(-1)
        order = torch.sort(v, descending=True, stable=True).indices[:top_k]
        merged.append((v[order], i[order]))
    dev = mesh.devices[0]
    n = cand.shapes[""][0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    for pos, s in M.each(scores):
        out[slice(*cand.range("", 0, pos))] = s.to(dev)
    return out, merged[0][0], merged[0][1]
