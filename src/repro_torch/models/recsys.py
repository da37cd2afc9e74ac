"""DCN-v2 (arXiv:2008.13535): deep & cross network for CTR / ranking (the
port of the reference's ``models/recsys.py``).

Multi-hot sparse fields are looked up with the reference's EmbeddingBag
contract (``embedding_bag``): ids clipped into the table, -1 pads masked,
the rows summed (``mean`` divides by the count of real ids, at least 1).
``F.embedding_bag`` is not that contract (it neither clips nor masks -1),
so the lookup is a row gather (``scatter.gather``) and a masked sum.  The
gather's gradient is ``scatter.gather``'s scatter: on the card an accumulating
``index_put_`` over sorted ids, so a training step, and a restart from a
checkpoint, repeat bit for bit however many ids repeat.

The reference row-shards its tables over a mesh's ``model`` axis; the port
keeps every table whole on one device.

Three entry points mirror the assigned shapes:
  ctr_loss(params, cfg, batch)         train_batch / serve shapes (BCE)
  predict(params, cfg, batch)          serve_p99 / serve_bulk scoring
  retrieval_scores(params, cfg, ...)   1 query vs n_candidates (two-tower dot)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models.layers import _init_dense
from repro_torch.models.scatter import gather
from repro_torch.models.transformer import ParamTree, _tensor


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    vocab_sizes: tuple = ()            # per-field rows; default 1e6 each
    n_cross_layers: int = 3
    mlp_dims: tuple = (1024, 1024, 512)
    cross_rank: int = 0                # 0 = full-rank W (paper default DCN-v2)
    max_hots: int = 1                  # multi-hot width per sparse field
    structure: str = "stacked"         # stacked | parallel (paper fig.2)

    @property
    def vocabs(self) -> tuple:
        return self.vocab_sizes or tuple([1_000_000] * self.n_sparse)

    @property
    def d_x0(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def dcnv2_init(generator: torch.Generator, cfg: DCNv2Config,
               device=None) -> ParamTree:
    """Random weights with the reference's distributions (tables
    N(0, 0.01²), dense N(0, 1/d_in), biases 0), drawn from ``generator``
    (which must live on ``device``); trainable.  Not the reference's
    numbers: ``params_from_reference`` carries those across."""
    g = dict(generator=generator, device=device)
    d = cfg.d_x0
    p = {
        # one table per sparse field (row counts differ -> list, not stack)
        "tables": [torch.randn((v, cfg.embed_dim), **g) * 0.01
                   for v in cfg.vocabs],
        "cross": [],
        "mlp_w": [], "mlp_b": [],
    }
    zeros = dict(dtype=torch.float32, device=device)
    for _ in range(cfg.n_cross_layers):
        if cfg.cross_rank:
            p["cross"].append({
                "u": _init_dense(d_in=d, d_out=cfg.cross_rank, **g),
                "v": _init_dense(d_in=cfg.cross_rank, d_out=d, **g),
                "b": torch.zeros((d,), **zeros)})
        else:
            p["cross"].append({"w": _init_dense(d_in=d, d_out=d, **g),
                               "b": torch.zeros((d,), **zeros)})
    d_in = d
    for h in cfg.mlp_dims:
        p["mlp_w"].append(_init_dense(d_in=d_in, d_out=h, **g))
        p["mlp_b"].append(torch.zeros((h,), **zeros))
        d_in = h
    d_logit = (cfg.mlp_dims[-1] + d if cfg.structure == "parallel"
               else cfg.mlp_dims[-1])
    p["w_logit"] = _init_dense(d_in=d_logit, d_out=1, **g)
    p["b_logit"] = torch.zeros((1,), **zeros)
    return ParamTree(p, trainable=True)


_TOP_KEYS = {"tables", "cross", "mlp_w", "mlp_b", "w_logit", "b_logit"}


def params_from_reference(tree: dict, device=None) -> ParamTree:
    """The reference's parameter tree (``repro.models.recsys.dcnv2_init``),
    its leaves as numpy arrays, as trainable port parameters: the same keys
    and lists (``tables[f]``, ``cross[i]["w"]``)."""
    if set(tree) != _TOP_KEYS:
        raise ValueError(f"dcn-v2: the tree has keys {sorted(tree)}, "
                         f"expected {sorted(_TOP_KEYS)}")
    return ParamTree(T.tree_map(lambda a: _tensor(np.asarray(a), device),
                                tree), trainable=True)


# --------------------------------------------------------------------------
# EmbeddingBag: gather + masked reduction (the reference's contract)
# --------------------------------------------------------------------------

def embedding_bag(table, idx, mode: str = "sum"):
    """table: (V, D); idx: (B, H) int, -1 padded -> (B, D).

    The per-field bag: gather all H hot rows (ids clipped into [0, V)),
    mask pads, reduce."""
    V = table.shape[0]
    if idx.dim() == 1:
        idx = idx[:, None]
    mask = idx >= 0
    rows = gather(table, torch.clamp(idx, 0, V - 1).reshape(-1))
    rows = rows.reshape(idx.shape + (table.shape[1],))         # (B, H, D)
    rows = rows * mask[..., None].to(rows.dtype)
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    return out


def build_x0(params, cfg: DCNv2Config, dense, sparse_idx):
    """dense: (B, n_dense) float; sparse_idx: (B, n_sparse[, max_hots]) int."""
    if sparse_idx.dim() == 2:
        sparse_idx = sparse_idx[..., None]
    embs = [embedding_bag(params["tables"][f], sparse_idx[:, f])
            for f in range(cfg.n_sparse)]
    return torch.cat([dense] + embs, dim=-1)                   # (B, d_x0)


# --------------------------------------------------------------------------
# cross network + deep tower
# --------------------------------------------------------------------------

def cross_layer(lp, x0, x):
    if "u" in lp:                                   # low-rank DCN-v2 variant
        wx = (x @ lp["u"]) @ lp["v"]
    else:
        wx = x @ lp["w"]
    return x0 * (wx + lp["b"]) + x


def _deep(params, h):
    for w, b in zip(params["mlp_w"], params["mlp_b"]):
        h = torch.relu(h @ w + b)
    return h


def dcnv2_forward(params, cfg: DCNv2Config, dense, sparse_idx):
    x0 = build_x0(params, cfg, dense, sparse_idx)
    x = x0
    for lp in params["cross"]:
        x = cross_layer(lp, x0, x)
    h = _deep(params, x)
    if cfg.structure == "parallel":
        h = torch.cat([h, x], dim=-1)
    return (h @ params["w_logit"] + params["b_logit"])[..., 0]  # (B,)


def predict(params, cfg: DCNv2Config, batch):
    return torch.sigmoid(dcnv2_forward(params, cfg, batch["dense"],
                                       batch["sparse"]))


def ctr_loss(params, cfg: DCNv2Config, batch):
    """Binary cross entropy on click labels (B,)."""
    logits = dcnv2_forward(params, cfg, batch["dense"], batch["sparse"])
    y = batch["labels"].to(torch.float32)
    logits = logits.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# --------------------------------------------------------------------------
# retrieval: 1 query vs n_candidates (two-tower reuse of the same tables)
# --------------------------------------------------------------------------

def _unit_rows(h):
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                           min=1e-6)


def retrieval_scores(params, cfg: DCNv2Config, query_dense, query_sparse,
                     cand_emb, top_k: int = 100):
    """Score one query against a candidate matrix.

    query_dense: (1, n_dense); query_sparse: (1, n_sparse[, H]);
    cand_emb: (n_cand, d_q) candidate-tower embeddings (precomputed offline).
    Returns (scores (n_cand,), top-k values, top-k indices), the values in
    descending order.  Tied scores may come in another order than the
    reference's ``lax.top_k`` gives them."""
    q = _unit_rows(_deep(params, build_x0(params, cfg, query_dense,
                                          query_sparse)))       # (1, d_q)
    scores = (cand_emb @ q[0]).to(torch.float32)                # (n_cand,)
    top_v, top_i = torch.topk(scores, top_k)
    return scores, top_v, top_i


def make_candidate_tower(params, cfg: DCNv2Config, dense, sparse_idx):
    """Offline candidate embeddings through the same deep tower."""
    return _unit_rows(_deep(params, build_x0(params, cfg, dense,
                                             sparse_idx)))


def n_params(cfg: DCNv2Config) -> int:
    d = cfg.d_x0
    emb = sum(v * cfg.embed_dim for v in cfg.vocabs)
    cross = cfg.n_cross_layers * (
        (2 * d * cfg.cross_rank if cfg.cross_rank else d * d) + d)
    mlp, d_in = 0, d
    for h in cfg.mlp_dims:
        mlp += d_in * h + h
        d_in = h
    return emb + cross + mlp + d_in + 1
