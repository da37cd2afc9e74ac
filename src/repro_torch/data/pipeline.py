"""Synthetic, seeded, checkpointable data streams for every arch family
(the port of the reference's ``data/pipeline.py``: numpy, the same code, so
the same batches bit for bit at the same seed and step).

Every stream exposes:
  state()            -> json-serializable dict (stored in checkpoints)
  restore(state)     -> resume exactly (deterministic counter-based RNG)
  __next__           -> dict of numpy arrays with static shapes

Determinism: batches are a pure function of (seed, step) via
``np.random.default_rng(hash((seed, step)))`` — restoring from a checkpoint
at step k reproduces the identical remaining stream, so a restart after a
node failure is bitwise-reproducible (fault-tolerance requirement).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.graphs.csr import CSRGraph, to_edge_list
from repro_torch.graphs.sampler import NeighborSampler, union_caps, union_pad


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(seed * 0x9E3779B9 + step * 2654435761))


class Stream:
    """Base: counter-based, restartable."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.step = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self._make(_rng(self.seed, self.step))
        self.step += 1
        return b

    def _make(self, rng) -> dict:
        raise NotImplementedError


class TokenStream(Stream):
    """LM tokens: zipf-distributed ids (realistic logit/loss magnitudes)."""

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0):
        super().__init__(seed)
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab

    def _make(self, rng):
        toks = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(toks, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class RecsysStream(Stream):
    def __init__(self, batch: int, n_dense: int, n_sparse: int, vocabs,
                 max_hots: int = 1, seed: int = 0):
        super().__init__(seed)
        self.batch, self.n_dense, self.n_sparse = batch, n_dense, n_sparse
        self.vocabs = list(vocabs)
        self.max_hots = max_hots

    def _make(self, rng):
        dense = rng.standard_normal((self.batch, self.n_dense)).astype(np.float32)
        sp = np.stack([rng.integers(0, v, size=(self.batch, self.max_hots))
                       for v in self.vocabs], axis=1).astype(np.int32)
        if self.max_hots > 1:  # ragged bags: pad a random suffix
            kill = rng.random((self.batch, self.n_sparse, self.max_hots)) < 0.3
            kill[..., 0] = False
            sp[kill] = -1
        # click labels correlated with a fixed random hyperplane (learnable)
        w = _rng(self.seed, 0).standard_normal(self.n_dense)
        p = 1.0 / (1.0 + np.exp(-(dense @ w) / np.sqrt(self.n_dense)))
        labels = (rng.random(self.batch) < p).astype(np.int32)
        return {"dense": dense, "sparse": sp, "labels": labels}


class FullGraphStream(Stream):
    """Full-batch GNN: fixed graph + features, fresh train mask per step.

    Emits the cell layout: one SINK node appended, edges padded to a
    multiple of ``pad_edges_to`` with sink->sink self-loops (launch/cells)."""

    def __init__(self, graph: CSRGraph, d_feat: int, n_classes: int,
                 seed: int = 0, pad_edges_to: int = 8192):
        super().__init__(seed)
        g = graph
        rng0 = _rng(seed, 0)
        e = to_edge_list(g)
        n1 = g.n_vertices + 1                   # + sink
        sink = g.n_vertices
        E = len(e)
        e_pad = -(-max(E, 1) // pad_edges_to) * pad_edges_to if pad_edges_to \
            else E
        src = np.full(e_pad, sink, np.int32)
        dst = np.full(e_pad, sink, np.int32)
        src[:E] = e[:, 0]
        dst[:E] = e[:, 1]
        feats = rng0.standard_normal((n1, d_feat)).astype(np.float32)
        feats[sink] = 0.0
        self.const = {
            "src": src, "dst": dst, "feats": feats,
            "labels": rng0.integers(0, n_classes, n1).astype(np.int32),
        }
        self.n_nodes = n1
        self.sink = sink

    def _make(self, rng):
        mask = rng.random(self.n_nodes) < 0.6   # train split mask per step
        mask[self.sink] = False
        return dict(self.const, train_mask=mask.astype(np.float32))


class SampledGraphStream(Stream):
    """Minibatch GNN via the fanout sampler, flattened to one static-shape
    union subgraph (see sampler.union_pad).  ``fanouts`` are given input-side
    first (the published convention, e.g. 15-10); sampling expands seed-side
    first, so the sampler runs them reversed."""

    def __init__(self, graph: CSRGraph, d_feat: int, n_classes: int,
                 batch_nodes: int, fanouts, seed: int = 0):
        super().__init__(seed)
        self.g = graph
        self.batch_nodes = batch_nodes
        self.fanouts = tuple(fanouts)
        self.fanouts_sampling = tuple(reversed(self.fanouts))
        self.sampler = NeighborSampler(graph, self.fanouts_sampling, seed)
        rng0 = _rng(seed, 0)
        self.feats = rng0.standard_normal((graph.n_vertices, d_feat)).astype(np.float32)
        self.labels = rng0.integers(0, n_classes, graph.n_vertices).astype(np.int32)

    def restore(self, state):
        super().restore(state)
        self.sampler = NeighborSampler(self.g, self.fanouts_sampling, self.seed)

    def _make(self, rng):
        n = self.g.n_vertices
        seeds = rng.choice(n, size=min(self.batch_nodes, n), replace=False)
        if len(seeds) < self.batch_nodes:   # tiny graphs: repeat is fine
            seeds = np.resize(seeds, self.batch_nodes)
        batch = self.sampler.sample(seeds)
        out = union_pad(batch, self.batch_nodes, self.fanouts_sampling)
        feats = self.feats[out["nodes"] % n]
        feats[-1] = 0.0                      # sink row
        out["feats"] = feats
        out["labels"] = self.labels[seeds].astype(np.int32)
        return out


class MoleculeStream(Stream):
    """Batched small graphs, flattened block-diagonally (static shapes)."""

    def __init__(self, n_nodes: int, n_edges: int, batch: int,
                 n_species: int = 8, box: float = 6.0, seed: int = 0,
                 d_feat: int = 16):
        super().__init__(seed)
        self.n_nodes, self.n_edges, self.batch = n_nodes, n_edges, batch
        self.n_species, self.box, self.d_feat = n_species, box, d_feat

    def _make(self, rng, pad_edges_to: int = 8192):
        B, N, E = self.batch, self.n_nodes, self.n_edges
        pos = rng.uniform(0, self.box, (B, N, 3)).astype(np.float32)
        species = rng.integers(0, self.n_species, (B, N)).astype(np.int32)
        # E random pairs per graph (messages flow both directions anyway)
        src = rng.integers(0, N, (B, E)).astype(np.int32)
        off = rng.integers(1, N, (B, E)).astype(np.int32)
        dst = ((src + off) % N).astype(np.int32)
        base = (np.arange(B, dtype=np.int32) * N)[:, None]
        energy = np.sin(pos.sum((1, 2))).astype(np.float32)   # learnable target
        sink = B * N                              # + sink node, padded edges
        e_flat_s = (src + base).reshape(B * E)
        e_flat_d = (dst + base).reshape(B * E)
        e_pad = -(-len(e_flat_s) // pad_edges_to) * pad_edges_to \
            if pad_edges_to else len(e_flat_s)
        pad = e_pad - len(e_flat_s)
        graph_id = np.concatenate([np.repeat(np.arange(B, dtype=np.int32), N),
                                   np.int32([B])])   # sink -> dropped segment
        return {
            "positions": np.concatenate([pos.reshape(B * N, 3),
                                         np.zeros((1, 3), np.float32)]),
            "species": np.concatenate([species.reshape(B * N),
                                       np.int32([0])]),
            "src": np.concatenate([e_flat_s,
                                   np.full(pad, sink, np.int32)]),
            "dst": np.concatenate([e_flat_d,
                                   np.full(pad, sink, np.int32)]),
            "graph_id": graph_id,
            "energy": energy,
            "feats": np.concatenate([
                rng.standard_normal((B * N, self.d_feat)).astype(np.float32),
                np.zeros((1, self.d_feat), np.float32)]),
        }
