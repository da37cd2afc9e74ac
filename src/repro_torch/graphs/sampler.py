"""Fanout neighbor sampler (GraphSAGE-style) — the ``minibatch_lg`` substrate.

The port of the reference's ``graphs/sampler.py``.  Two implementations:
  * `NeighborSampler` — host-side numpy sampler used by the data pipeline
    (the reference's code, so the same batches at the same seed).
    Produces fixed-shape (padded) `SampledBlock`s so the train step sees
    static shapes.
  * `sample_fanout_torch` — uniform-with-replacement sampler over an ELL
    adjacency on the device, for fully-on-device pipelines (the reference's
    `sample_fanout_jax`; its draws come from a `torch.Generator`, so they
    are other numbers than JAX's, with the same invariants).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from .csr import CSRGraph, FILL


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One message-passing block: edges from sampled srcs -> dst seeds.

    Shapes are static: n_dst seeds, each with exactly ``fanout`` sampled
    neighbor slots (FILL-padded where degree < fanout is impossible here since
    we sample with replacement; FILL marks isolated vertices).
    """

    dst_nodes: np.ndarray   # (n_dst,) global ids of destination nodes
    src_nodes: np.ndarray   # (n_src,) global ids (union of sampled + dsts first)
    nbr_local: np.ndarray   # (n_dst, fanout) local indices into src_nodes, FILL pad


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    seeds: np.ndarray             # (batch,) seed node ids
    blocks: tuple                 # one SampledBlock per layer, seed-side last
    node_ids: np.ndarray          # (n_input,) input-layer node ids (padded)


class NeighborSampler:
    """Uniform fanout sampler over a CSR graph with static output shapes."""

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int], seed: int = 0):
        self.g = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_layer(self, dst_nodes: np.ndarray, fanout: int) -> SampledBlock:
        """dst-PREFIX invariant: ``src_nodes[:len(dst_nodes)] == dst_nodes``.

        Chained across layers this makes every block's local indices valid in
        the outermost (input) layer's node list — the union-subgraph adapter
        (launch/cells.py) depends on it."""
        g = self.g
        n_dst = len(dst_nodes)
        deg = g.degrees[dst_nodes]
        # with-replacement uniform sample of `fanout` neighbors per dst
        r = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(n_dst, fanout))
        nbr = g.indices[g.indptr[dst_nodes][:, None] + r].astype(np.int64)
        nbr[deg == 0] = -1  # isolated
        new = np.setdiff1d(np.unique(nbr[nbr >= 0]), dst_nodes)
        src_nodes = np.concatenate([dst_nodes, new])
        # vectorized id -> local position (stable argsort + searchsorted)
        order = np.argsort(src_nodes, kind="stable")
        pos = np.searchsorted(src_nodes[order], np.where(nbr >= 0, nbr, src_nodes[0]))
        local = order[pos]
        local = np.where(nbr >= 0, local, FILL).astype(np.int32)
        return SampledBlock(dst_nodes=dst_nodes.astype(np.int64),
                            src_nodes=src_nodes.astype(np.int64),
                            nbr_local=local)

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        blocks = []
        dst = seeds
        for fanout in self.fanouts:          # outermost layer sampled last
            blk = self._sample_layer(dst, fanout)
            blocks.append(blk)
            dst = blk.src_nodes
        blocks = tuple(reversed(blocks))     # input-side block first
        return SampledBatch(seeds=seeds, blocks=blocks, node_ids=dst)

    def padded_sizes(self, batch: int) -> list[int]:
        """Static per-layer node-count caps (batch * prod(fanout+1) upper bound)."""
        sizes = [batch]
        for f in self.fanouts:
            sizes.append(sizes[-1] * (f + 1))
        return sizes


def pad_batch(batch: SampledBatch, sizes: Sequence[int], fanouts: Sequence[int]) -> dict:
    """Pad a SampledBatch to static shapes -> dict of arrays for the jitted step.

    Layout (L layers):
      nodes_k   : (sizes[L-k],) node ids of layer k input (k=0 is input layer)
      nbr_k     : (sizes[L-1-k], fanout_k) local indices into layer-k nodes
      n_valid_k : scalar count of valid dsts
    """
    L = len(batch.blocks)
    out = {}
    sizes = list(sizes)
    for k, blk in enumerate(batch.blocks):
        cap_src = sizes[L - k]
        cap_dst = sizes[L - 1 - k]
        fanout = fanouts[L - 1 - k]
        src_pad = np.full(cap_src, 0, dtype=np.int64)
        src_pad[: len(blk.src_nodes)] = blk.src_nodes
        nbr_pad = np.full((cap_dst, fanout), FILL, dtype=np.int32)
        nbr_pad[: len(blk.dst_nodes)] = blk.nbr_local
        out[f"nodes_{k}"] = src_pad
        out[f"nbr_{k}"] = nbr_pad
        out[f"n_valid_{k}"] = np.int32(len(blk.dst_nodes))
    out["seeds"] = np.pad(batch.seeds, (0, sizes[0] - len(batch.seeds)))
    return out


def union_caps(batch_nodes: int, fanouts_sampling: Sequence[int]) -> list[int]:
    """Static per-layer node caps, seed-side first: [batch, batch*(f0+1), ...]."""
    caps = [batch_nodes]
    for f in fanouts_sampling:
        caps.append(caps[-1] * (f + 1))
    return caps


def union_pad(batch: SampledBatch, batch_nodes: int,
              fanouts_sampling: Sequence[int],
              pad_edges_to: int = 8192) -> dict:
    """Flatten a SampledBatch into ONE static-shape union subgraph.

    Relies on the sampler's dst-prefix invariant: every block's local indices
    are valid positions in the input-layer node list.  Output (static shapes):
      nodes : (cap_in + 1,) global ids; last row is a SINK padding node
      src/dst: (E_cap,) local edge endpoints; masked edges become a
               sink->sink self-loop so they can never pollute real nodes
      seed outputs = model rows [0, batch_nodes)
    """
    caps = union_caps(batch_nodes, fanouts_sampling)
    cap_in = caps[-1]
    nodes = np.zeros(cap_in + 1, dtype=np.int64)
    nodes[: len(batch.node_ids)] = batch.node_ids
    srcs, dsts = [], []
    # batch.blocks are input-side first; seed-side block sampled first
    for k, blk in enumerate(reversed(batch.blocks)):   # seed-side first
        cap_dst = caps[k]
        f = fanouts_sampling[k]
        nbr = np.full((cap_dst, f), FILL, dtype=np.int32)
        nbr[: blk.nbr_local.shape[0]] = blk.nbr_local
        srcs.append(nbr.reshape(-1))
        dsts.append(np.repeat(np.arange(cap_dst, dtype=np.int32), f))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    if pad_edges_to:
        e_pad = -(-len(src) // pad_edges_to) * pad_edges_to
        src = np.concatenate([src, np.full(e_pad - len(src), FILL, np.int32)])
        dst = np.concatenate([dst, np.zeros(e_pad - len(dst), np.int32)])
    sink = np.int32(cap_in)
    dst = np.where(src >= 0, dst, sink).astype(np.int32)
    src = np.where(src >= 0, src, sink).astype(np.int32)
    return {"nodes": nodes, "src": src, "dst": dst}


def sample_fanout_torch(generator: torch.Generator, ell_nbr: torch.Tensor,
                        deg: torch.Tensor, seeds: torch.Tensor, fanout: int):
    """Uniform-with-replacement fanout sample over an ELL adjacency, on the
    tensors' device.

    generator: a ``torch.Generator`` on that device
    ell_nbr:   (n, max_deg) int32 neighbor table, FILL-padded
    deg:       (n,) int32 degrees
    seeds:     (b,) int32
    returns:   (b, fanout) sampled global neighbor ids (FILL where isolated)
    """
    b = seeds.shape[0]
    seeds = seeds.long()
    d = torch.clamp(deg[seeds], min=1).long()
    r = torch.randint(0, 2**31 - 1, (b, fanout), generator=generator,
                      device=ell_nbr.device) % d[:, None]
    nbr = torch.take_along_dim(ell_nbr[seeds], r, dim=1)
    return torch.where((deg[seeds] > 0)[:, None], nbr,
                       torch.full_like(nbr, int(FILL)))
