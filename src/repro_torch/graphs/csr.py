"""Graph containers: CSR (host-side) and ELL (device-side, gather-friendly).

The coloring kernels and the GNN aggregation kernel both consume the ELL
(padded-neighbor) layout: a rectangular ``(n_vertices, max_degree)`` int32 array
of neighbor ids with a fill sentinel.  A rectangular table gives every row the
same stride, so a kernel finds row r at ``r * max_degree`` without an indptr
load; CSR pointer-chasing does not.  CSR remains the host/pipeline format (compact,
easy to sample from); `to_ell` is the boundary between the two.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FILL = np.int32(-1)  # ELL padding sentinel


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected graph in CSR form (both directions stored)."""

    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    n_vertices: int

    @property
    def n_edges(self) -> int:
        """Directed edge count (2x undirected)."""
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n_vertices else 0

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_vertices + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        if len(self.indices):
            assert self.indices.min() >= 0 and self.indices.max() < self.n_vertices


def from_edges(n_vertices: int, edges: np.ndarray, symmetrize: bool = True) -> CSRGraph:
    """Build a CSR graph from an (m, 2) edge array; dedups and removes self-loops."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # dedup via flat key
    key = edges[:, 0] * n_vertices + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key = key[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    edges = edges[order][keep]
    src, dst = edges[:, 0], edges[:, 1]
    counts = np.bincount(src, minlength=n_vertices)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32), n_vertices=n_vertices)


def to_edge_list(g: CSRGraph) -> np.ndarray:
    """(nnz, 2) directed edge list (src, dst)."""
    src = np.repeat(np.arange(g.n_vertices, dtype=np.int32), g.degrees)
    return np.stack([src, g.indices], axis=1)


def to_ell(g: CSRGraph, max_degree: Optional[int] = None, pad_vertices_to: Optional[int] = None) -> np.ndarray:
    """CSR -> ELL padded neighbor array (n_pad, max_degree) int32, FILL-padded.

    Vertices whose degree exceeds ``max_degree`` raise (callers should cap via
    graph preprocessing or pick max_degree >= g.max_degree).
    """
    md = int(max_degree if max_degree is not None else g.max_degree)
    if g.max_degree > md:
        raise ValueError(f"max_degree {md} < graph max degree {g.max_degree}")
    n = g.n_vertices
    n_pad = int(pad_vertices_to if pad_vertices_to is not None else n)
    deg = g.degrees
    ell = np.full((n_pad, max(md, 1)), FILL, dtype=np.int32)
    # vectorized fill: position of each entry within its row
    if g.n_edges:
        row = np.repeat(np.arange(n), deg)
        col = np.arange(g.n_edges) - np.repeat(g.indptr[:-1], deg)
        ell[row, col] = g.indices
    return ell


def ell_to_edges(ell: np.ndarray, n: int,
                 ovf_src: Optional[np.ndarray] = None,
                 ovf_dst: Optional[np.ndarray] = None) -> np.ndarray:
    """ELL (+ optional COO overflow) -> (m, 2) directed edge list.

    The inverse boundary of `to_ell` for the *mutable* encoding
    (DESIGN.md §7.1): FILL slots — empty ELL cells and freed overflow
    entries — are skipped, so a slot table mutated by insert/delete batches
    decodes to exactly its live edge set.
    """
    ell = np.asarray(ell)[:n]
    row, slot = np.nonzero(ell >= 0)
    src = row.astype(np.int64)
    dst = ell[row, slot].astype(np.int64)
    if ovf_src is not None and len(ovf_src):
        os_np, od_np = np.asarray(ovf_src), np.asarray(ovf_dst)
        live = (os_np >= 0) & (od_np >= 0)
        src = np.concatenate([src, os_np[live].astype(np.int64)])
        dst = np.concatenate([dst, od_np[live].astype(np.int64)])
    return np.stack([src, dst], axis=1)


def from_ell(ell: np.ndarray, n: int,
             ovf_src: Optional[np.ndarray] = None,
             ovf_dst: Optional[np.ndarray] = None) -> CSRGraph:
    """Rebuild a CSRGraph from the (possibly mutated) device encoding."""
    return from_edges(n, ell_to_edges(ell, n, ovf_src, ovf_dst),
                      symmetrize=False)


def shuffle_vertices(g: CSRGraph, seed: int = 0) -> CSRGraph:
    """Random relabel of vertex ids (paper shuffles RMAT ids to kill locality)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.n_vertices).astype(np.int64)
    edges = to_edge_list(g).astype(np.int64)
    edges = perm[edges]
    return from_edges(g.n_vertices, edges, symmetrize=False)


def power_graph(g: CSRGraph, d: int) -> CSRGraph:
    """G^d: connect u,v iff dist(u,v) <= d.  Used for distance-d coloring (paper §6).

    BFS-free construction by repeated neighbor expansion; fine for the scales we
    color on CPU.
    """
    if d < 1:
        raise ValueError("d must be >= 1")
    if d == 1:
        return g
    # adjacency as set-of-arrays, expand d-1 times
    frontier_indptr, frontier_indices = g.indptr, g.indices
    all_src = [np.repeat(np.arange(g.n_vertices, dtype=np.int64), np.diff(g.indptr))]
    all_dst = [g.indices.astype(np.int64)]
    for _ in range(d - 1):
        # next frontier: neighbors of current frontier entries
        deg = np.diff(g.indptr)
        src = np.repeat(all_src[-1], deg[all_dst[-1]])
        starts = g.indptr[all_dst[-1]]
        counts = deg[all_dst[-1]]
        # gather neighbor blocks
        offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        dst = g.indices[np.repeat(starts, counts) + offs].astype(np.int64)
        all_src.append(src)
        all_dst.append(dst)
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    return from_edges(g.n_vertices, np.stack([src, dst], 1), symmetrize=True)


def degree_histogram(g: CSRGraph, bins: int = 10) -> dict:
    deg = g.degrees
    return {
        "min": int(deg.min()), "max": int(deg.max()),
        "mean": float(deg.mean()), "p99": float(np.percentile(deg, 99)),
    }
