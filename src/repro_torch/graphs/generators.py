"""Synthetic graph generators mirroring the paper's benchmark suite.

The paper evaluates on:
  - ``mesh2d``  : ~250k-vertex anisotropic 2D triangular mesh
  - ``bmw3_2``  : ~227k-vertex 3D tetrahedral mesh (UF collection)
  - ``pwtk``    : ~218k-vertex 3D tetrahedral mesh (UF collection)
  - RMAT-ER / RMAT-G / RMAT-B : 16M-vertex / 128M-edge R-MAT graphs with the
    Chakrabarti–Faloutsos partition probabilities used by Catalyurek et al.:
       ER (0.25, 0.25, 0.25, 0.25)   uniform degrees
       G  (0.45, 0.15, 0.15, 0.25)   mild skew
       B  (0.55, 0.15, 0.15, 0.15)   heavy skew / high-degree hubs
    with vertex ids randomly shuffled to destroy locality (paper §4).

We regenerate the same *classes* synthetically (UF downloads are unavailable
offline): structured triangulations for the 2D mesh, tetrahedralized grids for
the 3D meshes, and a faithful R-MAT sampler.  Sizes are parameterized; the
benchmark suite defaults to scaled-down instances sized for this container and
records the scale factor (DESIGN.md §9.5).
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges, shuffle_vertices


def rmat(scale: int, edge_factor: int = 8, a: float = 0.25, b: float = 0.25,
         c: float = 0.25, seed: int = 0, shuffle: bool = True) -> CSRGraph:
    """R-MAT generator (Chakrabarti & Faloutsos). n = 2**scale vertices."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    if d < -1e-9:
        raise ValueError("probabilities must sum <= 1")
    probs = np.array([a, b, c, max(d, 0.0)])
    probs = probs / probs.sum()
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    # vectorized bit-by-bit quadrant sampling
    for _ in range(scale):
        q = rng.choice(4, size=m, p=probs)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    g = from_edges(n, np.stack([src, dst], 1))
    if shuffle:
        g = shuffle_vertices(g, seed=seed + 1)
    return g


def rmat_er(scale: int, edge_factor: int = 8, seed: int = 0) -> CSRGraph:
    return rmat(scale, edge_factor, 0.25, 0.25, 0.25, seed=seed)


def rmat_g(scale: int, edge_factor: int = 8, seed: int = 0) -> CSRGraph:
    return rmat(scale, edge_factor, 0.45, 0.15, 0.15, seed=seed)


def rmat_b(scale: int, edge_factor: int = 8, seed: int = 0) -> CSRGraph:
    return rmat(scale, edge_factor, 0.55, 0.15, 0.15, seed=seed)


def mesh2d(nx: int, ny: int, anisotropy: float = 4.0, seed: int = 0) -> CSRGraph:
    """2D triangular mesh of a structured grid (each quad split into 2 tris).

    Vertex graph degree <= 8 like a CFD-adapted anisotropic triangulation;
    ``anisotropy`` only perturbs the split direction pattern (connectivity-level
    anisotropy), matching the paper's low-degree 2D regime.
    """
    n = nx * ny
    vid = lambda i, j: i * ny + j
    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    v00, v01 = vid(ii, jj), vid(ii, jj + 1)
    v10, v11 = vid(ii + 1, jj), vid(ii + 1, jj + 1)
    rng = np.random.default_rng(seed)
    # anisotropy-biased diagonal choice per quad
    diag = rng.random(len(ii)) < (anisotropy / (1.0 + anisotropy))
    # edges: quad boundary + one diagonal
    e = [np.stack([v00, v01], 1), np.stack([v00, v10], 1),
         np.stack([v01, v11], 1), np.stack([v10, v11], 1),
         np.stack([np.where(diag, v00, v01), np.where(diag, v11, v10)], 1)]
    return from_edges(n, np.concatenate(e, axis=0))


def mesh3d(nx: int, ny: int, nz: int) -> CSRGraph:
    """3D tetrahedral mesh of a structured grid (each cube -> 6 tets).

    Vertex graph degree up to ~26 — the same high-degree regime as bmw3_2/pwtk
    where the paper sees RSOC's largest advantage.
    """
    vid = lambda i, j, k: (i * ny + j) * nz + k
    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()
    c = {}
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c[(di, dj, dk)] = vid(ii + di, jj + dj, kk + dk)
    # 6-tet decomposition (Kuhn triangulation) of each cube
    tets = [
        (c[0, 0, 0], c[1, 0, 0], c[1, 1, 0], c[1, 1, 1]),
        (c[0, 0, 0], c[1, 0, 0], c[1, 0, 1], c[1, 1, 1]),
        (c[0, 0, 0], c[0, 1, 0], c[1, 1, 0], c[1, 1, 1]),
        (c[0, 0, 0], c[0, 1, 0], c[0, 1, 1], c[1, 1, 1]),
        (c[0, 0, 0], c[0, 0, 1], c[1, 0, 1], c[1, 1, 1]),
        (c[0, 0, 0], c[0, 0, 1], c[0, 1, 1], c[1, 1, 1]),
    ]
    edges = []
    for t in tets:
        for x in range(4):
            for y in range(x + 1, 4):
                edges.append(np.stack([t[x], t[y]], 1))
    return from_edges(nx * ny * nz, np.concatenate(edges, axis=0))


def bipartite_random(n_left: int, n_right: int, avg_left_degree: float = 4.0,
                     seed: int = 0) -> CSRGraph:
    """Random bipartite graph: vertices [0, n_left) are the left side,
    [n_left, n_left + n_right) the right; edges only cross sides.

    The Jacobian-sparsity analogue (left = columns, right = rows, edge =
    structural nonzero) driving ``core.distance2.color_bipartite_partial``.
    """
    rng = np.random.default_rng(seed)
    m = int(n_left * avg_left_degree)
    src = rng.integers(0, n_left, size=m)
    dst = n_left + rng.integers(0, n_right, size=m)
    return from_edges(n_left + n_right, np.stack([src, dst], axis=1))


def bipartite_banded(n_left: int, n_right: int, band: int = 3) -> CSRGraph:
    """Banded Jacobian sparsity pattern (1-D stencil discretization): column
    j hits the rows within ``band`` of its scaled diagonal position."""
    j = np.arange(n_left)
    diag = (j * n_right) // max(n_left, 1)
    blocks = []
    for off in range(-band, band + 1):
        i = diag + off
        ok = (i >= 0) & (i < n_right)
        blocks.append(np.stack([j[ok], n_left + i[ok]], axis=1))
    return from_edges(n_left + n_right, np.concatenate(blocks, axis=0))


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    edges = rng.integers(0, n, size=(m, 2))
    return from_edges(n, edges)


def random_geometric_positions(n: int, box: float = 10.0, seed: int = 0) -> np.ndarray:
    """Positions for molecule-like point clouds (NequIP inputs)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0, box, size=(n, 3)).astype(np.float32)


def radius_graph(positions: np.ndarray, cutoff: float, max_degree: int | None = None) -> CSRGraph:
    """Edges between points within ``cutoff`` (O(n^2) host build; molecule scale)."""
    n = len(positions)
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    mask = (d2 < cutoff * cutoff) & ~np.eye(n, dtype=bool)
    src, dst = np.nonzero(mask)
    g = from_edges(n, np.stack([src, dst], 1), symmetrize=False)
    if max_degree is not None and g.max_degree > max_degree:
        # keep the nearest max_degree neighbors per vertex
        keep_src, keep_dst = [], []
        for v in range(n):
            nb = g.neighbors(v)
            order = np.argsort(d2[v, nb])[:max_degree]
            keep_src.append(np.full(len(order), v)); keep_dst.append(nb[order])
        g = from_edges(n, np.stack([np.concatenate(keep_src), np.concatenate(keep_dst)], 1))
    return g


# ---- paper benchmark suite ------------------------------------------------

def paper_suite(scale: str = "small") -> dict[str, CSRGraph]:
    """The six graph classes of the paper's Table 1 at a CPU-feasible scale.

    scale='tiny'   : ~0.5-1k vertices  (CI bench-smoke, sub-second sections)
    scale='small'  : ~10-50k vertices  (unit/bench default, seconds)
    scale='medium' : ~250k vertex meshes + 2^18-vertex RMATs (paper-mesh-scale)
    """
    if scale == "tiny":
        return {
            "mesh2d": mesh2d(24, 24),
            "bmw3_2": mesh3d(8, 8, 8),
            "pwtk": mesh3d(10, 8, 6),
            "rmat_er": rmat_er(9),
            "rmat_g": rmat_g(9),
            "rmat_b": rmat_b(9),
        }
    if scale == "small":
        return {
            "mesh2d": mesh2d(128, 128),
            "bmw3_2": mesh3d(24, 24, 24),
            "pwtk": mesh3d(32, 24, 18),
            "rmat_er": rmat_er(13),
            "rmat_g": rmat_g(13),
            "rmat_b": rmat_b(13),
        }
    if scale == "medium":
        return {
            "mesh2d": mesh2d(500, 500),
            "bmw3_2": mesh3d(61, 61, 61),
            "pwtk": mesh3d(72, 55, 55),
            "rmat_er": rmat_er(18),
            "rmat_g": rmat_g(18),
            "rmat_b": rmat_b(18),
        }
    raise ValueError(scale)
