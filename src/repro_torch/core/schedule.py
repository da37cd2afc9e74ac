"""Coloring-derived execution schedules (the paper's motivating use-case;
the port of the reference's ``core/schedule.py``).

A graph coloring partitions work-items into independent sets; here we build
the schedules our substrates consume:

  * ``edge_color_by_dst`` — color edges such that no two edges sharing a
    destination share a color (exact greedy on the dst-bucket rank).  Each
    color class is then a conflict-free scatter (deterministic
    aggregation).
  * ``vertex_schedule`` — order vertices color-by-color (independent sets)
    for safe parallel execution of vertex kernels (PRAgMaTIc-style mesh
    adaptivity, the paper's own application).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import coloring as col
from repro_torch.graphs.csr import CSRGraph


def edge_color_by_dst(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Color edges s.t. edges sharing a dst get distinct colors.

    Exact and linear-time: the k-th edge of a dst bucket gets color k (the
    conflict graph between same-dst edges is a clique; rank = optimal).
    Returns (edge_colors (E,), n_colors)."""
    order = np.argsort(dst, kind="stable")
    ranks = np.zeros(len(dst), np.int32)
    prev, r = -1, 0
    for idx in order:
        if dst[idx] != prev:
            prev, r = dst[idx], 0
        ranks[idx] = r
        r += 1
    n_colors = int(ranks.max()) + 1 if len(ranks) else 1
    return ranks, n_colors


def vertex_schedule(g: CSRGraph, algorithm: str = "rsoc", seed: int = 0,
                    *, max_rounds: int = 1000,
                    forbidden_impl: str | None = None, spec=None,
                    device=None):
    """Vertices grouped into independent sets (list of index arrays), and
    the ``ColoringResult`` behind them.

    Routes through ``repro_torch.api.color`` — pass ``spec=`` for full
    control, or the common knobs directly.  ``device`` as for
    ``api.color`` (None: CUDA, raising where there is none).
    """
    from repro_torch import api
    if spec is None:
        spec = api.ColoringSpec(algorithm=algorithm, seed=seed,
                                max_rounds=max_rounds,
                                forbidden_impl=forbidden_impl)
    res = api.color(g, spec, device=device)
    assert col.is_proper(g, res.colors)
    return [np.nonzero(res.colors == c)[0] for c in range(res.n_colors)], res
