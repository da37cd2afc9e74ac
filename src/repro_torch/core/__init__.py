"""The paper's contribution: optimistic parallel graph coloring (RSOC) and its
predecessors (CAT, GM, JP), running on PyTorch with hand-written CUDA
kernels for the chunk pass; the reference's exports, and the port's
``prepare`` / problem types.
"""
from repro_torch.core.context import (  # noqa: F401
    DEFAULT_FORBIDDEN_IMPL, PassContext, resolve_impl,
)
from repro_torch.core.coloring import (  # noqa: F401
    ALGORITHMS, ColoringProblem, ColoringResult, color_cat, color_gm,
    color_jp, color_rsoc, greedy_sequential, is_proper, n_colors_used,
    prepare, problem_from_numpy,
)
from repro_torch.core.frontier import color_rsoc_compact  # noqa: F401
from repro_torch.core.distance2 import (  # noqa: F401
    color_bipartite_partial, color_distance2, color_distance_d,
    is_bipartite_partial_proper, is_distance_d_proper,
)
