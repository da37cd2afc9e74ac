"""The paper's contribution: optimistic parallel graph coloring (RSOC),
running on PyTorch with hand-written CUDA kernels for the chunk pass.
"""
from repro_torch.core.context import (  # noqa: F401
    DEFAULT_FORBIDDEN_IMPL, PassContext, resolve_impl,
)
from repro_torch.core.coloring import (  # noqa: F401
    ColoringProblem, ColoringResult, greedy_sequential, is_proper,
    n_colors_used, prepare, problem_from_numpy,
)
