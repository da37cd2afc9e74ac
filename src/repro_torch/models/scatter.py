"""Row gather and segment sum with deterministic scatters, shared by the
model families (the GNNs, NequIP, DCN-v2's embedding bags, the MoE
combine).

``jax.ops.segment_sum`` gives the same bits every run.  ``index_add_`` on a
CUDA tensor adds with float atomics, in an order that changes from run to
run, and so does the backward of a row gather (an ``index_add_`` of the
gradient rows).  On a CUDA tensor both scatters here are an accumulating
``index_put_``, which sorts the indices and adds each row's entries in
order (what ``index_add_`` does under
``torch.use_deterministic_algorithms(True)``, without that process-wide
mode), so a training step, and a restart from a checkpoint, repeat bit for
bit on the card.  ``atomic_scatter()`` takes ``index_add_`` for a scope (to
measure what the sorted adds cost).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels.cost import on_card

_ATOMIC = contextvars.ContextVar("gnn_atomic_scatter", default=False)


@contextlib.contextmanager
def atomic_scatter():
    """Within the scope the scatters add with float atomics (the order, and
    so the bits, may change from run to run on the card)."""
    token = _ATOMIC.set(True)
    try:
        yield
    finally:
        _ATOMIC.reset(token)


def _scatter_add(src: torch.Tensor, idx: torch.Tensor, n: int,
                 atomic: bool) -> torch.Tensor:
    out = src.new_zeros((n,) + tuple(src.shape[1:]))
    if atomic or not on_card(src):     # the CPU adds in index order anyway
        return out.index_add_(0, idx, src)
    return out.index_put_((idx.long(),), src, accumulate=True)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        ctx.atomic = _ATOMIC.get()     # the backward runs on another thread
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_add(g, idx, ctx.n, ctx.atomic), None


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows); its gradient is a deterministic scatter."""
    return _Gather.apply(table, idx)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, n: int):
    """``jax.ops.segment_sum(data, seg, n)``: an id outside [0, n)
    contributes nothing (``MoleculeStream``'s sink has ``graph_id`` n).
    Such ids go to an extra row n, dropped after the scatter, so there is no
    host sync, and where every id is in range the rows get the same adds
    in the same order.  The sum is deterministic (see the module's
    docstring).  Its gradient is a row gather, which has no collisions."""
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    return _scatter_add(data, seg, n + 1, _ATOMIC.get())[:n]
