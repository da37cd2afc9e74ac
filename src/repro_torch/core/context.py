"""Typed pass context: the static configuration every gather pass closes over.

Originally this was a bare 5-tuple ``p_static = (n, n_pad, C, n_chunks,
impl)`` hand-rolled at every call site and positionally unpacked inside every
pass — the tuple's shape drifted once already (it grew a fifth element)
and nothing but convention kept the sites in sync.  ``PassContext`` replaces
it: one frozen dataclass, made by its classmethods, hashable.  PyTorch
runs eagerly, so it keys no compile cache here: it is a plain argument that
the loops read.

Shared by ``core/coloring.py``, ``core/frontier.py``, ``core/distance2.py``,
``core/distributed.py`` and ``dynamic/incremental.py``; derived from a
``repro_torch.api.ColoringSpec`` by the engine adapters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import bitset

# Forbidden-set representation used by every engine: "bitset" packs the
# (rows, C) table into (rows, C//32) int32 words (core/bitset.py), "dense"
# keeps the uint8 table and argmin mex — retained as the differential
# oracle.  Engines take ``forbidden_impl=None`` => this default.
DEFAULT_FORBIDDEN_IMPL = "bitset"


def resolve_impl(impl: Optional[str]) -> str:
    impl = DEFAULT_FORBIDDEN_IMPL if impl is None else impl
    if impl not in bitset.IMPLS:
        raise ValueError(
            f"unknown forbidden_impl {impl!r}; known: {bitset.IMPLS}")
    return impl


@dataclasses.dataclass(frozen=True)
class PassContext:
    """Static per-pass configuration (fixed for the whole of one solve attempt).

    ``n``       live vertices (rows past it are padding)
    ``n_pad``   padded row count of the device arrays
    ``C``       color cap (doubles on overflow via ``_run_with_retry``)
    ``n_chunks`` sequential chunks per pass (1/threads of the paper)
    ``forbidden_impl`` forbidden-set representation ("bitset" | "dense")
    ``trace``   collect per-round trace extras (frontier sizes) in the loop
                (DESIGN.md §12).  ``trace=False`` runs the exact pre-obs loop
                — zero extra device work, allocations or host read-backs
                when off — while ``trace=True`` selects the traced loop,
                which pays for what it measures.
    """

    n: int
    n_pad: int
    C: int
    n_chunks: int
    forbidden_impl: str = DEFAULT_FORBIDDEN_IMPL
    trace: bool = False

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1 (got {self.n_chunks})")
        if self.C < 1:
            raise ValueError(f"C must be >= 1 (got {self.C})")
        if self.n_pad < self.n:
            raise ValueError(
                f"n_pad {self.n_pad} < n {self.n} (padding cannot shrink)")
        resolve_impl(self.forbidden_impl)

    @classmethod
    def for_problem(cls, prob, *, n_chunks: int, C: Optional[int] = None,
                    forbidden_impl: Optional[str] = None,
                    trace: bool = False) -> "PassContext":
        """Context for a prepared ``ColoringProblem`` (the standard constructor:
        every engine derives its contexts here or via ``with_C``).  The
        problem does not record a chunking, so ``n_chunks`` is explicit."""
        return cls(n=prob.n, n_pad=prob.n_pad,
                   C=int(C if C is not None else prob.C),
                   n_chunks=int(n_chunks),
                   forbidden_impl=resolve_impl(forbidden_impl),
                   trace=bool(trace))

    def with_C(self, C: int) -> "PassContext":
        """Same context at a (doubled) color cap — the retry loop's constructor."""
        return dataclasses.replace(self, C=int(C))

    def unpack(self) -> tuple[int, int, int, int, str]:
        """Positional view ``(n, n_pad, C, n_chunks, forbidden_impl)`` for
        the pass bodies.  The order is defined HERE and nowhere else.
        ``trace`` is deliberately NOT part of the positional view — the few
        round loops that collect trace extras read ``ctx.trace`` directly,
        the pass bodies never need it."""
        return (self.n, self.n_pad, self.C, self.n_chunks,
                self.forbidden_impl)
