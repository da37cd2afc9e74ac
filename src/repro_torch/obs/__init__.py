"""``repro_torch.obs`` — tracing + metrics with zero device overhead when off
(DESIGN.md §12).

Three pieces:

  * ``obs.trace``   — the ``RunTrace`` artifact and the ``trace()`` scope
                      (``ColoringResult.trace`` when ``ColoringSpec.trace``
                      or a ``trace()`` scope or ``REPRO_TRACE=1`` is on);
  * ``obs.metrics`` — always-on process-local counters/histograms (kernel
                      dispatch/fallback decisions, engine cap-retries,
                      service memo hit/miss and step latency);
  * ``obs.export``  — JSON-lines trace dumps + NVTX range annotation
                      scopes.

This package imports no engine code: engines import *it*, through exactly
two hooks (``current_tracer()`` and the static ``PassContext.trace`` flag),
which is what keeps the when-off path bit-identical to a build without the
subsystem.
"""
from repro_torch.obs import export, metrics
from repro_torch.obs.trace import (PhaseEvent, RoundEvent, RunTrace, TraceCollector,
                             active_collector, collect, current_tracer, phase,
                             run_tracer, trace, tracing_enabled)

__all__ = [
    "PhaseEvent",
    "RoundEvent",
    "RunTrace",
    "TraceCollector",
    "active_collector",
    "collect",
    "current_tracer",
    "export",
    "metrics",
    "phase",
    "run_tracer",
    "trace",
    "tracing_enabled",
]
