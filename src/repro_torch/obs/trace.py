"""Structured run tracing: the ``RunTrace`` artifact (DESIGN.md §12).

The paper's whole argument is a set of runtime trajectories — conflicts per
round, repair rounds, colors per iteration (Figs. 3–6) — and this module is
how an ``api.color`` call produces one without anyone editing engine
internals.  Three switches turn tracing on, any one suffices:

  * ``ColoringSpec.trace=True``     — trace this one call;
  * ``with obs.trace() as tc: ...`` — trace every call in the scope and
                                       collect the artifacts on ``tc``;
  * ``REPRO_TRACE=1`` in the env    — force-trace the whole process (CI).

Zero overhead when off, by construction rather than by measurement: the
per-round conflict counts already ride the engines' round loop as a device
buffer (they always did — ``ColoringResult.conflicts_per_round``), host
wall timers only bracket whole phases, and the one genuinely new
device-side collection (per-round frontier sizes) is gated on the
``PassContext.trace`` flag, so a ``trace=False`` call launches exactly the
work it launched before this module existed — no extra reduction, no
extra host read-back, no ``torch.cuda.synchronize()``.

A ``RunTrace`` is assembled host-side when the engine returns: round events
from the loop's device-resident conflict/frontier traces, phase events from the
wall timers the engines already pass through (``prepare`` / ``solve`` per
cap-retry attempt / ``serial_repair`` …), retry and cap data from the
result.  Engines touch this module through exactly two hooks —
``current_tracer()`` (None when off) and ``RunTracer.phase`` — so a new
engine gets traced by doing nothing at all, and gets *phase-resolved*
tracing with two lines.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np


def _env_forced() -> bool:
    return os.environ.get("REPRO_TRACE", "") not in ("", "0", "false", "off")


# --------------------------------------------------------------------------
# the artifact
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One repair round of the engine's while-loop."""

    round: int            # 0-based repair round index
    conflicts: int        # defects detected (== conflicts_per_round[round])
    frontier: int = -1    # |U| at round start (-1: engine does not collect)
    compacted: Optional[bool] = None   # frontier-compacted engines only:
    #                                    did this round take the small pass?


@dataclasses.dataclass(frozen=True)
class PhaseEvent:
    """One host-timed phase (the engine synchronizes the device on the
    phase's outputs before the timer stops)."""

    name: str             # prepare | solve | serial_repair | ...
    wall_s: float
    meta: dict = dataclasses.field(default_factory=dict)   # e.g. C, attempt


@dataclasses.dataclass(frozen=True)
class RunTrace:
    """Typed trajectory of one ``api.color`` run (DESIGN.md §12 schema)."""

    spec_key: str                 # resolved ColoringSpec identity
    engine: str                   # "algorithm/distance/mode/backend"
    n_vertices: int
    n_rounds: int
    rounds: tuple                 # tuple[RoundEvent, ...]
    phases: tuple                 # tuple[PhaseEvent, ...]
    retries: int                  # cap-doubling re-runs
    final_C: int
    gather_passes: int
    total_conflicts: int
    n_colors: int
    truncated: bool               # rounds beyond MAX_ROUNDS_TRACE collapsed
    wall_s: float                 # whole engine call, host-side

    @property
    def conflicts_per_round(self) -> np.ndarray:
        """Per-round conflict counts — exactly
        ``ColoringResult.conflicts_per_round`` of the run this traced."""
        return np.asarray([e.conflicts for e in self.rounds], np.int64)

    def phase_wall_s(self, name: str) -> float:
        return sum(p.wall_s for p in self.phases if p.name == name)

    def summary_line(self) -> str:
        """One-line human summary (the quickstart prints this)."""
        conf = ">".join(str(e.conflicts) for e in self.rounds[:8])
        if len(self.rounds) > 8:
            conf += ">…"
        trunc = " TRUNCATED" if self.truncated else ""
        return (f"trace[{self.engine}] n={self.n_vertices} "
                f"rounds={self.n_rounds}{trunc} conflicts={conf or '0'} "
                f"colors={self.n_colors} C={self.final_C} "
                f"retries={self.retries} passes={self.gather_passes} "
                f"wall={self.wall_s * 1e3:.1f}ms")

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# live tracer (one per engine run) + collector (one per trace() scope)
# --------------------------------------------------------------------------

_TLS = threading.local()


class RunTracer:
    """Mutable scratchpad an engine run writes into; ``finish`` freezes it
    into a ``RunTrace``.  Engines reach it via ``current_tracer()``."""

    def __init__(self):
        self._phases: list[PhaseEvent] = []
        self._frontier: Optional[np.ndarray] = None
        self._compact_cap: Optional[int] = None
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        """Wall-time one engine phase.  The body must block on its device
        outputs (``torch.cuda.synchronize()`` / host conversion) for the timer
        to mean anything; the standard call sites do.  Also opens an
        NVTX range scope so device profiles show the same
        phase names (``obs.export.annotate``)."""
        from repro_torch.obs.export import annotate
        t0 = time.perf_counter()
        with annotate(f"repro_torch.{name}"):
            yield
        self._phases.append(PhaseEvent(name=name,
                                       wall_s=time.perf_counter() - t0,
                                       meta=dict(meta)))

    def phase_wall_s(self, name: str) -> float:
        """Summed wall seconds of the phases called ``name`` so far."""
        return sum(p.wall_s for p in self._phases if p.name == name)

    def set_frontier_trace(self, frontier, cap: Optional[int] = None) -> None:
        """Per-round |U| counts from the loop carry (engines that collect
        them under the static ``ctx.trace`` flag).  ``cap``: the compacted
        frontier capacity, when the engine has one — lets the round events
        say whether the round took the compacted or the full-width pass."""
        self._frontier = np.asarray(frontier)
        self._compact_cap = cap

    def finish(self, result, spec, engine_key: str,
               n_vertices: int) -> RunTrace:
        conf = np.asarray(result.conflicts_per_round).reshape(-1)
        rounds = []
        for i, c in enumerate(conf.tolist()):
            fr_sz = -1
            compacted = None
            if self._frontier is not None and i < len(self._frontier):
                fr_sz = int(self._frontier[i])
                if self._compact_cap is not None:
                    compacted = fr_sz <= self._compact_cap
            rounds.append(RoundEvent(round=i, conflicts=int(c),
                                     frontier=fr_sz, compacted=compacted))
        return RunTrace(
            spec_key=spec.spec_key(), engine=engine_key,
            n_vertices=int(n_vertices), n_rounds=int(result.n_rounds),
            rounds=tuple(rounds), phases=tuple(self._phases),
            retries=int(result.retries), final_C=int(result.final_C),
            gather_passes=int(result.gather_passes),
            total_conflicts=int(result.total_conflicts),
            n_colors=int(result.n_colors),
            truncated=bool(result.trace_truncated),
            wall_s=time.perf_counter() - self._t0)


class TraceCollector:
    """Accumulates the ``RunTrace`` of every ``api.color`` call in a
    ``trace()`` scope."""

    def __init__(self):
        self.traces: list[RunTrace] = []

    def append(self, t: RunTrace) -> None:
        self.traces.append(t)

    def __len__(self) -> int:
        return len(self.traces)


def current_tracer() -> Optional[RunTracer]:
    """The tracer of the engine run in flight on this thread, or None —
    THE switch every engine-side hook checks (None => do nothing extra)."""
    return getattr(_TLS, "tracer", None)


def phase(name: str, **meta):
    """``current_tracer().phase(...)`` or a no-op scope — the one-line way
    for an engine to mark a phase without checking for a tracer first."""
    t = current_tracer()
    return t.phase(name, **meta) if t is not None else contextlib.nullcontext()


def active_collector() -> Optional[TraceCollector]:
    return getattr(_TLS, "collector", None)


def tracing_enabled(spec_trace: bool = False) -> bool:
    """Should the next ``api.color`` call be traced?"""
    return bool(spec_trace) or active_collector() is not None or _env_forced()


@contextlib.contextmanager
def run_tracer():
    """Install a fresh ``RunTracer`` for one engine run (``api.color``'s
    internal scope — engines never call this)."""
    prev = getattr(_TLS, "tracer", None)
    tracer = RunTracer()
    _TLS.tracer = tracer
    try:
        yield tracer
    finally:
        _TLS.tracer = prev


@contextlib.contextmanager
def trace():
    """Trace every ``api.color`` call in the scope and collect the
    artifacts::

        with obs.trace() as tc:
            api.color(g)                      # traced, spec untouched
        print(tc.traces[0].summary_line())
    """
    prev = getattr(_TLS, "collector", None)
    collector = TraceCollector()
    _TLS.collector = collector
    try:
        yield collector
    finally:
        _TLS.collector = prev


def collect(t: RunTrace) -> None:
    """Hand a finished trace to the active collector, if any."""
    c = active_collector()
    if c is not None:
        c.append(t)
