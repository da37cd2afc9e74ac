"""Process-local counters and histograms (DESIGN.md §12).

The decisions that used to be invisible — which kernel backend a dispatch
actually took, whether a kernel dispatch was forced onto its plain torch
version by the ``kernel.fallback`` fault site, how many cap-doubling retries
an engine burned, whether a ``ColoringService`` artifact query hit the
version memo — are counted here, always, because a host-side integer
increment is free next to a kernel launch.  Latency distributions
(service step time per tenant) land in fixed-reservoir histograms.

Naming convention (DESIGN.md §12): dotted ``subsystem.event`` names plus
sorted ``{key=value}`` labels, e.g.::

    kernels.dispatch{backend=cuda,kernel=firstfit}
    kernels.fallback{kernel=firstfit,reason=forced}
    engine.cap_retry{algorithm=rsoc}
    service.memo{graph=mesh,kind=vertex_schedule,outcome=hit}
    service.step_ms{graph=mesh}            (histogram)

The registry is process-local and thread-safe; it is NOT a metrics *export*
system — ``snapshot()`` hands the current values to whatever sink the caller
wires up (tests assert on it directly, ``obs.export`` serializes it).
"""
from __future__ import annotations

import threading
from typing import Optional

_LOCK = threading.Lock()
_COUNTERS: dict[str, "Counter"] = {}
_HISTOGRAMS: dict[str, "Histogram"] = {}

# histograms keep at most this many observations (drop-oldest reservoir);
# service workloads observe one value per step, so this covers hours of
# traffic before any quantile degrades
HISTOGRAM_CAP = 4096


def qualified(name: str, **labels) -> str:
    """Canonical metric identity: ``name{k=v,...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic process-local counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Histogram:
    """Bounded-reservoir histogram (drop-oldest) with exact quantiles."""

    __slots__ = ("name", "_values", "_count", "_total", "_max")

    def __init__(self, name: str):
        self.name = name
        self._values: list[float] = []
        self._count = 0
        self._total = 0.0
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self._count += 1
            self._total += v
            self._max = max(self._max, v)
            self._values.append(v)
            if len(self._values) > HISTOGRAM_CAP:
                del self._values[0]

    @property
    def count(self) -> int:
        return self._count

    def clear(self) -> None:
        """Forget every observation (count, total, max, reservoir) while
        keeping the instance registered — ``ColoringService.restore`` uses
        this so post-rollback latencies start a fresh distribution."""
        with _LOCK:
            self._values.clear()
            self._count = 0
            self._total = 0.0
            self._max = float("-inf")

    def percentile(self, q: float) -> Optional[float]:
        """Exact q-th percentile (0..100) over the retained reservoir."""
        with _LOCK:
            vals = sorted(self._values)
        if not vals:
            return None
        rank = (len(vals) - 1) * (q / 100.0)
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac

    def summary(self) -> dict:
        with _LOCK:
            n, tot, mx = self._count, self._total, self._max
        return {"count": n,
                "mean": (tot / n) if n else None,
                "max": mx if n else None,
                "p50": self.percentile(50),
                "p99": self.percentile(99)}

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self._count})"


def counter(name: str, **labels) -> Counter:
    """The counter registered under ``qualified(name, **labels)``
    (created on first use)."""
    key = qualified(name, **labels)
    with _LOCK:
        c = _COUNTERS.get(key)
        if c is None:
            c = _COUNTERS[key] = Counter(key)
    return c


def histogram(name: str, **labels) -> Histogram:
    key = qualified(name, **labels)
    with _LOCK:
        h = _HISTOGRAMS.get(key)
        if h is None:
            h = _HISTOGRAMS[key] = Histogram(key)
    return h


def counter_value(name: str, **labels) -> int:
    """Current value of a counter, 0 if it was never incremented (reading
    must not create registry entries)."""
    c = _COUNTERS.get(qualified(name, **labels))
    return c.value if c is not None else 0


def counters_matching(prefix: str) -> dict[str, int]:
    """``{qualified_name: value}`` for every counter whose name starts with
    ``prefix`` (label-blind: matches the part before any ``{``)."""
    with _LOCK:
        items = list(_COUNTERS.items())
    return {k: c.value for k, c in items
            if k.split("{", 1)[0].startswith(prefix)}


def total_matching(prefix: str) -> int:
    """Sum of every counter under ``prefix`` — e.g.
    ``total_matching("kernels.fallback")`` is the process-wide kernel
    fallback count regardless of which kernel tripped it."""
    return sum(counters_matching(prefix).values())


def snapshot() -> dict:
    """Point-in-time view of every metric: ``{"counters": {name: int},
    "histograms": {name: summary_dict}}``."""
    with _LOCK:
        counters_ = {k: c.value for k, c in _COUNTERS.items()}
        hists = list(_HISTOGRAMS.items())
    return {"counters": counters_,
            "histograms": {k: h.summary() for k, h in hists}}


def remove(name: str, **labels) -> None:
    """Drop one metric identity (counter and/or histogram) from the
    registry.  ``ColoringService.remove_graph`` uses this so a tenant
    re-added under the same name starts with fresh latency percentiles
    instead of inheriting the departed tenant's (DESIGN.md §13); absent
    identities are a no-op."""
    key = qualified(name, **labels)
    with _LOCK:
        _COUNTERS.pop(key, None)
        _HISTOGRAMS.pop(key, None)


def reset() -> None:
    """Drop every metric (tests; a long-lived process never needs this)."""
    with _LOCK:
        _COUNTERS.clear()
        _HISTOGRAMS.clear()
