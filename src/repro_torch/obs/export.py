"""Trace/metrics export: JSON-lines dumps + NVTX range annotations.

``write_jsonl`` serializes ``RunTrace`` artifacts one-per-line so trajectory
dumps concatenate and stream (CI uploads ``TRACE_<section>.jsonl`` from
bench-smoke next to the ``BENCH_*.json`` rows; both come from the same
events).  ``annotate`` is the device-profile hook: a named
``torch.cuda.nvtx.range`` scope, so when someone captures a CUDA profile
the prepare / solve phases carry the same names the ``RunTrace`` phases do
— and a no-op context manager when no CUDA device is in use, because
observability must never be the thing that crashes.
"""
from __future__ import annotations

import contextlib
import json
from typing import Iterable, Union

import torch

from repro_torch.obs.trace import RunTrace
from repro_torch.obs import metrics as _metrics


def annotate(name: str):
    """Named NVTX range scope (no-op when CUDA has not been initialized —
    a CPU-only run must not touch the CUDA runtime just to name a phase)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


def trace_to_dict(t: Union[RunTrace, dict]) -> dict:
    return t.asdict() if isinstance(t, RunTrace) else dict(t)


def write_jsonl(traces: Iterable[Union[RunTrace, dict]], path: str) -> int:
    """Write traces as JSON lines; returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for t in traces:
            json.dump(trace_to_dict(t), f, default=str)
            f.write("\n")
            n += 1
    return n


def read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def metrics_snapshot() -> dict:
    """The process-local metrics registry, JSON-ready (re-exported so sinks
    import one module)."""
    return _metrics.snapshot()
