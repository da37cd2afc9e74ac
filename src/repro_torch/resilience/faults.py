"""Deterministic fault injection for the serving stack (DESIGN.md §14.4).

A *fault point* is a named host-side site in the production code path —
``faults.fires("cap.exhaust", ...)`` — that is a single ``is None`` check
when injection is off and a seeded, reproducible coin flip when on.  The
discipline mirrors ``repro_torch.obs``: **off must be free and bit-exact** — no
fault point sits inside a kernel or between a launch and its commit, so
the device work is identical with ``REPRO_FAULTS`` unset, and the only host
cost is the module-level None check.

Sites (each raises or perturbs at a different detection layer):

    ``kernel.fallback``   kernels/ops dispatchers force the plain torch
                          version (bit-identical by the parity contract)
    ``cap.exhaust``       core/coloring._run_with_retry raises
                          CapRetryExhausted (degradation-ladder trigger)
    ``ovf.exhaust``       dynamic/delta.apply_updates raises
                          OvfGrowthExhausted (degradation-ladder trigger)
    ``color.corrupt``     service commit path corrupts a stepped coloring
                          (caught by post-step verification -> rollback)
    ``service.step``      exception at the top of a per-tenant/mega step
                          (transactional rollback + retry/quarantine)
    ``service.submit``    exception in submit before enqueue (caller-visible)

Activation, most specific wins::

    REPRO_FAULTS="cap.exhaust"                        # every call fires
    REPRO_FAULTS="service.step:p=0.5:seed=7;ovf.exhaust:times=1"
    with faults.inject("color.corrupt:times=2:seed=3"):
        ...

Spec grammar: ``;``-separated sites, each ``name[:k=v]*`` with params
``p`` (fire probability, default 1), ``seed`` (per-site RNG seed, default
0), ``after`` (skip the first N eligible calls), ``times`` (fire at most K
times, default unlimited), ``k`` (payload count, e.g. corrupted vertices).
Firing is a pure function of (spec, call order): replaying the same
workload under the same spec fires at the same calls — chaos tests rely on
this to assert bit-identical double runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import zlib
from typing import Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience.errors import InjectedFault

KNOWN_SITES = ("kernel.fallback", "cap.exhaust", "ovf.exhaust",
               "color.corrupt", "service.step", "service.submit")

ENV_VAR = "REPRO_FAULTS"


@dataclasses.dataclass
class FaultPoint:
    """One armed site: firing policy + deterministic per-site RNG state."""

    site: str
    p: float = 1.0
    seed: int = 0
    after: int = 0                 # eligible-call warmup before any fire
    times: Optional[int] = None    # max fires (None = unlimited)
    k: int = 1                     # payload count (site-specific meaning)
    calls: int = 0
    fired: int = 0

    def __post_init__(self):
        # site-salted seed: two sites sharing seed=0 draw distinct streams
        self.rng = np.random.default_rng(
            (int(self.seed) << 32) ^ zlib.crc32(self.site.encode()))

    def draw(self) -> bool:
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        hit = True if self.p >= 1.0 else bool(self.rng.random() < self.p)
        if hit:
            self.fired += 1
        return hit


def parse_spec(spec: str) -> dict[str, FaultPoint]:
    """``"site[:k=v]*[;site...]"`` -> {site: FaultPoint}; raises on unknown
    sites/params so a typo'd REPRO_FAULTS fails loudly, not silently off."""
    plan: dict[str, FaultPoint] = {}
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        fields = part.split(":")
        site = fields[0].strip()
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known: {list(KNOWN_SITES)}")
        kw: dict = {}
        for f in fields[1:]:
            key, _, val = f.partition("=")
            key = key.strip()
            if key == "p":
                kw["p"] = float(val)
            elif key in ("seed", "after", "times", "k"):
                kw[key] = int(val)
            else:
                raise ValueError(
                    f"unknown fault param {key!r} in {part!r}; "
                    f"known: p, seed, after, times, k")
        plan[site] = FaultPoint(site=site, **kw)
    return plan


# None = injection off (the fast path: one module-global None check per
# site visit).  Parsed once at import so a spec'd child process is armed
# before any engine code runs; tests re-arm via install()/inject().
_PLAN: Optional[dict[str, FaultPoint]] = None
_SPEC: Optional[str] = None


def _arm_from_env() -> None:
    global _PLAN, _SPEC
    spec = os.environ.get(ENV_VAR, "").strip()
    if spec:
        _PLAN, _SPEC = parse_spec(spec), spec


_arm_from_env()


def active() -> bool:
    """True iff any fault site is armed."""
    return _PLAN is not None


def spec() -> Optional[str]:
    """The currently-armed spec string (None when off)."""
    return _SPEC


def install(spec_: Optional[str]) -> None:
    """Arm ``spec_`` (replacing any current plan); ``None``/empty disarms."""
    global _PLAN, _SPEC
    if not spec_:
        _PLAN, _SPEC = None, None
    else:
        _PLAN, _SPEC = parse_spec(spec_), spec_


def reset() -> None:
    """Re-arm the current spec with fresh call/fire counters and RNG state —
    the next run sees the exact firing sequence of the first."""
    install(_SPEC)


@contextlib.contextmanager
def inject(spec_: Optional[str]):
    """Arm ``spec_`` for the scope; restores the previous plan on exit."""
    global _PLAN, _SPEC
    prev = (_PLAN, _SPEC)
    install(spec_)
    try:
        yield
    finally:
        _PLAN, _SPEC = prev


@contextlib.contextmanager
def suppress():
    """Disarm every fault for the scope (the chaos tests' fault-free
    reference runs live here); restores the previous plan on exit."""
    with inject(None):
        yield


def fires(site: str, **meta) -> bool:
    """Deterministically decide whether ``site`` fires at this call.

    Off (the production path) this is one None check.  On, the armed
    site's policy draws; a fire bumps ``resilience.fault{site=...}``.
    """
    if _PLAN is None:
        return False
    fp = _PLAN.get(site)
    if fp is None or not fp.draw():
        return False
    obs_metrics.counter("resilience.fault", site=site).inc()
    return True


def check(site: str, **meta) -> None:
    """Raise ``InjectedFault`` iff ``site`` fires (exception-type sites)."""
    if fires(site, **meta):
        raise InjectedFault(site, meta)


def param(site: str, name: str, default):
    """An armed site's payload param (e.g. ``k``); ``default`` when off."""
    if _PLAN is None:
        return default
    fp = _PLAN.get(site)
    return default if fp is None else getattr(fp, name, default)


def rng(site: str) -> np.random.Generator:
    """The armed site's deterministic RNG (payload decisions share the
    firing stream, so replays stay exact).  Only meaningful right after
    ``fires(site)`` returned True."""
    assert _PLAN is not None and site in _PLAN, site
    return _PLAN[site].rng
