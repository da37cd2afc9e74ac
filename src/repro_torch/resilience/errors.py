"""Typed failure vocabulary of the resilience layer (DESIGN.md §14).

Every failure the serving stack can *recover from* is a subclass of
``ResilienceError``: budget exhaustion (``CapRetryExhausted``,
``OvfGrowthExhausted``) triggers the degradation ladder, verification
failures (``ImproperColoring``) and injected faults (``InjectedFault``)
trigger a transactional rollback, and repeated rollbacks land a tenant in
quarantine (``QuarantinedError`` on subsequent submits).  Anything NOT in
this hierarchy is an ordinary bug — the service still rolls the tenant back
bit-exactly, but nothing attempts to degrade around it.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class of every recoverable serving-stack failure."""


class CapRetryExhausted(ResilienceError):
    """``_run_with_retry`` hit its ``max_cap_retries`` budget (or a forced
    ``cap.exhaust`` fault) with the color cap still overflowing."""

    def __init__(self, engine: str = "", C: int = 0, retries: int = 0,
                 budget=None, forced: bool = False):
        self.engine, self.C, self.retries = engine, int(C), int(retries)
        self.budget, self.forced = budget, bool(forced)
        why = "forced by fault injection" if forced else \
            f"budget max_cap_retries={budget} exhausted"
        super().__init__(
            f"color-cap retry exhausted ({why}) in engine "
            f"{engine or 'unknown'!r} at C={C} after {retries} retries")


class OvfGrowthExhausted(ResilienceError):
    """``delta.apply_updates`` hit its ``max_ovf_growth`` budget (or a
    forced ``ovf.exhaust`` fault) with an insert wave still spilling."""

    def __init__(self, grows: int = 0, budget=None, cap: int = 0,
                 forced: bool = False):
        self.grows, self.budget = int(grows), budget
        self.cap, self.forced = int(cap), bool(forced)
        why = "forced by fault injection" if forced else \
            f"budget max_ovf_growth={budget} exhausted"
        super().__init__(
            f"overflow-buffer growth exhausted ({why}) after {grows} "
            f"doublings (cap {cap})")


class ImproperColoring(ResilienceError):
    """Post-step verification found a conflicting edge — the step's output
    is discarded and the tenant rolled back to its pre-step state."""

    def __init__(self, name: str = "", version: int = 0):
        self.name, self.version = name, int(version)
        super().__init__(
            f"step output for {name!r} (version {version}) is not a proper "
            f"coloring; rolled back")


class QuarantinedError(ResilienceError):
    """The tenant is frozen after repeated step failures; ``heal(name)``
    re-admits it."""

    def __init__(self, name: str, reason: str = "", since_version: int = 0):
        self.name, self.reason = name, reason
        self.since_version = int(since_version)
        super().__init__(
            f"graph {name!r} is quarantined (reason={reason!r}, since "
            f"version {since_version}); heal({name!r}) to re-admit")


class HealFailed(ResilienceError):
    """``heal`` could not produce an oracle-verified proper state; the
    tenant stays quarantined."""

    def __init__(self, name: str, detail: str = ""):
        self.name = name
        super().__init__(f"heal({name!r}) failed: {detail}")


class InjectedFault(ResilienceError):
    """Raised by an armed ``resilience.faults`` site (never with faults
    off)."""

    def __init__(self, site: str, meta: dict | None = None):
        self.site = site
        self.meta = dict(meta or {})
        extra = f" {self.meta}" if self.meta else ""
        super().__init__(f"injected fault at {site!r}{extra}")
