"""Self-healing serving layer: transactional steps, bounded retries with a
degradation ladder, quarantine + dead-letter, and deterministic fault
injection (DESIGN.md §14).

Import-light on purpose: ``core/coloring`` and ``dynamic/delta`` pull the
error types and fault registry from here at module scope, so this package
must not import them back.  The heavier submodules (``ladder``,
``quarantine``) are imported explicitly by their consumers
(``dynamic/service``) and lazy-load engine code inside function bodies.
"""
from repro_torch.resilience import faults  # noqa: F401
from repro_torch.resilience.errors import (  # noqa: F401
    CapRetryExhausted, HealFailed, ImproperColoring, InjectedFault,
    OvfGrowthExhausted, QuarantinedError, ResilienceError)

__all__ = [
    "CapRetryExhausted",
    "HealFailed",
    "ImproperColoring",
    "InjectedFault",
    "OvfGrowthExhausted",
    "QuarantinedError",
    "ResilienceError",
    "faults",
]
