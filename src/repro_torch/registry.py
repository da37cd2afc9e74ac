"""Engine registry behind ``repro_torch.api.color`` (DESIGN.md §11).

This is a deliberately leaf module: it imports no engine code, so the engine
modules (``core/coloring.py``, ``core/frontier.py``, ``core/distance2.py``,
``core/distributed.py``, ``dynamic/incremental.py``) can decorate their
adapters with ``@register_engine(...)`` without creating an import cycle with
``repro_torch.api`` (which imports all of them to populate the registry).

An engine is keyed by the four spec axes that select an implementation:

    (algorithm, distance, mode, backend)

and is a callable ``engine(g, spec, **engine_kwargs) -> ColoringResult``
where ``spec`` is a ``repro_torch.api.ColoringSpec`` (duck-typed here — attribute
access only, so this module never needs the class).  New engines (distance-d,
star/acyclic, new backends) are new registry entries, not new public
functions.

The deprecation machinery for the legacy ``color_*`` shims also lives here
(shared by every engine module): each shim warns exactly once per process
and then routes through ``repro_torch.api.color`` so its output is bit-identical
to the spec path by construction.
"""
from __future__ import annotations

from typing import Callable, Iterable
import warnings

EngineKey = tuple[str, int, str, str]   # (algorithm, distance, mode, backend)

_ENGINES: dict[EngineKey, Callable] = {}


def register_engine(algorithm: str, *, distance: int = 1,
                    mode: str = "static", backend: str = "local",
                    replaces: str | None = None):
    """Class a callable ``fn(g, spec, **kw) -> ColoringResult`` under a spec
    combo.  ``replaces`` names the pre-registry public entry point the engine
    subsumes (documentation + the migration table in DESIGN.md §11)."""
    key: EngineKey = (algorithm, int(distance), mode, backend)

    def deco(fn: Callable) -> Callable:
        if key in _ENGINES:
            raise ValueError(f"duplicate engine registration for {key}")
        _ENGINES[key] = fn
        fn.engine_key = key
        fn.replaces = replaces
        return fn

    return deco


def has_engine(algorithm: str, distance: int, mode: str, backend: str) -> bool:
    return (algorithm, int(distance), mode, backend) in _ENGINES


def get_engine(algorithm: str, distance: int, mode: str,
               backend: str) -> Callable:
    key: EngineKey = (algorithm, int(distance), mode, backend)
    try:
        return _ENGINES[key]
    except KeyError:
        near = nearest_key(key)
        raise ValueError(
            f"no engine registered for algorithm={algorithm!r}, "
            f"distance={distance}, mode={mode!r}, backend={backend!r}; "
            f"nearest supported spec: {format_key(near)} "
            f"(full matrix: repro_torch.api.supported_specs())") from None


def engine_keys() -> list[EngineKey]:
    """All registered combos, sorted (the support matrix)."""
    return sorted(_ENGINES)


def engine_items() -> list[tuple[EngineKey, Callable]]:
    return [(k, _ENGINES[k]) for k in engine_keys()]


def nearest_key(key: EngineKey) -> EngineKey:
    """The registered combo closest to ``key`` — used by
    ``ColoringSpec.validate`` to make rejections actionable.

    Axes are weighted mode > distance > backend > algorithm: the mode is the
    *task* (a user asking for incremental coloring under the wrong algorithm
    wants the algorithm that supports it, not a different task), while the
    algorithm is the most fungible choice.  Deterministic: ties break toward
    the lexicographically first key.
    """
    if not _ENGINES:
        raise RuntimeError("engine registry is empty (import repro_torch.api)")
    algorithm, distance, mode, backend = key

    def score(k: EngineKey) -> int:
        return ((k[2] == mode) * 8 + (k[1] == distance) * 4
                + (k[3] == backend) * 2 + (k[0] == algorithm) * 1)

    return max(engine_keys(), key=score)


def format_key(key: EngineKey) -> str:
    a, d, m, b = key
    return (f"algorithm={a!r}, distance={d}, mode={m!r}, backend={b!r}")


# --------------------------------------------------------------------------
# legacy-shim support: warn once per entry point, then use the front door
# --------------------------------------------------------------------------

_DEPRECATION_SEEN: set[str] = set()


def warn_legacy(name: str, hint: str, stacklevel: int = 2) -> None:
    """DeprecationWarning for legacy entry point ``name``, exactly once per
    process (tests reset with ``reset_legacy_warnings``)."""
    if name in _DEPRECATION_SEEN:
        return
    _DEPRECATION_SEEN.add(name)
    warnings.warn(
        f"{name}() is deprecated; call repro_torch.api.color(g, {hint}) instead "
        f"(see DESIGN.md §11 for the migration table)",
        DeprecationWarning, stacklevel=stacklevel + 1)


def reset_legacy_warnings() -> None:
    _DEPRECATION_SEEN.clear()


def legacy_entry(name: str, hint: str, g, **kwargs):
    """Body of every ``color_*`` deprecation shim: warn once, then route
    through ``repro_torch.api.color`` so legacy calls stay bit-identical to the
    spec path by construction."""
    # stacklevel 3: warnings.warn <- warn_legacy <- legacy_entry <- shim,
    # attributing the warning to the SHIM'S CALLER so the default
    # `default::DeprecationWarning:__main__` filter surfaces it in scripts
    warn_legacy(name, hint, stacklevel=3)
    from repro_torch import api   # call-time import: api imports the engine modules
    return api.color(g, **kwargs)
