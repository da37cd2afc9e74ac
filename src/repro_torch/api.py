"""One front door for every coloring engine: ``repro_torch.api.color``
(DESIGN.md §11; the PyTorch/CUDA port of ``repro_torch.api``).

Rokos et al.'s contribution is one speculative detect-and-recolor scheme that
subsumes its predecessors, and the optimistic loop extends unchanged to
distance-2, bipartite partial, incremental and distributed coloring — so the
public API is one entry point parameterized by a **spec**, not one function
per variant:

    from repro_torch import api

    res = api.color(g)                                       # RSOC, on the GPU
    res = api.color(g, n_chunks=32, seed=1)                  # overrides
    spec = api.ColoringSpec(algorithm="rsoc", seed=1)
    res = api.color(g, spec, device="cpu")                   # explicit device
    res.spec                                                 # resolved echo

**Device rule.**  ``device=None`` means ``torch.device("cuda")`` and raises
when there is no CUDA device: the entry point never carries on on the CPU by
itself.  A caller that wants the CPU (the tests do) says ``device="cpu"``.
``device`` is a runtime argument that selects hardware, not the task, so it
is not a spec field: ``ColoringSpec`` and ``spec_key()`` are identical to the
reference package's.

    res = api.color(g, distance=2)                           # distance-2
    res = api.color(g, distance=2, mode="partial", n_left=m) # Jacobian
                                                             # compression
    res = api.color(g, algorithm="rsoc_compact")             # compacted
    res = api.color(g, algorithm="cat")                      # baselines:
    res = api.color(g, algorithm="gm")                       # CAT, GM, JP
    res = api.color(g, algorithm="jp")
    res = api.color(g, mode="incremental")                   # mutable:
    st = dynamic.recolor_incremental(res.state, ins, dels)   # res.state
    mesh = core.mesh.make_mesh((4,), ("data",))              # 4 shards
    res = api.color(g, backend="distributed", mesh=mesh)     # sharded:
    res = api.color(g, algorithm="cat", backend="distributed", mesh=mesh)
    res = api.color(g, mode="incremental", backend="distributed",
                    mesh=mesh)                               # res.state
    st = dynamic.recolor_sharded(res.state, ins, dels)       # sharded

Engines live in a registry keyed by ``(algorithm, distance, mode, backend)``
(``repro_torch.registry``); each engine module registers its own at import
time.  This module imports the engine modules that are ported —
``core/coloring.py`` with ``(rsoc | cat | gm | jp, 1, static, local)``,
``core/frontier.py`` with ``(rsoc_compact, 1, static, local)``,
``core/distance2.py`` with ``(rsoc, 2, static, local)`` and ``(rsoc, 2,
partial, local)``, ``dynamic/incremental.py`` with ``(rsoc, 1,
incremental, local)``, ``core/distributed.py`` with ``(rsoc | cat, 1,
static, distributed)`` and ``dynamic/sharded.py`` with ``(rsoc, 1,
incremental, distributed)`` — the reference's whole matrix — so
``supported_specs()`` lists exactly what runs, and every other combo is
rejected by ``ColoringSpec.validate`` with the nearest supported spec named.

With ``backend="distributed"`` the mesh (``core.mesh.make_mesh``) names the
devices: ``device`` is then None or the mesh's one device, else
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs, registry
from repro_torch.registry import register_engine  # noqa: F401  (re-export)
from repro_torch.core.context import (DEFAULT_FORBIDDEN_IMPL, PassContext,
                                      resolve_impl)
from repro_torch.core.coloring import ColoringResult
from repro_torch.core.mesh import Mesh

# importing the engine modules populates the registry (each module
# registers its own combos); only ported engine modules are listed
from repro_torch.core import coloring as _coloring        # noqa: F401
from repro_torch.core import distance2 as _distance2      # noqa: F401
from repro_torch.core import distributed as _distributed  # noqa: F401
from repro_torch.core import frontier as _frontier        # noqa: F401
from repro_torch.dynamic import incremental as _incremental  # noqa: F401
from repro_torch.dynamic import sharded as _sharded       # noqa: F401

MODES = ("static", "incremental", "partial")
BACKENDS = ("local", "distributed")


@dataclasses.dataclass(frozen=True)
class ColoringSpec:
    """Complete, hashable description of a coloring task (minus the graph).

    The four axes ``algorithm`` / ``distance`` / ``mode`` / ``backend``
    select the engine from the registry; the remaining fields parameterize
    it.  Fields an engine does not consume are inert (e.g. ``max_rounds``
    for gm, ``n_chunks`` for jp) — the support matrix in DESIGN.md §11
    records which fields bite where.
    """

    algorithm: str = "rsoc"        # rsoc | cat | gm | jp | rsoc_compact
    distance: int = 1              # 1 | 2 (native two-hop; d>2 on ROADMAP)
    mode: str = "static"           # static | incremental | partial
    backend: str = "local"         # local | distributed (needs mesh=)
    seed: int = 0                  # relabel + priority RNG seed
    C: Optional[int] = None        # color cap (None: engine picks, then
                                   # doubles on overflow; result.final_C)
    n_chunks: int = 16             # sequential chunks/pass (1/threads)
    max_rounds: int = 1000         # repair-round bound
    forbidden_impl: Optional[str] = None   # bitset | dense (None: default)
    ell_cap: int = 512             # ELL width cap; hubs spill to COO
    relabel: bool = True           # host-side random vertex relabel
    frontier_frac: float = 0.125   # compacted-frontier capacity fraction
    n_left: Optional[int] = None   # mode="partial": bipartite left size
    ell_slack: int = 4             # mode="incremental": free ELL slots/row
    ovf_cap: Optional[int] = None  # mode="incremental": overflow buffer cap
    delta_cap: int = 2048          # mode="incremental": update-slice width
    trace: bool = False            # attach an obs.RunTrace to result.trace
                                   # (zero device overhead when False; also
                                   # forced by obs.trace() / REPRO_TRACE=1)
    max_cap_retries: Optional[int] = None  # color-cap doubling budget per
                                   # solve (None: unbounded, the legacy
                                   # behavior); exhaustion raises
                                   # CapRetryExhausted -> degradation
                                   # ladder in the dynamic stack (§14)
    max_ovf_growth: Optional[int] = None   # mode="incremental": overflow
                                   # buffer growth budget per batch (None:
                                   # unbounded); exhaustion raises
                                   # OvfGrowthExhausted -> ladder (§14)

    # -- resolution / validation -------------------------------------------

    def resolved(self) -> "ColoringSpec":
        """Spec with every defaultable field pinned (what ``color`` echoes
        into ``ColoringResult.spec``): same spec in => same colors out."""
        return dataclasses.replace(
            self, forbidden_impl=resolve_impl(self.forbidden_impl))

    def validate(self) -> "ColoringSpec":
        """Reject malformed fields and unsupported combos with actionable
        errors (the nearest supported spec is named)."""
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; known: {MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; known: {BACKENDS}")
        resolve_impl(self.forbidden_impl)   # raises on unknown impl
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1 (got {self.n_chunks})")
        if self.max_rounds < 1:
            raise ValueError(
                f"max_rounds must be >= 1 (got {self.max_rounds})")
        if self.C is not None and self.C < 1:
            raise ValueError(f"C must be >= 1 or None (got {self.C})")
        if self.ell_cap < 1:
            raise ValueError(f"ell_cap must be >= 1 (got {self.ell_cap})")
        if self.max_cap_retries is not None and self.max_cap_retries < 0:
            raise ValueError(
                f"max_cap_retries must be >= 0 or None "
                f"(got {self.max_cap_retries})")
        if self.max_ovf_growth is not None and self.max_ovf_growth < 0:
            raise ValueError(
                f"max_ovf_growth must be >= 0 or None "
                f"(got {self.max_ovf_growth})")
        if not 0.0 < self.frontier_frac <= 1.0:
            raise ValueError(
                f"frontier_frac must be in (0, 1] (got {self.frontier_frac})")
        if self.mode == "partial":
            if self.n_left is None:
                raise ValueError(
                    "mode='partial' requires n_left (the bipartite "
                    "left-side size to color)")
        elif self.n_left is not None:
            raise ValueError(
                f"n_left is only meaningful with mode='partial' "
                f"(got mode={self.mode!r})")
        key = (self.algorithm, self.distance, self.mode, self.backend)
        if not registry.has_engine(*key):
            near = registry.nearest_key(key)
            raise ValueError(
                f"no engine registered for {registry.format_key(key)}; "
                f"nearest supported spec: {registry.format_key(near)} "
                f"(full matrix: repro_torch.api.supported_specs())")
        return self

    # -- identity ----------------------------------------------------------

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def spec_key(self) -> str:
        """Stable one-line identity of the *resolved* spec, recorded in
        every BENCH_*.json row so perf trajectories key on the exact task."""
        s = self.resolved()
        return ";".join(f"{f.name}={getattr(s, f.name)}"
                        for f in dataclasses.fields(s))


SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ColoringSpec))


def _resolve_device(device) -> torch.device:
    """``None`` -> the CUDA device, or an error where there is none; never
    a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch.api.color runs on a CUDA device by default and "
                "none is available (torch.cuda.is_available() is False); "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is "
            f"available")
    return device


def _check_mesh_device(mesh, axis: str, device) -> None:
    """``device`` given beside a mesh must be the mesh's one device."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.core.mesh.Mesh (make_mesh); got "
            f"{type(mesh).__name__}")
    if device is None:
        return
    want = torch.device(device)
    have = set(mesh.shard_devices(axis))
    if have != {want}:
        raise ValueError(
            f"device={str(want)!r} contradicts the mesh, whose shards are "
            f"on {sorted(str(d) for d in have)}: with "
            f"backend='distributed' the mesh names the devices (pass "
            f"device=None)")


def color(g, spec: Optional[ColoringSpec] = None, *,
          device=None, mesh=None, axis: Optional[str] = None,
          **overrides) -> ColoringResult:
    """Color graph ``g`` per ``spec`` (defaults + ``**overrides``).

    ``overrides`` are ``ColoringSpec`` field replacements applied on top of
    ``spec`` (or on the default spec).  ``device`` (None: the CUDA device,
    raising where there is none) and ``mesh``/``axis`` (for
    ``backend='distributed'``, where the mesh names the devices and
    ``device`` may only repeat its one device) are runtime arguments — they
    select hardware, not the task, so they are not spec fields.

    Returns a ``ColoringResult`` whose ``spec`` field echoes the resolved
    spec (reproducibility: feed it back in to replay the run) and, for
    ``mode='incremental'``, whose ``state`` field carries the
    ``DynamicColoringState`` (``ShardedColoringState`` with a mesh) for
    subsequent ``recolor_incremental`` (``recolor_sharded``) batches.
    """
    if spec is None:
        spec = ColoringSpec()
    elif not isinstance(spec, ColoringSpec):
        raise TypeError(
            f"spec must be a ColoringSpec (got {type(spec).__name__}); "
            f"pass field overrides as keyword arguments")
    if overrides:
        unknown = sorted(set(overrides) - set(SPEC_FIELDS))
        if unknown:
            raise TypeError(
                f"unknown ColoringSpec override(s) {unknown}; "
                f"spec fields: {list(SPEC_FIELDS)}")
        spec = dataclasses.replace(spec, **overrides)
    spec = spec.resolved()
    spec.validate()
    engine = registry.get_engine(spec.algorithm, spec.distance, spec.mode,
                                 spec.backend)
    if spec.backend == "distributed":
        # the mesh names the devices (engine raises if it is None)
        kw = {"mesh": mesh, "axis": axis if axis is not None else "data"}
        _check_mesh_device(mesh, kw["axis"], device)
    elif mesh is not None or axis is not None:
        raise ValueError(
            f"mesh=/axis= are only meaningful with backend='distributed' "
            f"(spec.backend={spec.backend!r})")
    else:
        kw = {"device": _resolve_device(device)}
    if not obs.tracing_enabled(spec.trace):
        # untraced fast path: byte-for-byte the pre-obs call
        return dataclasses.replace(engine(g, spec, **kw), spec=spec)
    with obs.run_tracer() as tracer:
        res = engine(g, spec, **kw)
    engine_key = registry.format_key(
        (spec.algorithm, spec.distance, spec.mode, spec.backend))
    run_trace = tracer.finish(res, spec, engine_key, g.n_vertices)
    obs.collect(run_trace)
    return dataclasses.replace(res, spec=spec, trace=run_trace)


def supported_specs() -> list[dict]:
    """The registry's support matrix: one row per registered engine combo,
    with the legacy entry point it replaces (DESIGN.md §11)."""
    return [{"algorithm": a, "distance": d, "mode": m, "backend": b,
             "replaces": fn.replaces}
            for (a, d, m, b), fn in registry.engine_items()]


def algorithms(distance: int = 1, mode: str = "static",
               backend: str = "local") -> list[str]:
    """Algorithm names registered for a given (distance, mode, backend)."""
    return sorted({a for (a, d, m, b) in registry.engine_keys()
                   if (d, m, b) == (distance, mode, backend)})


__all__ = [
    "BACKENDS",
    "ColoringResult",
    "ColoringSpec",
    "DEFAULT_FORBIDDEN_IMPL",
    "MODES",
    "PassContext",
    "SPEC_FIELDS",
    "algorithms",
    "color",
    "register_engine",
    "supported_specs",
]
