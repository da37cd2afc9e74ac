"""Long-lived coloring service over many mutating graphs (DESIGN.md §7.3,
§13; the port of the reference's ``dynamic/service.py``).

``ColoringService`` is the dynamic-graph analogue of ``serving/serve_loop``'s
engine: it owns device-resident ``DynamicColoringState``s for many named
graphs, accepts edge-update batches through ``submit`` and applies them on
``step`` (one incremental repair per batch, one version bump each), and
serves coloring-derived artifacts — the color classes consumed by vertex
kernels and the dst-bucket edge coloring consumed by the GNN scatter path —
from a version-keyed, byte-budgeted LRU memo that mutation invalidates
automatically.

The submit/step queue is double-buffered: ``step`` swaps each tenant's
pending list for an empty one *before* touching the device, so a submit
racing a step lands cleanly in the next step instead of being silently
dropped mid-drain.  ``step`` itself is megabatched (DESIGN.md §13): tenants
sharing a ``megabatch.slot_key`` are stacked and advanced by ONE device
dispatch per update wave / repair loop instead of one per tenant, with
per-slot escape flags routing the rare overflowing tenant back through the
per-tenant retry path.

Queries between steps are cheap: colors and artifacts always reflect the
last stepped version, never a half-applied batch.

Steps are **transactional** (DESIGN.md §14): state is immutable-by-
convention, so a step builds candidate states off to the side and commits
only after the whole drain (and optional post-step verification) succeeds.
Any error — injected fault, improper output, real bug — rolls the tenant
back bit-exactly to its pre-step state and requeues the drained batches at
the *front* of its queue; ``quarantine_after`` consecutive failures freeze
the tenant (steps no-op with a structured reason, submits raise
``QuarantinedError``) and preserve the unapplied batches in a dead-letter
queue that ``heal(name)`` replays after the cause is gone.  Budget
exhaustion (``max_cap_retries`` / ``max_ovf_growth``) never rolls back — it
degrades through the ``resilience.ladder`` rungs and commits a proper,
attributed result.

Here the tenants' states live on the service's device (``device=None``:
the CUDA device, raising where there is none; ``device="cpu"`` runs the
plain path): a per-tenant step repairs on ``detect_recolor`` (B2) with
``row_ids``, a megabatched step on its slot-stride form.  The end of a
drain waits for the device inside the ``try``, so a failed launch rolls the
step back.  A sharded tenant (``add_graph(..., mesh=...)``) lives on its
mesh's devices, which must be the service's device.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from repro_torch.core import coloring as col
from repro_torch.core import schedule
from repro_torch.dynamic import delta
from repro_torch.dynamic import megabatch
from repro_torch.dynamic.incremental import (  # noqa: F401
    DynamicColoringState, _check_edges, _resolve_device, recolor_incremental)
from repro_torch.dynamic.sharded import ShardedColoringState
from repro_torch.graphs.csr import CSRGraph, FILL, to_edge_list
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import faults, ladder
from repro_torch.resilience.errors import (CapRetryExhausted, HealFailed,
                                           ImproperColoring, InjectedFault,
                                           OvfGrowthExhausted,
                                           QuarantinedError)
from repro_torch.resilience.quarantine import (DeadLetter, DeadLetterQueue,
                                               QuarantineEntry)


@dataclasses.dataclass
class UpdateBatch:
    inserts: Optional[np.ndarray]
    deletes: Optional[np.ndarray]


def _classify(exc: BaseException) -> str:
    """Structured failure reason for rollback/quarantine records and the
    ``resilience.rollback{reason=..}`` counter label."""
    if isinstance(exc, InjectedFault):
        return "injected"
    if isinstance(exc, CapRetryExhausted):
        return "cap_exhausted"
    if isinstance(exc, OvfGrowthExhausted):
        return "ovf_exhausted"
    if isinstance(exc, ImproperColoring):
        return "improper"
    return "error"


def _corrupt_colors_sharded(st: ShardedColoringState) -> ShardedColoringState:
    """Sharded ``color.corrupt``: same deterministic conflict injection,
    restricted to shard 0 rows with a *local* neighbor so the copied color
    is a guaranteed same-shard conflict regardless of ghost freshness.
    The corrupted colours land in a copy of shard 0's table."""
    ell0 = col._to_numpy(st.ell[0])
    n0 = min(st.blk, st.n)
    local = (ell0 != FILL) & (ell0 < st.n_loc)
    live_rows = np.nonzero(local[:n0].any(axis=1))[0]
    if len(live_rows) == 0:
        return st
    r = faults.rng("color.corrupt")
    k = min(max(1, int(faults.param("color.corrupt", "k", 1))),
            len(live_rows))
    colors = col._to_numpy(st.colors_tab[0])
    t0 = st.colors_tab[0].clone()
    for v in r.choice(live_rows, size=k, replace=False):
        row = ell0[int(v)]
        w = int(row[local[int(v)]][0])
        t0[int(v)] = int(colors[w])
    return dataclasses.replace(st, colors_tab=(t0,) + st.colors_tab[1:])


def _corrupt_colors(st: DynamicColoringState) -> DynamicColoringState:
    """``color.corrupt`` payload: copy a live ELL neighbor's color onto
    ``k`` vertices (guaranteed conflicts), drawn from the site's
    deterministic RNG so replays corrupt identically.  The corrupted
    colours land in a copy: the state given is left as it is."""
    if isinstance(st, ShardedColoringState):
        return _corrupt_colors_sharded(st)
    ell = col._to_numpy(st.ell[:st.n])
    live_rows = np.nonzero((ell != FILL).any(axis=1))[0]
    if len(live_rows) == 0:
        return st
    r = faults.rng("color.corrupt")
    k = min(max(1, int(faults.param("color.corrupt", "k", 1))),
            len(live_rows))
    colors = col._to_numpy(st.colors_dev)
    cd = st.colors_dev.clone()
    for v in r.choice(live_rows, size=k, replace=False):
        row = ell[int(v)]
        w = int(row[row != FILL][0])
        cd[int(v)] = int(colors[w])
    return dataclasses.replace(st, colors_dev=cd)


def _block_until_ready(st) -> None:
    """Wait for the device work behind a state's colours (the reference's
    ``colors_dev.block_until_ready()``; a sharded state's on each of its
    devices): a failed launch surfaces here."""
    tabs = (st.colors_tab if isinstance(st, ShardedColoringState)
            else (st.colors_dev,))
    for dev in {t.device for t in tabs if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _nbytes(obj) -> int:
    """Recursive size estimate for cache admission (host + device arrays
    report ``nbytes``; containers add a small fixed overhead)."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(o) for o in obj) + 64
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)) + 64
    return sys.getsizeof(obj, 64)


class ArtifactCache:
    """Version-keyed LRU artifact memo with a byte budget (DESIGN.md §13).

    Entries are ``(name, kind) -> (version, artifact, nbytes)``.  A hit
    requires the stored version to match the tenant's current state version
    (mutation invalidates implicitly); any hit refreshes recency.  Insertion
    evicts least-recently-used entries until the budget holds — except the
    entry just inserted, so the artifact being handed to the caller is never
    dropped in the same breath even when it alone exceeds the budget.
    Because a stale entry can never be read again (its version can't come
    back — ``restore`` re-versions above the current version precisely to
    keep this true), stale entries age out of the LRU order first.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._d: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._d)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key: tuple, version: int):
        """The cached artifact for ``key`` at ``version``, else None."""
        hit = self._d.get(key)
        if hit is None or hit[0] != version:
            return None
        self._d.move_to_end(key)
        return hit[1]

    def put(self, key: tuple, version: int, obj) -> list:
        """Admit ``obj``; returns the list of evicted keys."""
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= old[2]
        nb = _nbytes(obj)
        self._d[key] = (version, obj, nb)
        self._bytes += nb
        evicted = []
        while self._bytes > self.budget_bytes and len(self._d) > 1:
            k, (_, _, b) = self._d.popitem(last=False)
            self._bytes -= b
            evicted.append(k)
        return evicted

    def drop_name(self, name: str) -> None:
        for k in [k for k in self._d if k[0] == name]:
            self._bytes -= self._d.pop(k)[2]


class StepStats(Mapping):
    """Lazy per-graph repair stats returned by ``ColoringService.step``.

    Building a stats dict hosts the colors (a blocking device→host copy +
    color count), which used to sit inside the step's timed region and
    pollute ``service.step_ms``.  Values are computed on first access and
    cached; iteration and ``len`` stay free.

    ``notes`` carries per-tenant resilience outcomes merged into the stats
    dict: ``{"rolled_back": reason}`` for a tenant whose drain failed and
    was requeued, ``{"quarantined": reason}`` for a frozen tenant whose
    step was a no-op.
    """

    def __init__(self, states: dict, notes: Optional[dict] = None):
        self._states = dict(states)
        self._notes = dict(notes or {})
        self._cache: dict = {}

    def __getitem__(self, name: str) -> dict:
        if name not in self._cache:
            d = self._states[name].summary()
            d.update(self._notes.get(name, {}))
            self._cache[name] = d
        return self._cache[name]

    def __iter__(self):
        return iter(self._states)

    def __len__(self) -> int:
        return len(self._states)

    def __repr__(self) -> str:
        return f"StepStats({sorted(self._states)})"


class ColoringService:
    def __init__(self, *, memo_budget_mb: float = 256.0,
                 megabatch: bool = True, megabatch_min: int = 2,
                 quarantine_after: int = 2,
                 verify_steps: Optional[bool] = None,
                 dead_letter_cap: int = 64, device=None,
                 **default_opts):
        # every tenant's state lives here (None: the CUDA device)
        self.device = _resolve_device(device)
        self._states: dict[str, DynamicColoringState] = {}
        self._pending: dict[str, list[UpdateBatch]] = {}
        self._memo = ArtifactCache(int(memo_budget_mb * (1 << 20)))
        self._megabatch = bool(megabatch)
        self._megabatch_min = max(2, int(megabatch_min))
        # resilience knobs: consecutive step failures before a tenant is
        # frozen; post-step properness verification (None: auto — on iff
        # fault injection is armed, so production steps pay nothing)
        self._quarantine_after = max(1, int(quarantine_after))
        self._verify_steps = verify_steps
        self._quarantine: dict[str, QuarantineEntry] = {}
        self._failures: dict[str, int] = {}
        self._dlq = DeadLetterQueue(cap=dead_letter_cap)
        self._dl_seq = 0
        self._opts = dict(default_opts)

    # -- graph lifecycle ----------------------------------------------------

    def add_graph(self, name: str, g: CSRGraph, spec=None, *,
                  mesh=None, axis: Optional[str] = None, **opts) -> int:
        """Encode + color ``g`` from scratch; returns the initial version.

        Routes through the ``repro_torch.api.color`` front door with
        ``mode='incremental'`` and keeps the resulting
        ``DynamicColoringState``.  Precedence, most specific wins: per-call
        ``opts`` > explicit ``spec`` > service construction defaults (the
        defaults never override a spec the caller passed explicitly).  The
        state is made on the service's device.

        Passing ``mesh=`` shards the tenant over that device mesh (a
        ``ShardedColoringState``, DESIGN.md §15): with no explicit spec the
        backend defaults to ``'distributed'``, and subsequent steps route
        the tenant's batches through ``recolor_sharded``.  The mesh's
        devices must be the service's device (``api.color``'s rule).
        """
        if name in self._states:
            raise ValueError(f"graph {name!r} already registered")
        from repro_torch import api
        overrides = dict(opts) if spec is not None else {**self._opts,
                                                         **opts}
        mode = overrides.pop("mode", "incremental")
        if mode != "incremental":
            raise ValueError(
                f"ColoringService graphs are incremental by construction "
                f"(got mode={mode!r})")
        if mesh is not None and spec is None:
            overrides.setdefault("backend", "distributed")
        res = api.color(g, spec, mode=mode, mesh=mesh, axis=axis,
                        device=self.device, **overrides)
        self._states[name] = res.state
        self._pending[name] = []
        return self._states[name].version

    def remove_graph(self, name: str) -> None:
        self._state(name)
        del self._states[name]
        del self._pending[name]
        self._memo.drop_name(name)
        self._quarantine.pop(name, None)
        self._failures.pop(name, None)
        self._dlq.drain(name)
        # drop per-tenant observability too: a tenant re-added under this
        # name must not inherit the departed tenant's latency percentiles
        obs_metrics.remove("service.step_ms", graph=name)

    def graphs(self) -> list[str]:
        return sorted(self._states)

    def _state(self, name: str) -> DynamicColoringState:
        if name not in self._states:
            raise KeyError(f"unknown graph {name!r}; have {self.graphs()}")
        return self._states[name]

    # -- snapshot / rollback ------------------------------------------------

    def snapshot(self, name: str) -> DynamicColoringState:
        """The tenant's current immutable state; hold it, keep stepping,
        and ``restore`` later to roll back."""
        return self._state(name)

    def restore(self, name: str, state: DynamicColoringState) -> int:
        """Roll ``name`` back to a snapshot; returns the new version.

        The restored state is re-versioned *above* the tenant's current
        version: version numbers must never repeat with different contents,
        or the artifact memo would serve stale entries as fresh.

        Restoring **flushes the tenant's pending queue**: queued batches
        were submitted against the state line being abandoned, and applying
        them to the snapshot would silently fork history.  Resubmit what
        still applies.  The tenant's ``step_ms`` latency history is also
        cleared — post-restore timings describe a different state and must
        not be averaged into the old tail.  Quarantine is *not* lifted
        (``heal`` is the re-admission path), but the consecutive-failure
        count resets.
        """
        cur = self._state(name)
        if not isinstance(state, (DynamicColoringState,
                                  ShardedColoringState)):
            raise TypeError("restore expects a DynamicColoringState or "
                            "ShardedColoringState")
        if state.n != cur.n:
            raise ValueError(
                f"snapshot is for a {state.n}-vertex graph; "
                f"{name!r} has {cur.n} vertices")
        st = dataclasses.replace(
            state, version=max(cur.version, state.version) + 1)
        self._states[name] = st
        self._pending[name] = []
        self._failures[name] = 0
        obs_metrics.histogram("service.step_ms", graph=name).clear()
        return st.version

    # -- submit/step --------------------------------------------------------

    def submit(self, name: str, inserts=None, deletes=None) -> int:
        """Queue an update batch; returns the queue depth for ``name``.

        Validation happens *here*, not in step(): a malformed batch must
        bounce back to its submitter, never sit poisoning the queue.
        Strict host-side checks name the tenant in every error: integer
        dtype, (k, 2) shape, ids in range, and no self-loops in inserts
        (deletes of a nonexistent edge are a harmless no-op, so they stay
        lenient beyond shape/range).  Submitting to a quarantined tenant
        raises ``QuarantinedError`` immediately — its queue is frozen."""
        st = self._state(name)
        q = self._quarantine.get(name)
        if q is not None:
            raise QuarantinedError(name, q.reason, q.since_version)
        ins = _check_edges(inserts if inserts is not None else [], st.n,
                           "inserts", tenant=name, strict=True)
        dels = _check_edges(deletes if deletes is not None else [], st.n,
                            "deletes", tenant=name, strict=True)
        faults.check("service.submit", tenant=name)
        self._pending[name].append(UpdateBatch(ins, dels))
        return len(self._pending[name])

    def pending(self, name: str) -> int:
        self._state(name)
        return len(self._pending[name])

    def step(self, name: Optional[str] = None) -> StepStats:
        """Drain pending batches (one graph, or all); returns lazy
        per-graph repair stats of the last applied batch.

        Tenants sharing a slot class (same shapes/statics, see
        ``megabatch.slot_key``) are advanced together: one device dispatch
        per update wave and one per repair loop for the whole group.
        ``service.step_ms{graph=..}`` times repair dispatch + device sync
        only — stats decoding happens lazily on access.
        """
        names = [name] if name is not None else self.graphs()
        for nm in names:
            self._state(nm)
        notes: dict[str, dict] = {}
        # quarantined tenants are frozen: their queue stays untouched and
        # the stats row carries the structured reason instead of progress
        live = []
        for nm in names:
            q = self._quarantine.get(nm)
            if q is not None:
                notes[nm] = {"quarantined": q.reason}
            else:
                live.append(nm)
        # double-buffer swap BEFORE device work: a submit racing this step
        # lands in the fresh list and is applied by the next step
        drained = {nm: self._pending[nm] for nm in live}
        for nm in live:
            self._pending[nm] = []

        busy = [nm for nm in live if drained[nm]]
        groups: dict[tuple, list[str]] = {}
        for nm in busy:
            st = self._states[nm]
            # sharded tenants never megabatch (their dispatch is already
            # mesh-wide); a singleton key routes them to the per-tenant path
            key = (("sharded", nm) if isinstance(st, ShardedColoringState)
                   else megabatch.slot_key(st))
            groups.setdefault(key, []).append(nm)

        for key, members in groups.items():
            if self._megabatch and len(members) >= self._megabatch_min:
                self._step_mega(members, drained, notes)
            else:
                for nm in members:
                    self._step_tx(nm, drained[nm], notes)
        return StepStats({nm: self._states[nm] for nm in names}, notes)

    # -- transactional step machinery (DESIGN.md §14) -----------------------

    def _verify(self) -> bool:
        """Post-step properness verification: explicit knob wins; the
        ``None`` default resolves to "on iff fault injection is armed", so
        production steps never pay the decode+check."""
        if self._verify_steps is not None:
            return self._verify_steps
        return faults.active()

    def _apply_one(self, st: DynamicColoringState, batch: UpdateBatch):
        """One batch through the degradation ladder; returns (state, rung).
        With budgets unset and faults off this is exactly
        ``recolor_incremental`` (rung 0) — bit-identical to the pre-§14
        step path."""
        return ladder.apply_with_ladder(st, batch.inserts, batch.deletes)

    def _post_step(self, nm: str,
                   st: DynamicColoringState) -> DynamicColoringState:
        """Pre-commit hook: the ``color.corrupt`` fault perturbs the
        candidate here (never the committed state), and verification
        rejects any improper candidate before it can be served."""
        if faults.fires("color.corrupt", tenant=nm):
            st = _corrupt_colors(st)
        if self._verify():
            if not col.is_proper(delta.state_to_csr(st), st.colors):
                raise ImproperColoring(nm, st.version)
        return st

    def _commit(self, nm: str, st: DynamicColoringState) -> None:
        self._states[nm] = st
        self._failures[nm] = 0

    def _rollback(self, nm: str, batches: list, exc: BaseException,
                  notes: dict) -> None:
        """Discard the failed drain's candidates (the committed state was
        never touched — immutability IS the rollback), requeue the batches
        at the front, and freeze the tenant after repeated failures."""
        reason = _classify(exc)
        obs_metrics.counter("resilience.rollback", reason=reason).inc()
        n = self._failures.get(nm, 0) + 1
        self._failures[nm] = n
        if n >= self._quarantine_after:
            # freeze: every unapplied batch — this drain plus anything
            # submitted since the swap — goes to the dead-letter queue
            # verbatim, as the forensic record and heal's replay source
            letter = tuple((b.inserts, b.deletes)
                           for b in list(batches) + self._pending[nm])
            self._dl_seq += 1
            self._dlq.push(DeadLetter(
                tenant=nm, batches=letter, reason=reason, error=repr(exc),
                version=self._states[nm].version, seq=self._dl_seq))
            self._quarantine[nm] = QuarantineEntry(
                reason=reason, error=repr(exc),
                since_version=self._states[nm].version, failures=n)
            self._pending[nm] = []
            obs_metrics.counter("resilience.quarantine", reason=reason).inc()
            notes[nm] = {"rolled_back": reason, "quarantined": reason}
        else:
            self._pending[nm] = list(batches) + self._pending[nm]
            notes[nm] = {"rolled_back": reason}

    def _step_tx(self, nm: str, batches: list, notes: dict) -> None:
        """Per-tenant transactional drain: one dispatch per batch (repair
        bound comes from the state's persisted ``max_rounds``); commit only
        after every batch applied and the candidate verified."""
        before = self._states[nm]
        t0 = time.perf_counter()
        try:
            faults.check("service.step", tenant=nm)
            st = before
            for batch in batches:
                st, _ = self._apply_one(st, batch)
            st = self._post_step(nm, st)
            _block_until_ready(st)
        except Exception as exc:
            self._rollback(nm, batches, exc, notes)
            return
        self._commit(nm, st)
        # sharded tenants: collective payload bytes of this drain (the
        # halo-exchange cost the O(boundary) claim is about)
        hb = (getattr(st, "total_halo_bytes", 0)
              - getattr(before, "total_halo_bytes", 0))
        if hb > 0:
            obs_metrics.counter("service.halo_bytes", tenant=nm).inc(hb)
        obs_metrics.histogram("service.step_ms", graph=nm).observe(
            (time.perf_counter() - t0) * 1e3)
        obs_metrics.counter("service.mega", outcome="loop").inc(len(batches))

    def _step_mega(self, members: list, drained: dict, notes: dict) -> None:
        """Megabatched path: every member advances in one stacked dispatch
        per wave/repair round.  Each member observes the group wall time —
        that IS the latency a tenant experiences for a batched step.

        ``step_group`` is functional (nothing commits until it returns), so
        a mid-group error leaves every member's state untouched; the group
        then falls back to per-tenant transactional drains, which isolate
        the failing tenant instead of wedging its whole slot class."""
        t0 = time.perf_counter()
        try:
            faults.check("service.step", group=",".join(members))
            states = [self._states[nm] for nm in members]
            queues = [[(b.inserts, b.deletes) for b in drained[nm]]
                      for nm in members]
            new_states, outcomes = megabatch.step_group(states, queues)
            for st in new_states:
                _block_until_ready(st)
        except Exception:
            obs_metrics.counter("service.mega", outcome="group_fail").inc()
            for nm in members:
                self._step_tx(nm, drained[nm], notes)
            return
        dt = (time.perf_counter() - t0) * 1e3
        for nm, st, oc in zip(members, new_states, outcomes):
            try:
                st = self._post_step(nm, st)
            except Exception as exc:
                self._rollback(nm, drained[nm], exc, notes)
                continue
            self._commit(nm, st)
            obs_metrics.histogram("service.step_ms", graph=nm).observe(dt)
            for outcome, cnt in oc.items():
                if cnt:
                    obs_metrics.counter("service.mega",
                                        outcome=outcome).inc(cnt)

    def step_latency(self, name: str) -> dict:
        """Latency summary of this tenant's non-empty ``step`` calls:
        {count, mean, max, p50, p99} in milliseconds (process-local)."""
        self._state(name)
        return obs_metrics.histogram("service.step_ms", graph=name).summary()

    # -- quarantine / heal --------------------------------------------------

    def quarantined(self, name: Optional[str] = None):
        """The tenant's ``QuarantineEntry`` (None if healthy), or the full
        {name: entry} map when called without a name."""
        if name is None:
            return dict(self._quarantine)
        self._state(name)
        return self._quarantine.get(name)

    def dead_letters(self, name: Optional[str] = None) -> list:
        """Preserved unapplied drains (``DeadLetter`` records), oldest
        first; optionally filtered to one tenant."""
        return self._dlq.letters(name)

    def export_dead_letters(self, path) -> int:
        """Write the dead-letter queue as JSONL (CI chaos artifacts);
        returns the number of letters written."""
        return self._dlq.export_jsonl(path)

    def heal(self, name: str, mode: str = "replay") -> int:
        """Re-admit a quarantined tenant; returns the healed version.

        ``mode='replay'`` (default) re-applies the tenant's dead-lettered
        batches from its last-good state through the degradation ladder.
        Because states are deterministic functions of (state, batch), a
        replay whose cause is gone (fault disarmed, budget raised via
        snapshot surgery) commits **bit-identical** colors and versions to
        the run that never failed; success drains the tenant's dead
        letters.  If replay fails or verifies improper, it falls back to
        ``mode='scratch'``: a from-scratch recolor of the *current* graph —
        the dead-lettered updates stay unapplied and their letters are kept
        for inspection.  Either path commits only an oracle-verified proper
        coloring; otherwise ``HealFailed`` and the tenant stays frozen.
        """
        cur = self._state(name)
        if name not in self._quarantine:
            raise ValueError(f"graph {name!r} is not quarantined")
        if mode not in ("replay", "scratch"):
            raise ValueError(f"unknown heal mode {mode!r}; "
                             f"known: replay, scratch")
        if mode == "replay":
            st = cur
            try:
                for letter in self._dlq.letters(name):
                    for ins, dels in letter.batches:
                        st, _ = ladder.apply_with_ladder(st, ins, dels)
                _block_until_ready(st)
                if not col.is_proper(delta.state_to_csr(st), st.colors):
                    raise ImproperColoring(name, st.version)
            except Exception:
                mode = "scratch"    # the cause is still live; fall through
            else:
                self._dlq.drain(name)
                return self._readmit(name, st, "replay")
        try:
            st = ladder.scratch_state(cur)
            _block_until_ready(st)
            if not col.is_proper(delta.state_to_csr(st), st.colors):
                raise ImproperColoring(name, st.version)
        except Exception as exc:
            raise HealFailed(name, repr(exc)) from exc
        return self._readmit(name, st, "scratch")

    def _readmit(self, name: str, st: DynamicColoringState,
                 mode: str) -> int:
        del self._quarantine[name]
        self._failures[name] = 0
        self._states[name] = st
        obs_metrics.counter("resilience.heal", mode=mode).inc()
        return st.version

    # -- queries (always reflect the last stepped version) ------------------

    def version(self, name: str) -> int:
        return self._state(name).version

    def colors(self, name: str) -> np.ndarray:
        return self._state(name).colors

    def stats(self, name: str) -> dict:
        return self._state(name).summary()

    def graph(self, name: str) -> CSRGraph:
        """Decode the current device-resident graph (original ids)."""
        return self._memoized(name, "csr",
                              lambda st: delta.state_to_csr(st))

    def vertex_schedule(self, name: str) -> list[np.ndarray]:
        """Color classes (independent sets) of the current coloring — the
        paper's vertex-kernel execution schedule, without recoloring."""
        def build(st: DynamicColoringState):
            colors = st.colors
            return [np.nonzero(colors == c)[0]
                    for c in range(col.n_colors_used(colors))]
        return self._memoized(name, "vertex_schedule", build)

    def edge_colors(self, name: str):
        """Dst-bucket edge coloring of the current graph for conflict-free
        scatter (models.gnn.colored_segment_sum).  (edge_list, colors, k)."""
        def build(st: DynamicColoringState):
            e = to_edge_list(self.graph(name))   # shares the memoized decode
            ec, k = schedule.edge_color_by_dst(e[:, 0], e[:, 1], st.n)
            return e, ec, k
        return self._memoized(name, "edge_colors", build)

    def _memoized(self, name: str, kind: str, build):
        st = self._state(name)
        key = (name, kind)
        hit = self._memo.get(key, st.version)
        if hit is not None:
            obs_metrics.counter("service.memo", kind=kind,
                                outcome="hit").inc()
            return hit
        obs_metrics.counter("service.memo", kind=kind, outcome="miss").inc()
        art = build(st)
        for _, ekind in self._memo.put(key, st.version, art):
            obs_metrics.counter("service.memo", kind=ekind,
                                outcome="evict").inc()
        return art
