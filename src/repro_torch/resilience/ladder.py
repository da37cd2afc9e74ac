"""The degradation ladder (DESIGN.md §14.2; the port of the reference's
``resilience/ladder.py``).

When a tenant's incremental repair exhausts its budgets — ``max_cap_retries``
color-cap doublings or ``max_ovf_growth`` overflow-buffer growths — the
service does not spin and does not drop the batch; it *degrades
deterministically* through three rungs, each strictly more conservative and
strictly harder to exhaust:

    rung 0  incremental repair       (``recolor_incremental``: work ∝ delta)
    rung 1  from-scratch re-encode   (``api.color`` on the updated graph —
                                      fresh caps, fresh overflow sizing)
    rung 2  serial oracle            (host ``greedy_sequential`` + encode:
                                      no device coloring loop at all, so no
                                      budget left to exhaust)

Every rung produces a state that is *consistent* — proper colors over the
fully-applied updated graph, version bumped exactly once per batch — and on
the device of the state it replaces.  The rung taken is recorded on
``DynamicColoringState.last_degrade_rung`` and counted in
``resilience.degrade{rung=..}``.

Heavy imports (api, dynamic, core) are deferred into function bodies:
``core/coloring`` and ``dynamic/delta`` import ``repro_torch.resilience`` at
module scope, so this module must not import them back at its own.  A
``ShardedColoringState`` takes the sharded rungs of ``dynamic/sharded.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience.errors import CapRetryExhausted, OvfGrowthExhausted

RUNG_NAMES = ("incremental", "scratch", "oracle")


def updated_graph(state, inserts, deletes):
    """Host-side edge-set algebra: the tenant's current graph with the
    batch applied (original vertex ids, deletes before inserts, self-loop
    inserts dropped like the device wave planner does)."""
    from repro_torch.dynamic import delta
    from repro_torch.graphs.csr import from_edges, to_edge_list

    g = delta.state_to_csr(state)
    e = to_edge_list(g).astype(np.int64)
    live = {(int(min(u, v)), int(max(u, v))) for u, v in e}
    for u, v in np.asarray(deletes).reshape(-1, 2):
        live.discard((int(min(u, v)), int(max(u, v))))
    for u, v in np.asarray(inserts).reshape(-1, 2):
        if u != v:
            live.add((int(min(u, v)), int(max(u, v))))
    edges = (np.array(sorted(live), np.int64).reshape(-1, 2)
             if live else np.zeros((0, 2), np.int64))
    return from_edges(state.n, edges, symmetrize=True)


def scratch_state(state, inserts=None, deletes=None):
    """Rung 1: re-encode + recolor the updated graph through the
    ``api.color`` front door, on the state's device, inheriting the
    tenant's statics and budgets.

    A fresh encode re-picks the color cap and re-sizes the overflow buffer,
    so budget exhaustion that was really cap starvation is cured here; a
    genuinely unsatisfiable budget (or a still-armed fault) raises again
    and the caller falls to rung 2."""
    from repro_torch import api
    from repro_torch.dynamic import sharded

    if isinstance(state, sharded.ShardedColoringState):
        return sharded.scratch_sharded(state, inserts, deletes)
    empty = np.zeros((0, 2), np.int64)
    g2 = updated_graph(state, empty if inserts is None else inserts,
                       empty if deletes is None else deletes)
    res = api.color(
        g2, mode="incremental", seed=0, n_chunks=state.n_chunks,
        ell_cap=int(state.ell.shape[1]), ell_slack=0, C=None,
        ovf_cap=int(state.ovf_src.shape[0]), delta_cap=state.delta_cap,
        max_rounds=state.max_rounds, forbidden_impl=state.forbidden_impl,
        max_cap_retries=state.max_cap_retries,
        max_ovf_growth=state.max_ovf_growth, device=state.device)
    st = res.state
    # the incremental engine itself falls back to the oracle encode when the
    # from-scratch solve exhausts its cap budget — keep that attribution
    rung = 2 if st.last_degrade_rung == 2 else 1
    return dataclasses.replace(
        st, version=state.version + 1, last_degrade_rung=rung,
        retries=state.retries + st.retries, ovf_grows=state.ovf_grows,
        total_gather_passes=(state.total_gather_passes
                             + st.total_gather_passes))


def oracle_state(state, inserts=None, deletes=None):
    """Rung 2: serial First-Fit on the host, then a pure encode — no device
    coloring loop runs, so nothing is left to exhaust or inject into."""
    from repro_torch.dynamic import sharded

    if isinstance(state, sharded.ShardedColoringState):
        return sharded.oracle_sharded(state, inserts, deletes)
    empty = np.zeros((0, 2), np.int64)
    g2 = updated_graph(state, empty if inserts is None else inserts,
                       empty if deletes is None else deletes)
    st = encode_oracle_state(
        g2, seed=0, n_chunks=state.n_chunks,
        ell_cap=int(state.ell.shape[1]), ell_slack=0,
        ovf_cap=int(state.ovf_src.shape[0]), delta_cap=state.delta_cap,
        max_rounds=state.max_rounds, forbidden_impl=state.forbidden_impl,
        max_cap_retries=state.max_cap_retries,
        max_ovf_growth=state.max_ovf_growth, device=state.device)
    return dataclasses.replace(
        st, version=state.version + 1, retries=state.retries,
        ovf_grows=state.ovf_grows,
        total_gather_passes=state.total_gather_passes)


def encode_oracle_state(g, *, seed=0, n_chunks=16, ell_cap=512, ell_slack=4,
                        ovf_cap=None, delta_cap=2048, frontier_frac=0.125,
                        max_rounds=1000, forbidden_impl=None,
                        max_cap_retries=None, max_ovf_growth=None,
                        device="cpu"):
    """Serial-oracle colors + the standard mutable encode of ``g`` on
    ``device``: the ``dynamic_state`` layout with ``greedy_sequential``
    colors in place of the device coloring loop (also the
    ``mode='incremental'`` engine's fallback when the *initial*
    from-scratch coloring exhausts its budget)."""
    import torch

    from repro_torch.core import coloring as col
    from repro_torch.core.context import resolve_impl
    from repro_torch.dynamic.incremental import DynamicColoringState, _encode

    impl = resolve_impl(forbidden_impl)
    colors = col.greedy_sequential(g)
    prob = col.prepare(g, seed, n_chunks, ell_cap, C=None, device=device)
    colors_np = np.full((prob.n_pad,), -1, np.int32)
    colors_np[prob.perm] = colors
    n_used = int(colors.max()) + 1 if len(colors) else 1
    C = max(32, -(-n_used // 32) * 32)   # headroom for future repairs
    return DynamicColoringState(
        **_encode(prob, torch.from_numpy(colors_np).to(prob.device),
                  n_chunks=n_chunks, ell_slack=ell_slack, ovf_cap=ovf_cap,
                  delta_cap=delta_cap, frontier_frac=frontier_frac),
        C=C, forbidden_impl=impl, max_rounds=int(max_rounds),
        max_cap_retries=max_cap_retries, max_ovf_growth=max_ovf_growth,
        version=0, last_degrade_rung=2)


def apply_with_ladder(state, inserts, deletes):
    """Apply one batch, degrading on budget exhaustion.

    Returns ``(new_state, rung)`` with ``rung`` the index into
    ``RUNG_NAMES`` that produced the state.  Only budget-exhaustion errors
    degrade; anything else (injected step faults, real bugs) propagates so
    the service's transactional rollback handles it."""
    from repro_torch.dynamic.incremental import recolor_incremental
    from repro_torch.dynamic.sharded import (ShardedColoringState,
                                             recolor_sharded)

    recolor = (recolor_sharded if isinstance(state, ShardedColoringState)
               else recolor_incremental)
    try:
        return recolor(state, inserts, deletes), 0
    except (CapRetryExhausted, OvfGrowthExhausted):
        pass
    obs_metrics.counter("resilience.degrade", rung="scratch").inc()
    try:
        st = scratch_state(state, inserts, deletes)
    except (CapRetryExhausted, OvfGrowthExhausted):
        pass
    else:
        if st.last_degrade_rung == 2:   # engine already dropped to oracle
            obs_metrics.counter("resilience.degrade", rung="oracle").inc()
        return st, st.last_degrade_rung
    obs_metrics.counter("resilience.degrade", rung="oracle").inc()
    return oracle_state(state, inserts, deletes), 2
