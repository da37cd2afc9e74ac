"""Quickstart: color a graph through the one front door, repro_torch.api.color.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Every engine — the paper's RSOC, its predecessors, frontier compaction,
native distance-2, bipartite partial, incremental — is selected by a
``ColoringSpec`` (algorithm / distance / mode / backend), not by a separate
function.  With no ``--device`` the calls run on the CUDA card (and raise
where there is none); ``--device cpu`` takes the plain PyTorch path.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import api, obs
from repro_torch.core import coloring as col
from repro_torch.core.mesh import make_mesh
from repro_torch.dynamic import ColoringService
from repro_torch.graphs import generators as gen
from repro_torch.resilience import faults


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="None: the CUDA card (raises without one); cpu")
    ap.add_argument("--side", type=int, default=16,
                    help="the 3D mesh's side (16: 4096 vertices)")
    args = ap.parse_args(argv)
    dev = api._resolve_device(args.device)
    out = {}

    # 1. build a graph (a 3D tetrahedral mesh, the paper's high-degree regime)
    s = args.side
    g = gen.mesh3d(s, s, s)
    print(f"graph: {g.n_vertices} vertices, {g.n_edges} directed edges, "
          f"max degree {g.max_degree}")

    # 2. color it with the paper's algorithm (RSOC) and its predecessor
    #    (CAT): same entry point, different spec
    for key, name, spec in [
            ("cat", "CAT  (Catalyurek et al.)", api.ColoringSpec("cat")),
            ("rsoc", "RSOC (this paper)", api.ColoringSpec("rsoc"))]:
        res = api.color(g, spec, seed=0, device=dev)
        assert col.is_proper(g, res.colors)
        print(f"{name}: {res.n_colors} colors, {res.n_rounds} rounds, "
              f"{res.total_conflicts} conflicts, "
              f"{res.gather_passes} neighbor-gather passes")
        out[key] = {"colors": res.colors, "n_colors": res.n_colors,
                    "n_rounds": res.n_rounds,
                    "total_conflicts": res.total_conflicts,
                    "gather_passes": res.gather_passes}

    # 3. the result echoes the resolved spec — feed it back in to replay
    res = api.color(g, algorithm="rsoc", seed=0, device=dev)
    replay = api.color(g, res.spec, device=dev)
    assert np.array_equal(res.colors, replay.colors)
    out["replay_equal"] = True
    print(f"resolved spec key: {res.spec.spec_key()}")

    # 4. the whole support matrix is one registry
    print("supported specs:")
    for row in api.supported_specs():
        print(f"  algorithm={row['algorithm']:<13} distance={row['distance']}"
              f" mode={row['mode']:<12} backend={row['backend']:<12} "
              f"(replaces {row['replaces']})")

    # 5. other engines are just other specs: native distance-2 (G^2 colored
    #    without ever materializing it)
    res2 = api.color(g, distance=2, seed=0, device=dev)
    print(f"distance-2: {res2.n_colors} colors (distance={res2.distance})")
    out["distance2"] = {"colors": res2.colors, "n_colors": res2.n_colors,
                        "n_rounds": res2.n_rounds}

    # 6. compare against the serial First-Fit oracle
    serial = col.greedy_sequential(g)
    out["serial_colors"] = col.n_colors_used(serial)
    print(f"serial First-Fit: {out['serial_colors']} colors")

    # 7. use the coloring: independent sets for safe parallel execution
    sizes = np.bincount(res.colors)
    print(f"independent-set sizes: {sizes.tolist()}")
    print("largest set =", sizes.max(), "vertices can be processed in "
          "parallel")
    out["set_sizes"] = sizes.tolist()

    # 8. unsupported combos fail loudly, naming the nearest supported spec
    try:
        api.color(g, algorithm="cat", distance=2, device=dev)
    except ValueError as e:
        print(f"unsupported combo rejected: {e}")
        out["rejected"] = str(e)

    # 9. observability: spec.trace attaches a RunTrace (per-round
    #    conflicts, per-phase wall time, cap-retries) to the result
    res = api.color(g, algorithm="rsoc", seed=0, trace=True, device=dev)
    print(res.trace.summary_line())
    for ph in res.trace.phases:
        print(f"  phase {ph.name:<8} {ph.wall_s * 1e3:8.1f}ms  {ph.meta}")

    # 10. or scope a collector around existing untraced calls — every
    #     api.color inside the block is traced and collected
    with obs.trace() as tc:
        api.color(g, algorithm="cat", seed=0, device=dev)
        api.color(g, distance=2, seed=0, device=dev)
    print(f"collected {len(tc.traces)} traces:")
    for t in tc.traces:
        print(" ", t.summary_line())
    out["traces"] = len(tc.traces)

    # 11. long-lived multi-tenant serving: ColoringService owns many
    #     mutating graphs, applies queued edge updates on step(), and
    #     serves memoized coloring artifacts.  Same-shape tenants advance
    #     in ONE stacked dispatch per step (the megabatched repair: B2's
    #     slot-stride form on the card), bit-identical to stepping each
    #     tenant alone
    svc = ColoringService(seed=0, ell_cap=8, C=32, ovf_cap=256,
                          delta_cap=64, device=dev)
    for i in range(4):
        svc.add_graph(f"tenant{i}", gen.erdos_renyi(64, 5.0, seed=i))
    svc.submit("tenant0", inserts=[[0, 9], [3, 17]], deletes=[[0, 1]])
    svc.submit("tenant1", inserts=[[2, 11]])
    stats = svc.step()                  # one megabatched dispatch
    print(f"tenant0 v{svc.version('tenant0')}: "
          f"{stats['tenant0']['colors']} colors, "
          f"{len(svc.vertex_schedule('tenant0'))} schedule classes "
          f"(p50 step {svc.step_latency('tenant0')['p50']:.1f}ms)")
    out["tenant0"] = {"version": svc.version("tenant0"),
                      "colors": svc.colors("tenant0"),
                      "n_colors": stats["tenant0"]["colors"]}

    # 12. self-healing: steps are transactional — an error rolls the
    #     tenant back bit-exactly and requeues the batch; repeated failures
    #     quarantine it and heal() replays the dead letters once the cause
    #     is gone, bit-identical to a run that never failed
    svc.submit("tenant2", inserts=[[1, 5], [2, 8]])
    with faults.inject("service.step:p=1"):  # rehearse a step failure
        svc.step("tenant2")                  # rollback 1
        svc.step("tenant2")                  # rollback 2: quarantined
    q = svc.quarantined("tenant2")
    letters = svc.dead_letters("tenant2")
    print(f"tenant2 quarantined: reason={q.reason}, "
          f"{sum(d.n_edges() for d in letters)} edges dead-lettered")
    svc.heal("tenant2")                      # replay, verify, re-admit
    assert svc.quarantined("tenant2") is None
    assert col.is_proper(svc.graph("tenant2"), svc.colors("tenant2"))
    print(f"tenant2 healed: v{svc.version('tenant2')}, "
          f"{stats['tenant2']['colors']} -> "
          f"{int(svc.colors('tenant2').max()) + 1} colors, proper again")
    out["tenant2"] = {"healed": True, "version": svc.version("tenant2"),
                      "colors": svc.colors("tenant2")}

    # 13. sharded incremental: the same mutable graph laid out over a
    #     device mesh (core.mesh.make_mesh; one shard a card, or shards
    #     sharing one card), submit/step exactly as above, one O(boundary)
    #     collective per repair round.  A 1-shard mesh replays the
    #     single-device engine bit-for-bit
    mesh = make_mesh((1,), ("data",), device=dev)
    svc.add_graph("sharded0", gen.erdos_renyi(64, 5.0, seed=9), mesh=mesh)
    svc.submit("sharded0", inserts=[[0, 7], [5, 21]])
    svc.step("sharded0")
    st = svc.snapshot("sharded0")
    assert col.is_proper(svc.graph("sharded0"), svc.colors("sharded0"))
    print(f"sharded0 v{svc.version('sharded0')}: {st.n_shards} shard(s), "
          f"{st.summary()['halo_bytes_per_round']} halo bytes/round, "
          f"{st.n_colors} colors")
    out["sharded0"] = {"version": svc.version("sharded0"),
                       "colors": svc.colors("sharded0"),
                       "n_shards": st.n_shards}
    return out


if __name__ == "__main__":
    main()
