"""Regenerate ``tests/torch_golden.json`` from the JAX reference package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py

The file ties the port's output on a GPU (``chip_smoke.py`` reads it there,
where JAX is not used) to the reference package's.  Per run of ``runs()`` —
``paper_suite("tiny")`` x seeds 0-2 with the default spec, with
``distance=2`` and with ``algorithm=`` each of the paper's baselines
``cat``, ``gm`` and ``jp``, and two bipartite graphs x seeds 0-2 with
``distance=2, mode="partial"`` — it holds the integer result fields of
``repro.api.color`` and a SHA-256 of ``colors.tobytes()`` (int32).  ``tests/test_torch_golden.py``
fails when the file is stale.

Two more sections hold the dynamic subsystem.  ``incremental``: per
``paper_suite("tiny")`` graph, ``api.color(g, mode="incremental",
**INC_OPTS)`` then ``STREAM_BATCHES`` batches of ``recolor_incremental``
(``stream_batches``: seed 0), with the state's ``INC_FIELDS`` and a colors
SHA-256 after each batch.  ``service``: one megabatched ``ColoringService``
of ``SVC_TENANTS`` tenants stepped ``SVC_STEPS`` times (``service_stream``),
with each tenant's ``summary()`` and colors SHA-256 after each step.

Two more hold the distributed engines, made on meshes of host devices.
``distributed``: ``paper_suite("tiny")`` x seeds 0-2 x ``rsoc`` / ``cat``
with ``backend="distributed"`` on meshes of ``DIST_SHARDS`` shards
(``dist_runs``).  ``sharded``: ``mesh2d(24, 24)`` through ``mode=
"incremental", backend="distributed"`` on the same meshes, then
``SHARD_BATCHES`` batches of ``recolor_sharded`` (``sharded_stream``), with
the state's ``SHARD_FIELDS`` and a colors SHA-256 after each.  The
reference needs ``XLA_FLAGS`` set before JAX is imported for a mesh of more
than one device, so ``main`` makes these two sections in a subprocess
(``reference_mesh_sections``) and the others exactly as before.
"""
import hashlib
import json
import os

import numpy as np

FIELDS = ("n_rounds", "total_conflicts", "final_C", "retries", "n_colors")
SEEDS = (0, 1, 2)
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_golden.json")


def entry(res) -> dict:
    d = {f: int(getattr(res, f)) for f in FIELDS}
    d["colors_sha256"] = hashlib.sha256(
        np.ascontiguousarray(res.colors, dtype=np.int32).tobytes()).hexdigest()
    return d


N_LEFT = 80      # left side of the bipartite graphs (mode="partial")
BASELINES = ("cat", "gm", "jp")   # the distance-1 engines beside RSOC


def runs(gen):
    """``(key, graph, spec overrides)`` of every golden entry; ``gen`` is a
    generators module (the reference's or the port's: same graphs)."""
    for name, g in gen.paper_suite("tiny").items():
        for seed in SEEDS:
            yield f"{name}/seed={seed}", g, dict(seed=seed)
            yield f"d2/{name}/seed={seed}", g, dict(seed=seed, distance=2)
            for algo in BASELINES:
                yield (f"{algo}/{name}/seed={seed}", g,
                       dict(seed=seed, algorithm=algo))
    bipartite = {"bipartite_random": gen.bipartite_random(N_LEFT, 50, 3.0,
                                                          seed=7),
                 "bipartite_banded": gen.bipartite_banded(N_LEFT, 50)}
    for name, g in bipartite.items():
        for seed in SEEDS:
            yield (f"partial/{name}/seed={seed}", g,
                   dict(seed=seed, distance=2, mode="partial", n_left=N_LEFT))


def compute(color, gen) -> dict:
    """``{key: entry}`` for a ``color(g, **overrides)`` callable."""
    return {key: entry(color(g, **kw)) for key, g, kw in runs(gen)}


def sha(colors) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        colors, dtype=np.int32).tobytes()).hexdigest()


# --------------------------------------------------------------------------
# the dynamic subsystem: incremental streams and a megabatched service
# --------------------------------------------------------------------------

INC_FIELDS = ("version", "last_rounds", "last_conflicts",
              "last_gather_passes", "C", "retries", "ovf_grows")
# ell_cap 16 spills the RMATs' hubs to the overflow buffer, delta_cap 32
# splits a batch into several waves
INC_OPTS = dict(seed=0, ell_cap=16, delta_cap=32)
STREAM_BATCHES = 10


def undirected(g) -> np.ndarray:
    """(m, 2) int64 u < v edges of a CSR graph (numpy only)."""
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    e = np.stack([src, np.asarray(g.indices, np.int64)], axis=1)
    return e[e[:, 0] < e[:, 1]]


def stream_batches(g, n_batches: int = STREAM_BATCHES, seed: int = 0,
                   k: int = 24):
    """``n_batches`` (inserts, deletes) pairs: k random inserts (self-loops
    dropped) and k / 2 deletes drawn from the graph's own edges."""
    rng = np.random.default_rng(seed)
    und = undirected(g)
    out = []
    for _ in range(n_batches):
        ins = rng.integers(0, g.n_vertices, size=(k, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        dels = und[rng.choice(len(und), size=min(k // 2, len(und)),
                              replace=False)]
        out.append((ins, dels))
    return out


def incremental_stream(color, recolor, g) -> list:
    """Per-batch entries of one graph's stream for a ``color(g, **kw)``
    front door and a ``recolor(state, ins, dels)`` of one package."""
    st = color(g, mode="incremental", **INC_OPTS).state
    rows = []
    for ins, dels in stream_batches(g):
        st = recolor(st, ins, dels)
        row = {f: int(getattr(st, f)) for f in INC_FIELDS}
        row["colors_sha256"] = sha(st.colors)
        rows.append(row)
    return rows


def incremental_entries(color, recolor, gen) -> dict:
    """``{graph: incremental_stream}`` over ``paper_suite("tiny")``."""
    return {name: incremental_stream(color, recolor, g)
            for name, g in gen.paper_suite("tiny").items()}


SVC_OPTS = dict(seed=0, n_chunks=2, ell_cap=12, C=32, ovf_cap=256,
                delta_cap=64, frontier_frac=0.5)
SVC_TENANTS, SVC_STEPS, SVC_N = 8, 2, 256


def service_stream(seed: int = 7):
    """``[step][tenant]`` lists of 4 (16 inserts, 8 deletes) batches."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(SVC_STEPS):
        per_t = []
        for _t in range(SVC_TENANTS):
            q = []
            for _b in range(4):
                ins = rng.integers(0, SVC_N, (16, 2))
                ins = ins[ins[:, 0] != ins[:, 1]]
                q.append((ins, rng.integers(0, SVC_N, (8, 2))))
            per_t.append(q)
        steps.append(per_t)
    return steps


def service_entries(svc, gen) -> list:
    """Per step, ``{tenant: summary + colors SHA-256}`` of a megabatched
    ``ColoringService`` (any package's, made by the caller) fed
    ``service_stream``."""
    for i in range(SVC_TENANTS):
        svc.add_graph(f"g{i}", gen.erdos_renyi(SVC_N, 8.0, seed=i))
    out = []
    for per_t in service_stream():
        for t, q in enumerate(per_t):
            for ins, dels in q:
                svc.submit(f"g{t}", inserts=ins, deletes=dels)
        svc.step()
        out.append({f"g{t}": dict(svc.stats(f"g{t}"),
                                  colors_sha256=sha(svc.colors(f"g{t}")))
                    for t in range(SVC_TENANTS)})
    return out


# --------------------------------------------------------------------------
# the distributed engines: static on meshes, and the sharded stream
# --------------------------------------------------------------------------

DIST_SHARDS = (1, 4)
DIST_ALGOS = ("rsoc", "cat")
SHARD_FIELDS = INC_FIELDS + ("replans", "last_halo_bytes",
                             "halo_bytes_per_round", "n_shards")
SHARD_BATCHES = 5


def dist_runs(gen):
    """``(key, graph, D, spec overrides)`` of every ``distributed`` entry."""
    for name, g in gen.paper_suite("tiny").items():
        for seed in SEEDS:
            for algo in DIST_ALGOS:
                for D in DIST_SHARDS:
                    yield (f"{algo}/{name}/seed={seed}/D={D}", g, D,
                           dict(seed=seed, algorithm=algo,
                                backend="distributed"))


def distributed_entries(color, mesh_of, gen) -> dict:
    """``{key: entry}`` of ``dist_runs`` for a package's ``color`` and a
    ``mesh_of(D)`` maker of its meshes."""
    return {key: entry(color(g, mesh=mesh_of(D), **kw))
            for key, g, D, kw in dist_runs(gen)}


def sharded_stream(color, recolor, mesh_of, gen) -> dict:
    """``{"D=<D>": per-batch rows}``: ``mesh2d(24, 24)`` encoded over
    ``mesh_of(D)``, then ``SHARD_BATCHES`` batches (40 inserts, 15
    deletes; seed 7) of a package's ``recolor_sharded``."""
    g = gen.mesh2d(24, 24)
    out = {}
    for D in DIST_SHARDS:
        st = color(g, mode="incremental", backend="distributed",
                   mesh=mesh_of(D), seed=0).state
        rng = np.random.default_rng(7)
        rows = []
        for _ in range(SHARD_BATCHES):
            ins = rng.integers(0, g.n_vertices, size=(40, 2))
            dels = rng.integers(0, g.n_vertices, size=(15, 2))
            st = recolor(st, ins[ins[:, 0] != ins[:, 1]], dels)
            row = {f: int(getattr(st, f)) for f in SHARD_FIELDS}
            row["colors_sha256"] = sha(st.colors)
            rows.append(row)
        out[f"D={D}"] = rows
    return out


def mesh_sections() -> dict:
    """The reference's ``distributed`` and ``sharded`` sections (in a
    process whose JAX sees ``max(DIST_SHARDS)`` host devices)."""
    import jax
    from repro import api
    from repro.dynamic import recolor_sharded
    from repro.graphs import generators

    meshes = {D: jax.make_mesh((D,), ("data",)) for D in DIST_SHARDS}
    return {"distributed": distributed_entries(api.color, meshes.get,
                                               generators),
            "sharded": sharded_stream(api.color, recolor_sharded,
                                      meshes.get, generators)}


def start_mesh_sections():
    """Start ``mesh_sections()`` in a subprocess of this file that sets
    ``XLA_FLAGS`` before JAX is imported; ``finish_mesh_sections`` reads
    it.  (A caller may do other work meanwhile.)"""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(PATH)), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{max(DIST_SHARDS)}")
    env.pop("REPRO_FAULTS", None)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--mesh-sections"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish_mesh_sections(proc, timeout: float = 900) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


def reference_mesh_sections() -> dict:
    """``mesh_sections()`` of the reference, made in a subprocess."""
    return finish_mesh_sections(start_mesh_sections())


def main() -> None:
    from repro import api
    from repro.dynamic import ColoringService, recolor_incremental
    from repro.graphs import generators
    doc = {"generated_by": "tests/make_torch_golden.py (repro.api.color, "
                           "paper_suite('tiny') x seeds 0-2 at distance 1 "
                           "and 2 and with cat / gm / jp, bipartite partial "
                           "x seeds 0-2; incremental streams on "
                           "paper_suite('tiny'); a megabatched service; "
                           "rsoc / cat on meshes of 1 and 4 shards x "
                           "paper_suite('tiny') x seeds 0-2; sharded "
                           "streams on mesh2d(24, 24))",
           "results": compute(api.color, generators),
           "incremental": incremental_entries(api.color, recolor_incremental,
                                              generators),
           "service": service_entries(
               ColoringService(megabatch=True, **SVC_OPTS), generators),
           **reference_mesh_sections()}
    with open(PATH, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH} ({len(doc['results'])} entries, "
          f"{len(doc['incremental'])} incremental streams, "
          f"{len(doc['service'])} service steps, "
          f"{len(doc['distributed'])} distributed entries, "
          f"{len(doc['sharded'])} sharded streams)")


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--mesh-sections"]:
        print(json.dumps(mesh_sections()))
    else:
        main()
