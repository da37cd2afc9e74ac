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


def main() -> None:
    from repro import api
    from repro.dynamic import ColoringService, recolor_incremental
    from repro.graphs import generators
    doc = {"generated_by": "tests/make_torch_golden.py (repro.api.color, "
                           "paper_suite('tiny') x seeds 0-2 at distance 1 "
                           "and 2 and with cat / gm / jp, bipartite partial "
                           "x seeds 0-2; incremental streams on "
                           "paper_suite('tiny'); a megabatched service)",
           "results": compute(api.color, generators),
           "incremental": incremental_entries(api.color, recolor_incremental,
                                              generators),
           "service": service_entries(
               ColoringService(megabatch=True, **SVC_OPTS), generators)}
    with open(PATH, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH} ({len(doc['results'])} entries, "
          f"{len(doc['incremental'])} incremental streams, "
          f"{len(doc['service'])} service steps)")


if __name__ == "__main__":
    main()
