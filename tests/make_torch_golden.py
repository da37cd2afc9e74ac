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


def main() -> None:
    from repro import api
    from repro.graphs import generators
    doc = {"generated_by": "tests/make_torch_golden.py (repro.api.color, "
                           "paper_suite('tiny') x seeds 0-2 at distance 1 "
                           "and 2 and with cat / gm / jp, bipartite partial "
                           "x seeds 0-2)",
           "results": compute(api.color, generators)}
    with open(PATH, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH} ({len(doc['results'])} entries)")


if __name__ == "__main__":
    main()
