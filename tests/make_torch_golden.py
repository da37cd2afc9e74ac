"""Regenerate ``tests/torch_golden.json`` from the JAX reference package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py

The file ties the port's output on a GPU (``chip_smoke.py`` reads it there,
where JAX is not used) to the reference package's: per (graph, seed) of
``paper_suite("tiny")`` x seeds 0-2 it holds the integer result fields of
``repro.api.color`` and a SHA-256 of ``colors.tobytes()`` (int32).
``tests/test_torch_golden.py`` fails when the file is stale.
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


def compute(color, suite) -> dict:
    """``{"<graph>/seed=<s>": entry}`` for a ``color(g, seed=...)`` callable."""
    return {f"{name}/seed={seed}": entry(color(g, seed=seed))
            for name, g in suite.items() for seed in SEEDS}


def main() -> None:
    from repro import api
    from repro.graphs.generators import paper_suite
    doc = {"generated_by": "tests/make_torch_golden.py (repro.api.color, "
                           "default spec, paper_suite('tiny'), seeds 0-2)",
           "results": compute(api.color, paper_suite("tiny"))}
    with open(PATH, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH} ({len(doc['results'])} entries)")


if __name__ == "__main__":
    main()
