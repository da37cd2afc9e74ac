"""The per-tenant frontier-compacted coloring loop of two source trees,
timed in turns on one GPU.

    python3 src/repro_torch/benchmarks/compact_pass_ab.py --base DIR \\
        [--scale 22] [--reps 5]

Needs one NVIDIA GPU and ``nvcc``.  ``DIR`` is the root of another checkout
of this repository (for example the parent commit, unpacked with ``git
archive``).  The loop is ``core/frontier.py``'s ``_rsoc_compact_loop``, the
``rsoc_compact`` engine without ``prepare``: round 0 on ``firstfit``, then
one compacted pass a round (the overflow snapshot, ``n_chunks`` launches of
``detect_recolor`` with ``row_ids``, the commits).  Two graphs, each
generated once here and shared with every process through a file:

  rmat_b   ``generators.rmat_b(scale, edge_factor=8)`` at the engine's
           defaults (``ell_cap`` 512, 16 chunks, ``frontier_frac`` 0.125,
           C 256): ``chip_smoke.py`` phase 5c's ``rsoc_compact`` run, ~94
           rounds over a 12M-entry overflow buffer
  er       ``generators.erdos_renyi(65536, 8.0, seed=0)`` at phase 5h's
           knobs (``ell_cap`` 12, 16 chunks, ``frontier_frac`` 0.5, C 32):
           one service tenant, where the host's launches set the time

Each tree runs in a process of its own (its ``repro_torch`` package, its
kernels built into a directory of its own under this repository's
git-ignored ``build/compact_pass_ab/``), in the order base, this, this,
base.  A process prepares each graph once on the card, calls the loop once
to warm up, then ``--reps`` times, each call between two device syncs
(host wall ms: the loop is driven from the host).  Prints one JSON object
per line: the card's name and power limit, then one per tree turn with, per
graph, the times, their median, the rounds and a fingerprint of the colours
(their sum and the sum of colour x (1 + vertex id mod 65521)): the loops
are bit-identical, so the fingerprints must agree across trees.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT = os.path.dirname(SRC)
OUT = os.path.join(ROOT, "build", "compact_pass_ab")
# graph -> (ell_cap, C, n_chunks, frontier_frac)
KNOBS = {"rmat_b": (512, 256, 16, 0.125), "er": (12, 32, 16, 0.5)}


def run_tree(label: str, graphs: dict, reps: int) -> dict:
    """One tree's turn: ``sys.path`` already leads to its ``src``."""
    from repro_torch.core import coloring as col, frontier
    from repro_torch.core.context import PassContext
    from repro_torch.graphs.csr import CSRGraph
    device = torch.device("cuda")
    out = {"tree": label, "source": os.path.dirname(frontier.__file__)}
    for name, path in graphs.items():
        ell_cap, C, n_chunks, frac = KNOBS[name]
        z = np.load(path)
        g = CSRGraph(indptr=z["indptr"], indices=z["indices"],
                     n_vertices=int(z["n"]))
        prob = col.prepare(g, 0, n_chunks, ell_cap, C, True, device=device)
        ctx = PassContext.for_problem(prob, n_chunks=n_chunks, C=C)
        cap = frontier.frontier_cap(prob.n_pad, n_chunks, frac)

        def call():
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = frontier._rsoc_compact_loop(prob.ell, prob.ovf_src,
                                              prob.ovf_dst, prob.pri, ctx,
                                              cap, 1000)
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t) * 1e3

        call()
        times = []
        for _ in range(reps):
            res, ms = call()
            times.append(round(ms, 3))
        colors, r = res[0], int(res[1])
        c = colors.long()
        w = torch.arange(c.numel(), device=device) % 65521 + 1
        out[name] = {"n": prob.n, "W": int(prob.ell.shape[1]),
                     "ovf_entries": int((prob.ovf_src >= 0).sum()),
                     "cap": cap, "rounds": r, "ms": times,
                     "median_ms": statistics.median(times),
                     "fingerprint": [int(c.sum()), int((c * w).sum())]}
        del prob, colors, res
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=False,
                    help="root of the other checkout (the base tree)")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tree", nargs=3, metavar=("LABEL", "ROOT", "GRAPHS"),
                    help=argparse.SUPPRESS)      # one tree, in a subprocess
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.tree:
        label, root, graphs = args.tree
        sys.path.insert(0, os.path.join(root, "src"))
        print(json.dumps(run_tree(label, json.loads(graphs), args.reps)),
              flush=True)
        return 0
    args.base = os.path.abspath(args.base or "")
    if not os.path.isdir(os.path.join(args.base, "src", "repro_torch")):
        print("--base must be the root of a checkout with src/repro_torch",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    sys.path.insert(0, SRC)
    from repro_torch.graphs import generators
    os.makedirs(OUT, exist_ok=True)
    graphs = {}
    for name, g in (("rmat_b", generators.rmat_b(args.scale, edge_factor=8)),
                    ("er", generators.erdos_renyi(65536, 8.0, seed=0))):
        graphs[name] = os.path.join(OUT, f"{name}.npz")
        np.savez(graphs[name], indptr=g.indptr, indices=g.indices,
                 n=g.n_vertices)
        del g
    me = os.path.abspath(__file__)
    for label, root in (("base", args.base), ("this", ROOT), ("this", ROOT),
                        ("base", args.base)):
        env = dict(os.environ)
        env["REPRO_TORCH_BUILD_DIR"] = os.path.join(OUT, f"lib_{label}")
        p = subprocess.run([sys.executable, me, "--reps", str(args.reps),
                            "--tree", label, root, json.dumps(graphs)],
                           capture_output=True, text=True, env=env)
        if p.returncode:
            sys.stderr.write(p.stderr[-4000:])
            return p.returncode
        sys.stdout.write(p.stdout)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
