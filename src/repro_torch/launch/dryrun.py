"""Dry run: every (architecture x input shape) cell on the production meshes,
counted on meta tensors, with the roofline terms (the port's counterpart of
the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 256 / 512 host devices and
reads XLA's cost and memory analyses.  The port builds each cell on a mesh
of 256 / 512 ``meta`` positions (``make_production_mesh(device="meta")``:
nothing is allocated, nothing computed), runs its step once under
``launch/cost.py``'s counter, and reports FLOPs, bytes, collectives and
memory a device against the H100 constants (``launch/analysis.analyze``).
On meta the port takes the card's routes (``kernels.cost.on_card``): a
prefill's attention is B5's work, not the CPU's chunked attention.  Bytes
are an eager step's unfused traffic (an upper bound on a fused program's).
No card is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out build/dryrun/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs.common import shapes_for
from repro_torch.launch import analysis as AN
from repro_torch.launch import cells as CELLS
from repro_torch.launch.cost import count_step
from repro_torch.launch.mesh import make_production_mesh, n_chips

BYTES_NOTE = ("hbm bytes: every eager op's inputs and outputs, unfused (an "
              "upper bound on a fused program's traffic)")


def model_flops_for(arch: str, shape: str) -> float:
    arch_def = configs.get(arch)
    shp = shapes_for(arch_def.family)[shape]
    if arch_def.family == "lm":
        cfg = arch_def.make_full()
        return AN.lm_model_flops(cfg, shp["kind"], shp["batch"],
                                 shp["seq_len"])
    if arch_def.family == "gnn":
        cfg = arch_def.make_full(d_in=shp["d_feat"],
                                 n_classes=shp["n_classes"])
        shapes, n_nodes = CELLS._gnn_batch_shapes(arch_def.extras["model"],
                                                  shp)
        return AN.gnn_model_flops(arch, cfg, n_nodes, shapes["src"][0])
    cfg = arch_def.make_full()
    return AN.recsys_model_flops(cfg, shp["kind"], shp["batch"],
                                 shp.get("n_candidates", 0))


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        out[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.lstrip("-").isdigit() else v)
    return out or None


def _count(arch, shape, mesh, overrides, cut) -> tuple:
    """(cell, its step's count, seconds to build, seconds to count)."""
    t0 = time.perf_counter()
    cell = CELLS.build_cell(arch, shape, mesh, overrides=overrides, **cut)
    t_build = time.perf_counter() - t0
    out, cost = count_step(lambda *_: cell.run(), cell.args, mesh)
    del out
    return cell, cost, t_build, time.perf_counter() - t0 - t_build


PROBE_DEPTHS = (2, 3)


def extrapolate(at2, at3, n: int):
    """A count at ``n`` layers from the counts at ``PROBE_DEPTHS`` (2 and 3
    layers: the first layer's backward differs from the others' by a few
    ops, the rest repeat): every number ``a + (n - 2) * (b - a)`` (ints
    stay ints), anything else ``at3``'s."""
    if isinstance(at3, dict):
        return {k: extrapolate(at2[k], v, n) if k in at2 else v
                for k, v in at3.items()}
    if isinstance(at3, bool) or not isinstance(at3, (int, float)) \
            or isinstance(at2, bool):
        return at3
    return at2 + (n - PROBE_DEPTHS[0]) * (at3 - at2)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             overrides=None, mesh=None, **cut) -> dict:
    """One cell's record: build it on the meta production mesh (or
    ``mesh``), count one step, analyze.  ``cut``: ``build_cell``'s
    ``batch`` / ``seq_len`` / ``sizes`` (the cut is in ``static_notes``).
    ``t_build_s``: building the cell (weights and inputs placed on meta);
    ``t_count_s``: the counted step.

    An LM train cell with no ``n_layers`` override is counted at 2 and 3 layers and extrapolated to the config's depth:
    its layers run one program each (the same shapes, ops and
    collectives), and its weights and moments are stacked by layer, so
    FLOPs, ops and collectives are linear in the depth from the second
    layer on (bytes to a few bytes a layer, the memory peak where it falls
    at the same point of the step).  At full depth the
    checkpointed forward's autograd graph alone would hold about 0.4 GB of
    host memory a layer for 256 positions (``PERF.md`` §7)."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    arch_def = configs.get(arch)
    overrides = dict(overrides) if overrides else None
    probe = (arch_def.family == "lm"
             and shapes_for("lm")[shape]["kind"] == "train"
             and "n_layers" not in (overrides or {}))
    if probe:
        depth = (overrides or {}).get("n_layers",
                                      arch_def.make_full().n_layers)
        got = [_count(arch, shape, mesh, dict(overrides or {}, n_layers=k),
                      cut) for k in PROBE_DEPTHS]
        cell = got[1][0]
        cost = extrapolate(got[0][1], got[1][1], depth)
        t_build = got[0][2] + got[1][2]
        t_count = got[0][3] + got[1][3]
        cell.static_notes = (f"counted at {PROBE_DEPTHS[0]} and "
                             f"{PROBE_DEPTHS[1]} layers and extrapolated to "
                             f"{depth} (one program a layer)")
    else:
        cell, cost, t_build, t_count = _count(arch, shape, mesh, overrides,
                                              cut)
    res = AN.analyze(cost, n_chips(mesh), model_flops=0.0 if cut else
                     model_flops_for(arch, shape))
    mesh_name = "x".join(str(s) for s in mesh.axis_sizes)
    res.update(arch=arch, shape=shape, kind=cell.kind, mesh=mesh_name,
               t_build_s=round(t_build, 2), t_count_s=round(t_count, 2),
               overrides=overrides, static_notes=cell.static_notes,
               flops=cost["flops"], bytes=cost["bytes"],
               kernels=cost["kernels"], ops=cost["ops"],
               bytes_note=BYTES_NOTE, ok=True)
    if verbose:
        r = res["roofline"]
        peak = res["memory"].get("peak_bytes_per_device")
        peak_s = f" peak={peak / 2**30:.1f}GiB" if peak else ""
        print(f"[OK] {arch:24s} {shape:14s} {mesh_name:7s} "
              f"tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e} "
              f"tx={r['t_collective_s']:.3e} -> {r['bottleneck']:10s}"
              f"{peak_s} (build {t_build:.0f}s count {t_count:.0f}s)",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="no")
    ap.add_argument("--out", default=None, help="append-mode jsonl")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="model-config override (perf variants), repeatable")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)

    if args.all:
        grid = configs.all_cells()
    else:
        if not args.arch:
            raise SystemExit("--arch or --all required")
        shapes = ([args.shape] if args.shape else
                  list(shapes_for(configs.get(args.arch).family)))
        grid = [(args.arch, s) for s in shapes]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]

    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)

    n_fail = 0
    for arch, shape in grid:
        for mp in pods:
            mesh_name = "2x16x16" if mp else "16x16"
            if (arch, shape, mesh_name) in done:
                continue
            t0 = time.perf_counter()
            try:
                res = run_cell(arch, shape, mp, overrides=overrides)
            except Exception as e:
                n_fail += 1
                res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {arch} {shape} {mesh_name}: {e}", flush=True)
                traceback.print_exc()
            res["wall_s"] = round(time.perf_counter() - t0, 2)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
