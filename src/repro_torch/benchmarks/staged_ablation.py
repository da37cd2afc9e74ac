"""Where the staged pass's time goes: ablations of ``csrc/staged_pass.cuh``
on one H100, on synthetic chunks shaped like ``chip_smoke.py`` phase 6's.

    python3 src/repro_torch/benchmarks/staged_ablation.py [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds the two-hop and repair-pass
kernels (``twohop.cu``, ``twohop_staged.cu``, ``detect_recolor.cu``) once per
variant — the sources as they are, then with one cost taken out — each into
its own library under ``build/staged_ablation/`` of the repo (git-ignored),
and times
every variant, each in a process of its own (one kernel library a process),
on the same inputs made from ``--seed``, with CUDA events around launches
queued behind a device sleep (``chip_smoke.device_ms``'s method):

  base             the kernels as committed
  no_colour_loads  a slot's "colour" is its id & 255: no L2 colour lookups
  rows_from_l2     every copy reads a row of the first 1024 (B3: table
                   rows; B2: tile rows), a slice that stays in L2: the
                   copies' device-memory traffic goes, their count, the
                   ids the gathers see and the colour lookups stay

B3 runs the ``staged16`` design and, as a yardstick, ``direct``, on an
RMAT-ER-like chunk: 262144 rows of a 4194304 x 44 table, Poisson(16)
degrees, left-packed, C 512.  B2 runs ``vec16`` (8 lanes a row) on an
RMAT-B-like tile: 262144 x 512, skewed degrees, C 256.  A variant's
outputs are not checked (they are wrong by construction); the base's B3
outputs are held bit-equal to the ``direct`` design's.  Prints one JSON
object per line: the card's name and power limit, then one per variant.
The differences between variants are what each cost adds on top of the
others, not a sum: the costs overlap.

The base variant also times both designs of each kernel on the meshes'
chunks (``chip_smoke.py`` phase 6's: chunk 8 of 16 after round 0, the
``paper_suite("medium")`` meshes), the grounds of the wrappers'
``DIRECT_MAX_W``: B2 ``direct`` against ``vec16`` at 8 lanes where the
rows are whole 16-B chunks, B3 ``direct`` against ``staged16`` /
``staged4``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT = os.path.dirname(SRC)

COLOUR = "c[u] = s[u] < 0 ? -1 : __ldg(a.colors + s[u]);"
VARIANTS = {
    "base": [],
    "no_colour_loads": [(COLOUR, "c[u] = s[u] < 0 ? -1 : (s[u] & 255);")],
    "rows_from_l2": [
        ("a.ell_all + s * W + ch * VEC,", "a.ell_all + (s & 1023) * W + ch * VEC,"),
        ("cp_async<4>(st + 4 * f, src + 4 * f, once);",
         "cp_async<4>(st + 4 * f, a.ell_rows + (row & 1023) * W + b * kb"
         " + 4 * f, once);")],
}
SOURCES = ("coloring.cu", "twohop.cu", "twohop_staged.cu",
           "detect_recolor.cu")
SLEEP_CYCLES = 20_000_000


def build(name: str, edits) -> str:
    """The variant's library: the package's csrc/ copied, edited, built."""
    from repro_torch.kernels import _build
    out = os.path.join(ROOT, "build", "staged_ablation", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    path = os.path.join(out, "staged_pass.cuh")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not in "
                               f"staged_pass.cuh once: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    nvcc = _build.find_nvcc()
    objs = []
    for s in SOURCES:
        o = os.path.join(out, s + ".o")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o,
                        os.path.join(out, s)], check=True,
                       capture_output=True)
        objs.append(o)
    lib = os.path.join(out, f"lib{name}.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True,
                   capture_output=True)
    return lib


def load(path: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(path)
    for fn in ("coloring_twohop_detect_recolor", "coloring_detect_recolor"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def device_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def left_packed(deg, n: int, W: int, gen) -> torch.Tensor:
    ids = torch.randint(0, n, (deg.shape[0], W), device="cuda",
                        generator=gen, dtype=torch.int32)
    cols = torch.arange(W, device="cuda")[None, :]
    return torch.where(cols < deg[:, None], ids, -1).contiguous()


def run_variant(name: str, lib_path: str, seed: int) -> dict:
    """Time one variant's kernels (this process loads its library only)."""
    import repro_torch.core  # noqa: F401  (imports the kernels' wrappers)
    from repro_torch.kernels.firstfit import ptr
    lib = load(lib_path)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    R, lo = 262144, 8 * 262144
    U = torch.ones(R, dtype=torch.bool, device=dev)
    zero = torch.zeros(R, dtype=torch.bool, device=dev)
    outs = (torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.bool, device=dev),
            torch.empty(R, dtype=torch.bool, device=dev))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    row = {"variant": name}

    # B3: an RMAT-ER-like chunk
    n, W, C = 4194304, 44, 512
    deg = torch.poisson(torch.full((n,), 16.0, device=dev),
                        generator=gen).clamp(max=W).int()
    ell = left_packed(deg, n, W, gen)
    colors = torch.randint(0, 91, (n,), device=dev, generator=gen,
                           dtype=torch.int32)
    pri = torch.randperm(n, device=dev, generator=gen).int()
    rows = ell[lo:lo + R]

    def b3(design):
        def f():
            err = lib.coloring_twohop_detect_recolor(
                ptr(rows), ptr(ell), ptr(colors), ptr(pri), ptr(U), ptr(zero),
                ptr(U), None, *map(ptr, outs), R, W, n, n, C, lo, 1, 32, 16,
                design, stream())
            if err:
                raise RuntimeError(f"twohop launch failed ({err})")
        return f

    if name == "base":
        b3(0)()
        want = [t.clone() for t in outs]
        b3(1)()
        row["staged16_equals_direct"] = all(
            torch.equal(g, w) for g, w in zip(outs, want))
        row["b3_direct_ms"] = device_ms(b3(0))
    row["b3_staged16_ms"] = device_ms(b3(1))
    del ell, rows, deg

    # B2: an RMAT-B-like tile (most rows short, a few long)
    n2, W2, C2 = 4194304, 512, 256
    deg2 = (torch.rand(R, device=dev, generator=gen) ** 6 * 200).int()
    tile = left_packed(deg2, n2, W2, gen)
    colors2 = torch.randint(0, 177, (n2,), device=dev, generator=gen,
                            dtype=torch.int32)
    pri2 = torch.randperm(n2, device=dev, generator=gen).int()

    def b2():
        err = lib.coloring_detect_recolor(
            ptr(tile), ptr(colors2), ptr(pri2), ptr(U), None, None,
            ptr(zero), ptr(U), None, *map(ptr, outs), R, W2, n2, C2, lo, 8,
            8, 0, stream())
        if err:
            raise RuntimeError(f"detect_recolor launch failed ({err})")

    row["b2_vec16_ms"] = device_ms(b2)
    if name == "base":
        row["b2_live_slots"] = int((tile >= 0).sum())
        row["b2_tile_bytes_ms"] = R * W2 * 4 / 3.35e12 * 1e3
        del tile
        row["meshes"] = mesh_designs(lib)
    return row


def mesh_designs(lib) -> dict:
    """Device ms of each design of B2 and B3 at the meshes' phase-6 chunks
    (B2: distance 1; B3: distance 2; round-0 colours, U = every row)."""
    from repro_torch import api
    from repro_torch.core import coloring, distance2
    from repro_torch.core.context import PassContext
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels import detect_recolor as dr, twohop as th
    from repro_torch.kernels.firstfit import pick_lanes, ptr
    dev = torch.device("cuda")
    spec = api.ColoringSpec()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = {}
    for name, g in (("mesh2d", gen.mesh2d(500, 500)),
                    ("bmw3_2", gen.mesh3d(61, 61, 61)),
                    ("pwtk", gen.mesh3d(72, 55, 55))):
        row = {}
        for hops in (1, 2):
            if hops == 1:
                C = api.color(g, device=dev).final_C
                prob = coloring.prepare(g, spec.seed, spec.n_chunks,
                                        spec.ell_cap, C, spec.relabel,
                                        device=dev)
            else:
                C = api.color(g, device=dev, distance=2).final_C
                prob = distance2._prepare_native(
                    g, spec.seed, spec.n_chunks, C, spec.relabel,
                    spec.ell_cap, device=dev)
            n, W = prob.n_pad, prob.ell.shape[1]
            cs, k = n // spec.n_chunks, spec.n_chunks // 2
            lo = k * cs
            ctx = PassContext.for_problem(prob, n_chunks=spec.n_chunks, C=C)
            valid = torch.arange(n, device=dev) < prob.n
            zeros = torch.zeros(n, dtype=torch.bool, device=dev)
            colors = torch.full((n,), -1, dtype=torch.int32, device=dev)
            if hops == 1:
                coloring._chunked_pass(ctx, prob.ell, prob.ovf_src,
                                       prob.ovf_dst, prob.pri, colors, zeros,
                                       valid, detect=False)
            else:
                distance2._d2_chunked_pass(ctx, prob.ell, prob.pri, valid,
                                           colors, zeros, valid, detect=False)
            outs = (torch.empty(cs, dtype=torch.int32, device=dev),
                    torch.empty(cs, dtype=torch.bool, device=dev),
                    torch.empty(cs, dtype=torch.bool, device=dev))
            rows, U, z = prob.ell[lo:lo + cs], valid[lo:lo + cs], zeros[lo:lo + cs]
            window = 2 if C <= 64 else (8 if C <= 256 else 16)
            staged3 = "staged16" if W % 4 == 0 else "staged4"

            def call(design, lanes):
                def f():
                    if hops == 1:
                        err = lib.coloring_detect_recolor(
                            ptr(rows), ptr(colors), ptr(prob.pri), ptr(U),
                            None, None, ptr(z), ptr(U), None,
                            *map(ptr, outs), cs, W, n, C, lo, lanes, window,
                            design, stream())
                    else:
                        err = lib.coloring_twohop_detect_recolor(
                            ptr(rows), ptr(prob.ell), ptr(colors),
                            ptr(prob.pri), ptr(U), ptr(z), ptr(U), None,
                            *map(ptr, outs), cs, W, n, prob.ell.shape[0], C,
                            lo, 1, lanes, window, design, stream())
                    if err:
                        raise RuntimeError(f"launch failed ({err})")
                return f

            if hops == 1:
                row["b2_W"] = W
                row["b2_direct_ms"] = device_ms(
                    call(dr.DESIGNS.index("direct"), pick_lanes(W)))
                if W % 4 == 0:
                    row["b2_vec16_ms"] = device_ms(
                        call(dr.DESIGNS.index("vec16"), 8))
            else:
                row["b3_W"] = W
                row["b3_direct_ms"] = device_ms(call(0, pick_lanes(W)))
                row[f"b3_{staged3}_ms"] = device_ms(
                    call(th.DESIGNS.index(staged3), pick_lanes(W)))
        out[name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", nargs=2, metavar=("NAME", "LIBRARY"),
                    help=argparse.SUPPRESS)   # one variant, in a subprocess
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.variant:
        print(json.dumps(run_variant(*args.variant, args.seed)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: build(*kv),
                                         VARIANTS.items())))
    for name, path in libs.items():
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--seed", str(args.seed), "--variant", name,
                            path], capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return 1
        print(p.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main())
