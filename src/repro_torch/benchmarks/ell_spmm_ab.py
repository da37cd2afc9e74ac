"""B4 (``ell_spmm``) of two source trees, and variants of this tree's kernel,
on one table, timed in turns on one GPU.

    python3 src/repro_torch/benchmarks/ell_spmm_ab.py --base DIR \\
        [--scale 22] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  ``DIR`` is the root of another checkout
of this repository (for example the parent commit, unpacked with ``git
archive``).  The table is ``chip_smoke.py`` phase 5e's: the ELL table of
``generators.rmat_er(scale, edge_factor=8)`` (every vertex, its neighbours,
FILL-padded to the max degree) with d=100 features drawn from ``--seed`` on
the card, float32 and bfloat16, ``sum`` / ``mean`` / ``max``.

Trees: each tree's own ``ops.ell_aggregate`` in a process of its own (its
``repro_torch`` package, its kernels built into a directory of its own under
this repository's git-ignored ``build/ell_spmm_ab/``), in the order base,
this, this, base.  Variants: this tree's ``csrc/ell_spmm.cu`` with one design
choice changed, each built alone into its own library and called through
its C entry point, all in one process, in the order listed and then back:

  base             the kernel as committed
  threads_256      256-thread blocks (committed: 64)
  in_flight_2      2 feature-row loads a lane before a fold (committed: 3)
  in_flight_4      4 of them
  in_flight_8      8 of them
  evict_first      the table read with an L2 evict-first policy, not kept
                   in L1
  streaming_store  the output stored with st.global.cs (float32 rows of
                   16-B vectors and bfloat16 rows of 8- and 16-B ones: the
                   table's d = 100)

Every time is CUDA events around calls queued behind a device sleep (the
method of ``chip_smoke.device_ms``), the median of 5 rounds of 5 calls.
Prints one JSON object per line: the card's name and power limit, the
table, then one per tree turn and per variant turn, each with the six
times and a fingerprint of each output (the sum of its bits as integers):
equal fingerprints mean the outputs agree, which they must for kernels that
fold in the same order.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT = os.path.dirname(SRC)
OUT = os.path.join(ROOT, "build", "ell_spmm_ab")
D = 100
SLEEP_CYCLES = 20_000_000
CASES = [(dt, op) for dt in ("float32", "bfloat16")
         for op in ("sum", "mean", "max")]
VARIANTS = {
    "base": [],
    "threads_256": [("constexpr int kThreads = 64;",
                     "constexpr int kThreads = 256;")],
    "in_flight_2": [("constexpr int kInFlight = 3;",
                     "constexpr int kInFlight = 2;")],
    "in_flight_4": [("constexpr int kInFlight = 3;",
                     "constexpr int kInFlight = 4;")],
    "in_flight_8": [("constexpr int kInFlight = 3;",
                     "constexpr int kInFlight = 8;")],
    "evict_first": [
        ("__ldg(erow + j0 + lane)", "load_once(erow + j0 + lane)"),
        ("template <typename T, int V>\n__device__ __forceinline__ void fold",
         "__device__ __forceinline__ int load_once(const int* p) {\n"
         "  unsigned long long pol;\n"
         "  asm volatile(\"createpolicy.fractional.L2::evict_first.b64 "
         "%0, 1.0;\\n\" : \"=l\"(pol));\n"
         "  int v;\n"
         "  asm volatile(\"ld.global.nc.L1::no_allocate.L2::cache_hint.b32 "
         "%0, [%1], %2;\\n\" : \"=r\"(v) : \"l\"(p), \"l\"(pol));\n"
         "  return v;\n}\n\n"
         "template <typename T, int V>\n__device__ __forceinline__ void fold")],
    "streaming_store": [
        ("*reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);",
         "__stcs(reinterpret_cast<uint4*>(dst), "
         "make_uint4(w[0], w[1], w[2], w[3]));"),
        ("*reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);",
         "__stcs(reinterpret_cast<uint2*>(dst), make_uint2(w[0], w[1]));"),
        ("    *reinterpret_cast<Pack<T, V>*>(dst) = o;",
         "    if constexpr (sizeof(o) == 16)\n"
         "      __stcs(reinterpret_cast<float4*>(dst), "
         "*reinterpret_cast<const float4*>(&o));\n"
         "    else\n"
         "      *reinterpret_cast<Pack<T, V>*>(dst) = o;")],
}


def device_ms(fn, reps: int = 5, rounds: int = 5) -> float:
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


def fingerprint(t: torch.Tensor) -> int:
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return int(bits.long().sum())


def inputs(table: str, seed: int):
    ell = torch.from_numpy(np.load(table)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.randn((ell.shape[0], D), generator=gen, device="cuda")
    return ell, {"float32": f32, "bfloat16": f32.bfloat16()}


def run_tree(label: str, table: str, seed: int) -> dict:
    """One tree's ``ops.ell_aggregate`` (its package is first on sys.path)."""
    from repro_torch.kernels import _build, ops
    _build.library()
    ell, feats = inputs(table, seed)
    row = {"tree": label, "root": os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.dirname(_build.__file__))))}
    for dt, op in CASES:
        fn = lambda: ops.ell_aggregate(ell, feats[dt], op)
        row[f"{dt} {op} fingerprint"] = fingerprint(fn())
        row[f"{dt} {op} ms"] = device_ms(fn)
    return row


def build_variant(name: str, edits) -> str:
    """The variant's library: csrc/ell_spmm.cu copied, edited, built."""
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    out = os.path.join(OUT, "variants", name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "ell_spmm.cu")) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not in "
                               f"ell_spmm.cu once: {old!r}")
        src = src.replace(old, new)
    path = os.path.join(out, "ell_spmm.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, f"lib{name}.so")
    p = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-o", lib, path], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{p.stdout}{p.stderr}")
    return lib


def run_variants(libs: dict, table: str, seed: int) -> list:
    """Every variant through its C entry point, in turns, in this process."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_spmm import DTYPES, OPS, pick_lanes, pick_vec
    ell, feats = inputs(table, seed)
    R, W = ell.shape
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.ell_spmm.argtypes = _build.SIGNATURES["ell_spmm"]
        lib.ell_spmm.restype = ctypes.c_int
        loaded[name] = lib

    def call(lib, f, op):
        out = torch.empty((R, D), dtype=f.dtype, device="cuda")
        vec = pick_vec(D, f, out)
        err = lib.ell_spmm(ell.data_ptr(), f.data_ptr(), out.data_ptr(), R, W,
                           f.shape[0], D, OPS[op], DTYPES[f.dtype],
                           pick_lanes(D, vec), vec,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ell_spmm launch failed ({err})")
        return out

    rows = []
    order = list(loaded) + list(loaded)[::-1]
    for turn, name in enumerate(order):
        row = {"variant": name, "turn": turn}
        for dt, op in CASES:
            fn = lambda: call(loaded[name], feats[dt], op)
            row[f"{dt} {op} fingerprint"] = fingerprint(fn())
            row[f"{dt} {op} ms"] = device_ms(fn)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=False,
                    help="root of the other checkout (the base tree)")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", nargs=3, metavar=("LABEL", "ROOT", "TABLE"),
                    help=argparse.SUPPRESS)      # one tree, in a subprocess
    ap.add_argument("--variants", nargs=2, metavar=("LIBS", "TABLE"),
                    help=argparse.SUPPRESS)      # the variants, in one
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.tree:
        label, root, table = args.tree
        sys.path.insert(0, os.path.join(root, "src"))
        print(json.dumps(run_tree(label, table, args.seed)), flush=True)
        return 0
    if args.variants:
        sys.path.insert(0, SRC)
        for row in run_variants(json.loads(args.variants[0]),
                                args.variants[1], args.seed):
            print(json.dumps(row), flush=True)
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
    # the table, once (host numpy), shared by every process through a file
    sys.path.insert(0, SRC)
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import to_ell
    os.makedirs(OUT, exist_ok=True)
    table = os.path.join(OUT, f"rmat_er_{args.scale}.npy")
    g = generators.rmat_er(args.scale, edge_factor=8)
    ell = to_ell(g)
    np.save(table, ell)
    print(json.dumps({"table": f"rmat_er_{args.scale}", "R": ell.shape[0],
                      "W": ell.shape[1], "live_slots": int((ell >= 0).sum()),
                      "d": D}), flush=True)
    del g, ell
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: build_variant(*kv),
                                         VARIANTS.items())))
    me = os.path.abspath(__file__)
    runs = [[sys.executable, me, "--seed", str(args.seed), "--tree", label,
             root, table]
            for label, root in (("base", args.base), ("this", ROOT),
                                ("this", ROOT), ("base", args.base))]
    runs.append([sys.executable, me, "--seed", str(args.seed), "--variants",
                 json.dumps(libs), table])
    for cmd in runs:
        env = dict(os.environ)
        if "--tree" in cmd:
            label = cmd[cmd.index("--tree") + 1]
            env["REPRO_TORCH_BUILD_DIR"] = os.path.join(OUT, f"lib_{label}")
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return 1
        print(p.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
