"""B5's sm90 design (``csrc/flash_attention_sm90.cu``) with one design
choice changed, at the head dims of its tail panel, timed in turns on one
GPU.

    python3 src/repro_torch/benchmarks/attention_sm90_ab.py [--len 2048]

Needs one NVIDIA GPU and ``nvcc``.  Shapes: ``chip_smoke.py`` phase 6's
attention rows — qwen3-32b's prefill (1 x 64 / 8 heads, D 80),
minicpm3-4b's MLA prefill (1 x 40 / 40 heads, D 96) and the serving
prefill's (1 x 16 / 8 heads, D 128) — bfloat16, causal, L = ``--len``,
inputs drawn on the card from seed 1.  Variants, each a copy of this
tree's source with one constant changed, built alone into its own library
under the git-ignored ``build/attention_sm90_ab/`` and called through its
C entry point ``attn_flash_sm90``, all in one process, in the order listed
and then back:

  base        the kernel as committed (a ring of 2 K / V stages)
  stages_3    a ring of 3 stages (fits at D 80 / 96: 143 / 172 KB)
  padded_128  D 80 / 96 run as D 128 on copies of q, k and v zero-padded
              to 128 columns (made before the timed calls), with the scale
              of the real D, output sliced back: the design's other route
              to these head dims, a 64-column tail panel that TMA fills
              with zeros (128 / D more work)

Every time is CUDA events around calls queued behind a device sleep (the
method of ``chip_smoke.device_ms``), the median of 5 rounds of 10 calls.
Prints one JSON object per line: the card's name and power limit, then one
per variant turn with each shape's ms, its bound (4 Hq D FLOPs a visible
pair at 989 TFLOP/s) and share, and the largest difference from ``base``'s
output (0 where the arithmetic is the same).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT = os.path.dirname(SRC)
CU = os.path.join(SRC, "repro_torch", "kernels", "csrc",
                  "flash_attention_sm90.cu")
OUT = os.path.join(ROOT, "build", "attention_sm90_ab")
SLEEP_CYCLES = 20_000_000
BF16_FLOPS = 989e12
SHAPES = ((64, 8, 80), (40, 40, 96), (16, 8, 128))    # (Hq, Hkv, D), B 1
VARIANTS = {"base": [],
            "stages_3": [("constexpr int kStages = 2;",
                          "constexpr int kStages = 3;")],
            "padded_128": []}


def build(name: str, edits) -> ctypes.CDLL:
    """Copy the source, apply ``edits`` (each must match once), compile it
    alone into ``build/attention_sm90_ab/<name>.so`` and load it."""
    text = open(CU).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} found {text.count(old)} "
                             f"times in {CU}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    lib, src], check=True, capture_output=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.attn_flash_sm90.argtypes = ([p] * 4 + [i] * 7
                                    + [ctypes.c_longlong] * 9
                                    + [ctypes.c_float, p])
    return dll


def call(dll, q, k, v, out, D_real):
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    st = [x for t in (q, k, v) for x in t.stride()[:3]]
    err = dll.attn_flash_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, Hq, Hkv, L, L, D, 1, *st,
                              1.0 / D_real ** 0.5,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"attn_flash_sm90 returned {err}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--len", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "len": args.len}), flush=True)
    L = args.len
    pairs = L * (L + 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = {}
    for Hq, Hkv, D in SHAPES:
        q, k, v = (torch.randn((1, H, L, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for H in (Hq, Hkv, Hkv))
        pad = [torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v)]
        inputs[D] = (q, k, v, pad)
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()
            if name != "padded_128"}
    libs["padded_128"] = libs["base"]
    want = {}
    for name in list(VARIANTS) + list(reversed(VARIANTS)):
        row = {"variant": name}
        for Hq, Hkv, D in SHAPES:
            q, k, v, pad = inputs[D]
            if name == "padded_128":
                if D == 128:
                    continue
                out = torch.empty_like(pad[0])
                fn = lambda: call(libs[name], *pad, out, D)
            else:
                out = torch.empty_like(q)
                fn = lambda: call(libs[name], q, k, v, out, D)
            ms = device_ms(fn)
            fn()
            got = out[..., :D].float()
            want.setdefault(D, got.clone())
            bound = 4 * Hq * D * pairs / BF16_FLOPS * 1e3
            row[f"D{D}"] = {"Hq": Hq, "Hkv": Hkv, "ms": ms,
                            "bound_ms": bound, "bound_share": bound / ms,
                            "max_abs_diff_vs_base": float(
                                (got - want[D]).abs().max())}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
