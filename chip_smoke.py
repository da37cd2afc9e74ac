#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), ``nvcc`` and
PyTorch built for CUDA.  Imports ``repro_torch`` only.  Phases, any failure
ends the run with a non-zero exit code:

  1. device   require CUDA; print the card's name and power limit and the
              torch / CUDA / nvcc / triton versions
  2. build    build the kernels from src/repro_torch/kernels/csrc
  3. kernels  each kernel against its plain PyTorch version on the card,
              bit-equal (tolerance 0: integer arithmetic), over shape sweeps
  4. golden   paper_suite("tiny") x seeds 0-2 through repro_torch.api.color on
              the card against tests/torch_golden.json (made by the JAX
              reference package)
  5. main     repro_torch.api.color(g), default spec, on the paper's graph
              classes at real size; launch counters zeroed before, read after
  5b. plain   the same problems through the plain versions on the card
              (kernel.fallback fault site), results equal field by field
  6. times    per-kernel time / plain-version time / bound at the shapes
              phase 5 used

The last line of the standard output is the result object; the line before
it the card's name and power limit; before that one JSON object per kernel.

``--rehearse`` runs the same control flow on the CPU at toy sizes to find
wrong paths and shapes before a GPU run; it builds and launches no kernel,
prints no result object and exits with code 3.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *a, flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def rand_ell(rng, R, W, n, frac_fill=0.3):
    ell = rng.integers(0, n, size=(R, W)).astype(np.int32)
    ell[rng.random((R, W)) < frac_fill] = -1
    return ell


def dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def rand_words(rng, R, C, device, density=0.2):
    """Random packed (R, n_words(C)) int32 forbidden words."""
    from repro_torch.core import bitset
    dense = (rng.random((R, C)) < density).astype(np.uint8)
    return bitset.pack_dense(dev(dense, device), C).contiguous()


class Cmp:
    """Kernel-vs-plain comparisons, collected per kernel."""

    def __init__(self):
        self.max_err = {"firstfit": 0, "detect_recolor": 0}
        self.cases = {"firstfit": [], "detect_recolor": []}

    def check(self, kernel, label, got, want, names):
        for g, w, nm in zip(got, want, names):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{kernel} {label}: output {nm} is {g.dtype}{tuple(g.shape)}"
                     f", plain version gives {w.dtype}{tuple(w.shape)}")
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            self.max_err[kernel] = max(self.max_err[kernel], err)
            if err != 0:
                bad = int((g != w).sum())
                fail(f"{kernel} {label}: output {nm} differs from the plain "
                     f"version on {bad} rows (max abs err {err})")
        self.cases[kernel].append(label)


def phase_kernels(device, launch: bool) -> Cmp:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.firstfit import LANES, WINDOWS
    kb = "cuda" if launch else "torch"
    cmp = Cmp()
    # (R, W, n, C): the reference's test sweeps, W=1, odd caps, ragged R
    ff_shapes = [(256, 8, 1024, 32), (512, 32, 512, 64), (256, 1, 64, 32),
                 (1024, 16, 4096, 128), (256, 16, 512, 4), (1000, 7, 3000, 33),
                 (77, 40, 500, 512), (333, 70, 2000, 1024), (1, 1, 1, 1),
                 (129, 600, 4096, 256)]
    for R, W, n, C in ff_shapes:
        rng = np.random.default_rng(R + W)
        ell = dev(rand_ell(rng, R, W, n), device)
        hi = max(C - 1, 1) if C > 4 else C
        colors = dev(rng.integers(-1, hi, size=(n,)).astype(np.int32), device)
        want = ref.firstfit_ref(ell, colors, C)
        got = ops.firstfit(ell, colors, C, backend=kb)
        cmp.check("firstfit", f"R{R} W{W} n{n} C{C}", got, want,
                  ("mex", "ovf"))
        f0 = rand_words(rng, R, C, device)
        want = ref.firstfit_ref(ell, colors, C, forb0=f0)
        got = ops.firstfit(ell, colors, C, backend=kb, forb0=f0)
        cmp.check("firstfit", f"R{R} W{W} n{n} C{C} +forb0", got, want,
                  ("mex", "ovf"))
    # (R, W, n, C, row_start)
    dr_shapes = [(256, 8, 1024, 32, 0), (256, 16, 1024, 64, 256),
                 (512, 4, 2048, 32, 1024), (256, 16, 512, 4, 0),
                 (256, 1, 512, 32, 100), (1000, 7, 3000, 33, 1500),
                 (77, 40, 500, 512, 423), (333, 70, 2000, 1024, 1),
                 (129, 600, 4096, 256, 3000)]
    names = ("newc", "recolored", "ovf")
    for R, W, n, C, row_start in dr_shapes:
        rng = np.random.default_rng(R * W)
        ell = dev(rand_ell(rng, R, W, n, 0.05 if C == 4 else 0.3), device)
        top = C if C == 4 else max(C // 2, 1)
        colors = rng.integers(0, top, size=(n,)).astype(np.int32)
        colors[rng.integers(0, n, size=n // 10)] = -1     # some uncolored
        colors = dev(colors, device)
        pri = dev(rng.permutation(n).astype(np.int32), device)
        U = dev(rng.random(R) < 0.7, device)
        want = ref.detect_recolor_ref(ell, colors, pri, row_start, U, C)
        got = ops.detect_recolor(ell, colors, pri, U, row_start, C,
                                 backend=kb)
        cmp.check("detect_recolor", f"R{R} W{W} n{n} C{C} rs{row_start}",
                  got, want, names)
        opt = dict(forb0=rand_words(rng, R, C, device),
                   extra_defect=dev(rng.random(R) < 0.2, device),
                   force=dev(rng.random(R) < 0.2, device),
                   valid=dev(rng.random(R) < 0.8, device))
        for keys in (("forb0",), ("extra_defect",), ("force",), ("valid",),
                     tuple(opt)):
            kw = {k: opt[k] for k in keys}
            want = ref.detect_recolor_ref(ell, colors, pri, row_start, U, C,
                                          **kw)
            got = ops.detect_recolor(ell, colors, pri, U, row_start, C,
                                     backend=kb, **kw)
            cmp.check("detect_recolor",
                      f"R{R} W{W} n{n} C{C} rs{row_start} +{'+'.join(keys)}",
                      got, want, names)
    # the saturation case of the reference's tests: ovf must fire
    rng = np.random.default_rng(22)
    n, W, R, C = 512, 16, 256, 4
    ell = dev(rand_ell(rng, n, W, n, 0.05)[:R], device)
    colors = dev(rng.integers(0, C, size=(n,)).astype(np.int32), device)
    pri = dev(rng.permutation(n).astype(np.int32), device)
    U = torch.ones(R, dtype=torch.bool, device=device)
    got = ops.detect_recolor(ell, colors, pri, U, 0, C, backend=kb)
    if not bool(got[2].any()) or not bool(
            ops.firstfit(ell, colors, C, backend=kb)[1].any()):
        fail("saturation case (C=4) did not raise the overflow flag")
    # every compiled (lanes, window) pair computes the same function
    if launch:
        from repro_torch.kernels.detect_recolor import detect_recolor
        from repro_torch.kernels.firstfit import firstfit
        rng = np.random.default_rng(5)
        R, W, n, C = 517, 45, 2048, 700
        ell = dev(rand_ell(rng, R, W, n), device)
        colors = dev(rng.integers(-1, 300, size=(n,)).astype(np.int32), device)
        pri = dev(rng.permutation(n).astype(np.int32), device)
        U = dev(rng.random(R) < 0.7, device)
        f0 = rand_words(rng, R, C, device, density=0.5)
        want_ff = ref.firstfit_ref(ell, colors, C, forb0=f0)
        want_dr = ref.detect_recolor_ref(ell, colors, pri, 1000, U, C,
                                         forb0=f0)
        for lanes in LANES:
            for window in WINDOWS:
                lab = f"R{R} W{W} n{n} C{C} lanes{lanes} window{window}"
                cmp.check("firstfit", lab,
                          firstfit(ell, colors, C, f0, lanes=lanes,
                                   window=window), want_ff, ("mex", "ovf"))
                cmp.check("detect_recolor", lab,
                          detect_recolor(ell, colors, pri, U, 1000, C, f0,
                                         lanes=lanes, window=window),
                          want_dr, names)
        torch.cuda.synchronize()
    return cmp


# --------------------------------------------------------------------------
# phase 4: golden file
# --------------------------------------------------------------------------

RESULT_FIELDS = ("n_rounds", "total_conflicts", "final_C", "retries",
                 "n_colors")


def golden_entry(res) -> dict:
    d = {f: int(getattr(res, f)) for f in RESULT_FIELDS}
    d["colors_sha256"] = hashlib.sha256(
        np.ascontiguousarray(res.colors, dtype=np.int32).tobytes()).hexdigest()
    return d


def phase_golden(device) -> int:
    from repro_torch import api
    from repro_torch.core.coloring import is_proper
    from repro_torch.graphs.generators import paper_suite
    path = os.path.join(HERE, "tests", "torch_golden.json")
    with open(path) as f:
        golden = json.load(f)["results"]
    n = 0
    for name, g in paper_suite("tiny").items():
        for seed in (0, 1, 2):
            res = api.color(g, device=device, seed=seed)
            got, want = golden_entry(res), golden[f"{name}/seed={seed}"]
            if got != want:
                fail(f"golden mismatch for {name} seed={seed}: "
                     f"got {got}, file has {want}")
            if not is_proper(g, res.colors):
                fail(f"golden run {name} seed={seed} is not a proper coloring")
            n += 1
    return n


# --------------------------------------------------------------------------
# phase 5: the main path at real size
# --------------------------------------------------------------------------

def result_fields(res) -> dict:
    return {"colors": res.colors, "n_rounds": res.n_rounds,
            "conflicts_per_round": np.asarray(res.conflicts_per_round),
            "total_conflicts": res.total_conflicts, "n_colors": res.n_colors,
            "overflow": res.overflow, "gather_passes": res.gather_passes,
            "final_C": res.final_C, "retries": res.retries,
            "trace_truncated": res.trace_truncated,
            "spec_key": dataclasses.replace(res.spec, trace=False).spec_key()}


def assert_same_result(a, b, what: str):
    fa, fb = result_fields(a), result_fields(b)
    for k in fa:
        same = (np.array_equal(fa[k], fb[k]) if isinstance(fa[k], np.ndarray)
                else fa[k] == fb[k])
        if not same:
            fail(f"{what}: ColoringResult.{k} differs "
                 f"({fa[k]!r} vs {fb[k]!r})")


def make_rmat(kind: str, scale: int):
    """Worker-process body: one RMAT, returned as plain arrays."""
    from repro_torch.graphs import generators as gen
    t = time.perf_counter()
    g = getattr(gen, kind)(scale, edge_factor=8)
    return g.indptr, g.indices, g.n_vertices, time.perf_counter() - t


def start_rmats(pool, scale: int) -> dict:
    """Start the three RMAT generators in worker processes: the host-side
    numpy generation (tens of seconds each at 2^22) then overlaps the build,
    the kernel checks and the mesh runs instead of preceding each RMAT."""
    return {f"{kind}_{scale}": pool.apply_async(make_rmat, (kind, scale))
            for kind in ("rmat_er", "rmat_g", "rmat_b")}


def build_graphs(rmats: dict, rehearse: bool):
    """name -> zero-argument constructor returning (graph, generate
    seconds), in running order."""
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.csr import CSRGraph

    def timed(fn):
        def make():
            t = time.perf_counter()
            g = fn()
            return g, time.perf_counter() - t
        return make

    def waited(fut):
        def make():
            indptr, indices, n, secs = fut.get()
            return CSRGraph(indptr=indptr, indices=indices, n_vertices=n), secs
        return make

    if rehearse:
        suite = {"mesh2d": timed(lambda: gen.mesh2d(24, 24)),
                 "bmw3_2": timed(lambda: gen.mesh3d(8, 8, 8)),
                 "pwtk": timed(lambda: gen.mesh3d(10, 8, 6))}
    else:
        # the three meshes of paper_suite("medium"): the paper's mesh sizes
        suite = {"mesh2d": timed(lambda: gen.mesh2d(500, 500)),
                 "bmw3_2": timed(lambda: gen.mesh3d(61, 61, 61)),
                 "pwtk": timed(lambda: gen.mesh3d(72, 55, 55))}
    for name, fut in rmats.items():
        suite[name] = waited(fut)
    return suite


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_main(rmats, device, rehearse: bool):
    from repro_torch import api, obs
    from repro_torch.core.coloring import is_proper
    from repro_torch.kernels.detect_recolor import detect_recolor
    from repro_torch.kernels.firstfit import firstfit
    n_chunks = api.ColoringSpec().n_chunks
    rows, kept = [], {}
    obs.metrics.reset()
    # counts to 0 just before the main path is driven ...
    firstfit.launches = 0
    detect_recolor.launches = 0
    for name, make in build_graphs(rmats, rehearse).items():
        g, gen_s = make()
        ff0, dr0 = firstfit.launches, detect_recolor.launches
        # run 1: the default call, cold (includes host-side prepare)
        sync(device)
        t = time.perf_counter()
        res = api.color(g, device=device)
        sync(device)
        e2e_ms = (time.perf_counter() - t) * 1e3
        ff1, dr1 = firstfit.launches, detect_recolor.launches
        # run 2: the same call traced, for the prepare / solve split (the
        # solve phase is synchronize()-bracketed by the tracer)
        res2 = api.color(g, device=device, trace=True)
        assert_same_result(res, res2, f"{name}: traced vs untraced run")
        prepare_ms = res2.trace.phase_wall_s("prepare") * 1e3
        solve_ms = res2.trace.phase_wall_s("solve") * 1e3
        if not is_proper(g, res.colors):
            fail(f"{name}: result is not a proper coloring")
        if res.colors.shape != (g.n_vertices,) or res.colors.dtype != np.int32:
            fail(f"{name}: colors have shape {res.colors.shape} "
                 f"dtype {res.colors.dtype}")
        if device.type == "cuda":
            want_ff = n_chunks * (1 + res.retries)
            if ff1 - ff0 != want_ff:
                fail(f"{name}: firstfit launched {ff1 - ff0} times, expected "
                     f"n_chunks*(1+retries) = {want_ff}")
            d = dr1 - dr0
            if (res.retries == 0 and d != n_chunks * res.n_rounds) or \
                    d < n_chunks * res.n_rounds or d % n_chunks:
                fail(f"{name}: detect_recolor launched {d} times, expected "
                     f"n_chunks*n_rounds = {n_chunks * res.n_rounds} per "
                     f"cap attempt")
        fb = obs.metrics.counters_matching("kernels.fallback")
        if fb:
            fail(f"{name}: kernels.fallback counters are not empty: {fb}")
        row = {"graph": name, "n": g.n_vertices, "directed_edges": g.n_edges,
               "max_degree": g.max_degree, "proper": True,
               "n_colors": res.n_colors, "n_rounds": res.n_rounds,
               "conflicts": res.total_conflicts, "retries": res.retries,
               "final_C": res.final_C, "generate_ms": round(gen_s * 1e3, 1),
               "e2e_cold_ms": round(e2e_ms, 2),
               "prepare_ms": round(prepare_ms, 2),
               "solve_ms": round(solve_ms, 3),
               "firstfit_launches": ff1 - ff0,
               "detect_recolor_launches": dr1 - dr0}
        log("main", json.dumps(row))
        rows.append(row)
        # kept for phase 5b / 6: the meshes and the uniform and the skewed
        # RMAT (the last one is the largest ELL table of the run)
        if not name.startswith("rmat_g"):
            kept[name] = (g, res)
        del g
    # ... and read just after
    counts = {"firstfit": firstfit.launches,
              "detect_recolor": detect_recolor.launches}
    if device.type == "cuda":
        for k, v in counts.items():
            if v < 1:
                fail(f"the main path never launched the {k} kernel")
    return rows, kept, counts


def phase_plain(device, kept):
    """The kept problems through the plain versions on the card."""
    from repro_torch import api, obs
    from repro_torch.kernels.detect_recolor import detect_recolor
    from repro_torch.kernels.firstfit import firstfit
    from repro_torch.resilience import faults
    done = []
    for name, (g, res) in kept.items():
        if name.startswith("rmat_b"):
            continue       # W = ell_cap rows: the plain pack is (rows, W, nW)
        before = (firstfit.launches, detect_recolor.launches)
        obs.metrics.reset()
        with faults.inject("kernel.fallback"):
            plain = api.color(g, device=device)
        if (firstfit.launches, detect_recolor.launches) != before:
            fail(f"{name}: the plain run launched a kernel")
        forced = obs.metrics.total_matching("kernels.fallback")
        torch_disp = sum(v for k, v in obs.metrics.counters_matching(
            "kernels.dispatch").items() if "backend=torch" in k)
        if device.type == "cuda" and (forced == 0 or forced != torch_disp):
            fail(f"{name}: plain run dispatched {torch_disp} plain calls for "
                 f"{forced} forced fallbacks")
        assert_same_result(res, plain, f"{name}: kernel path vs plain path")
        done.append(name)
    obs.metrics.reset()
    return done


# --------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# --------------------------------------------------------------------------

def time_ms(fn, device, reps: int, rounds: int = 5) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls,
    divided by ``reps``; the median of ``rounds`` such measurements, after a
    warm-up call.  (Host clock on the CPU rehearsal.)  Where the call's host
    side takes longer than its kernel, this is what a caller's loop pays per
    launch, not the kernel's own duration."""
    fn()
    sync(device)
    out = []
    for _ in range(rounds):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            out.append(a.elapsed_time(b) / reps)
        else:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t) * 1e3 / reps)
    return statistics.median(out)


def phase_times(device, kept, cmp: Cmp, launch: bool):
    """One chunk of each kept graph: kernel ms, plain ms, bound ms.

    Bound: the bytes the function must move over the card's memory rate.
    Inputs read once, outputs written once: the ELL rows of the rows that
    can work (all rows for firstfit), one 4-byte colour (and priority) per
    live slot of those rows but at most the whole vector once, the per-row
    flag and colour/priority entries, the forb0 words where given, and the
    outputs.  The integer work (a few operations per slot) is far below any
    operation peak of the card, so bytes bound both kernels.
    """
    from repro_torch import api
    from repro_torch.core import coloring
    from repro_torch.core.context import PassContext
    from repro_torch.kernels import ops, ref
    spec = api.ColoringSpec()
    kb = "cuda" if launch else "torch"
    rows = []
    for name, (g, res) in kept.items():
        prob = coloring.prepare(g, spec.seed, spec.n_chunks, spec.ell_cap,
                                spec.C, spec.relabel, device=device)
        C, n_pad = res.final_C, prob.n_pad
        cs = n_pad // spec.n_chunks
        W = prob.ell.shape[1]
        has_ovf = prob.ovf_src.shape[0] > 0
        ctx = PassContext.for_problem(prob, n_chunks=spec.n_chunks, C=C)
        # firstfit: chunk k of round 0, colours as the chunks before it left
        # them; detect_recolor: chunk k of repair round 1, where U is every
        # valid row (round 0 recoloured them all) — the widest repair round
        k = spec.n_chunks // 2
        lo, hi = k * cs, (k + 1) * cs
        valid = torch.arange(n_pad, device=device) < prob.n
        zeros = torch.zeros(n_pad, dtype=torch.bool, device=device)
        colors = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
        before_k = valid & (torch.arange(n_pad, device=device) < lo)
        coloring._chunked_pass(ctx, prob.ell, prob.ovf_src, prob.ovf_dst,
                               prob.pri, colors, zeros, before_k,
                               detect=False)
        ell_k = prob.ell[lo:hi]
        f0 = None
        if has_ovf:
            f0 = coloring._snapshot_coo(prob.ovf_src, prob.ovf_dst, colors,
                                        n_pad, C, "bitset")[lo:hi].contiguous()
        live = int((ell_k >= 0).sum())
        nW = -(-C // 32)
        reps = 20

        def bound(nbytes):
            return nbytes / HBM_BYTES_PER_S * 1e3

        ff_bytes = (cs * W * 4 + 4 * min(n_pad, live)
                    + (cs * nW * 4 if has_ovf else 0) + cs * 5)
        ff = lambda: ops.firstfit(ell_k, colors, C, backend=kb, forb0=f0)
        ff_plain = lambda: ref.firstfit_ref(ell_k, colors, C, forb0=f0)
        cmp.check("firstfit", f"{name} chunk R{cs} W{W} n{n_pad} C{C}",
                  ff(), ff_plain(), ("mex", "ovf"))
        rows.append({"kernel": "firstfit", "graph": name, "R": cs, "W": W,
                     "n": n_pad, "C": C, "live_slots": live,
                     "bytes": ff_bytes, "ms": time_ms(ff, device, reps),
                     "plain_ms": time_ms(ff_plain, device, 3, 3),
                     "bound_ms": bound(ff_bytes)})
        # state after a whole round 0
        colors = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
        coloring._chunked_pass(ctx, prob.ell, prob.ovf_src, prob.ovf_dst,
                               prob.pri, colors, zeros, valid, detect=False)
        U_k, valid_k, force_k = valid[lo:hi], valid[lo:hi], zeros[lo:hi]
        xd = None
        if has_ovf:
            f0 = coloring._snapshot_coo(prob.ovf_src, prob.ovf_dst, colors,
                                        n_pad, C, "bitset")[lo:hi].contiguous()
            xd = coloring._ovf_conflict(prob.ovf_src, prob.ovf_dst, colors,
                                        prob.pri, n_pad)[lo:hi]
        may = int((valid_k & (U_k | force_k)).sum())
        live_may = int(((ell_k >= 0) & (valid_k & (U_k | force_k))[:, None])
                       .sum())
        dr_bytes = (may * W * 4 + 2 * 4 * min(n_pad, live_may)
                    + cs * (8 + 3 + (1 if has_ovf else 0))
                    + (may * nW * 4 if has_ovf else 0) + cs * 6)
        kw = dict(forb0=f0, extra_defect=xd, force=force_k, valid=valid_k)
        dr = lambda: ops.detect_recolor(ell_k, colors, prob.pri, U_k, lo, C,
                                        backend=kb, **kw)
        dr_plain = lambda: ref.detect_recolor_ref(ell_k, colors, prob.pri, lo,
                                                  U_k, C, **kw)
        cmp.check("detect_recolor", f"{name} chunk R{cs} W{W} n{n_pad} C{C}",
                  dr(), dr_plain(), ("newc", "recolored", "ovf"))
        rows.append({"kernel": "detect_recolor", "graph": name, "R": cs,
                     "W": W, "n": n_pad, "C": C, "live_slots": live_may,
                     "bytes": dr_bytes, "ms": time_ms(dr, device, reps),
                     "plain_ms": time_ms(dr_plain, device, 3, 3),
                     "bound_ms": bound(dr_bytes)})
        for r in rows[-2:]:
            log("times", json.dumps(r))
        del prob, colors, ell_k, f0, xd
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=None,
                    help="log2 of the RMAT vertex count (default: see "
                         "RMAT_SCALE below)")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run of the control flow at toy sizes")
    args = ap.parse_args()

    # ---- phase 1: device ----
    if args.rehearse:
        device = torch.device("cpu")
        if args.rmat_scale is None:
            args.rmat_scale = 9
    else:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False: this script needs an "
                 "NVIDIA GPU (run with --rehearse for a CPU dry run)")
        device = torch.device("cuda")
        if args.rmat_scale is None:
            args.rmat_scale = RMAT_SCALE
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script "
             f"(src/repro_torch): {e}")
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log("device", json.dumps({
        "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "triton": triton_version,
        "python": sys.version.split()[0], "numpy": np.__version__}))
    launch = device.type == "cuda"
    if launch:
        log("nvcc", sh([_build.find_nvcc(), "--version"]).splitlines()[-2:])

    # the RMAT generators start now, in worker processes, and are collected
    # in phase 5; leaving the block terminates the workers whatever happens
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        rmats = start_rmats(pool, args.rmat_scale)
        # ---- phase 2: build ----
        if launch:
            _build.library()
            log("build", json.dumps({
                "library": os.path.relpath(_build.library_path(), HERE),
                "seconds": _build.build_seconds}))
            # ptxas -v: registers per kernel variant, and any spills
            regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                               _build.build_log)]
            spills = [l for l in _build.build_log.splitlines()
                      if "spill" in l and "0 bytes spill stores, 0 bytes spill "
                      "loads" not in l]
            if regs:
                log("build", f"{len(regs)} kernel variants, {min(regs)}-"
                    f"{max(regs)} registers, {len(spills)} with spills")

        # ---- phase 3: kernels vs plain versions ----
        cmp = phase_kernels(device, launch)
        log("kernels", json.dumps({k: len(v) for k, v in cmp.cases.items()}),
            "cases bit-equal to the plain versions")
        log("kernels", json.dumps({"shapes_checked": cmp.cases}))

        # ---- phase 4: golden ----
        n_golden = phase_golden(device)
        log("golden", f"{n_golden} (graph, seed) runs equal tests/torch_golden.json")

        # ---- phase 5: main path ----
        if args.rmat_scale != 24:
            log("main", f"RMAT scale {args.rmat_scale}: {RMAT_SCALE_WHY}")
        main_rows, kept, counts = phase_main(rmats, device, args.rehearse)
        log("main", json.dumps({"launches": counts}))

        # ---- phase 5b: plain versions on the card ----
        done = phase_plain(device, kept)
        log("plain", f"kernel path == plain path on the card for {done}")

        # ---- phase 6: kernel times ----
        time_rows = phase_times(device, kept, cmp, launch)
        if launch:
            torch.cuda.synchronize()

    if args.rehearse:
        log("rehearsal on the CPU finished; no kernel was built or launched")
        return 3

    # ---- result lines ----
    largest = [r for r in time_rows if r["graph"] == list(kept)[-1]]
    src = "src/repro_torch/kernels/csrc/coloring.cu"
    replaces = {"firstfit": "src/repro/kernels/firstfit.py:48",
                "detect_recolor": "src/repro/kernels/detect_recolor.py:54"}
    kernels = []
    for r in largest:
        kernels.append({
            "name": r["kernel"], "route": "cuda", "source": src,
            "replaces": replaces[r["kernel"]],
            "launches": counts[r["kernel"]],
            "max_abs_err": cmp.max_err[r["kernel"]],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": {k: r[k] for k in ("graph", "R", "W", "n", "C")},
            "cases_checked": len(cmp.cases[r["kernel"]])})
    print(json.dumps({"main_path": main_rows}), flush=True)
    print(json.dumps({"kernel_times": time_rows}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The paper's RMATs have 2^24 vertices and 128M edges.  Generation and
# prepare run on the host in numpy (one sort of 16 * 2^scale directed entries
# each for the generator, its shuffle and the relabel), and this script has a
# fixed time limit, so the scale is set here and the reason printed.  On one
# H100 host a 2^20 RMAT took 15-20 s to generate and 5-7 s per prepare; both
# grow a little faster than linearly.
RMAT_SCALE = 22
RMAT_SCALE_WHY = ("below the paper's 2^24: there the host-side numpy work "
                  "(generation, and one prepare per api.color call) alone "
                  "exceeds this script's time limit, and RMAT-B's ELL table "
                  "at ell_cap=512 (34 GB) plus the pass-start overflow "
                  "snapshot's transients would not fit one 80 GB card")


if __name__ == "__main__":
    sys.exit(main())
