#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), ``nvcc`` and
PyTorch built for CUDA.  Imports ``repro_torch`` only.  Phases, any failure
ends the run with a non-zero exit code:

  1. device   require CUDA; print the card's name and power limit and the
              torch / CUDA / nvcc / triton versions
  2. build    build the kernels from src/repro_torch/kernels/csrc; print
              ptxas -v of every variant of the attention kernel's sm90
              design (registers, spills) and its shared memory per CTA, of
              every variant of the staged pass (B1 / B2's vec16, B3's staged
              designs) with its shared memory and resident groups at the
              main path's widths, and a summary of B1's and B4's variants
              (count, registers, how many spill)
  3. kernels  each kernel against its plain PyTorch version on the card
              over shape sweeps: the coloring kernels bit-equal (integer
              arithmetic), attention and aggregation within stated
              tolerances (FA_TOL, SPMM_TOL; attention also row by row,
              ROW_TOL); attention at the tile edges of its sm90 design
              too, each call checked to have launched the design its dtype
              and head dim name (bfloat16 D 80 and 96 on sm90's tail
              panel, at its tile edges too, and D 12 on fma: qwen3-32b's
              and minicpm3-4b's heads; one shard of 5n's prefill: 16 / 2
              heads, D 80, L 4096, as views); B1, B2 and B3 at the tile edges of their
              staged designs (phase_kernels_staged); B4 at its edges (d
              1-300, W 1-44, max over non-finite features); B2's
              detect-only form on both designs and CAT's phase A route
              (phase_kernels_detect_only); B2's slot-stride form on both
              designs (phase_kernels_slots: S 1-32 slots, W 12-516, C
              4-256), each launch bit-equal to its plain version and to
              one launch a slot; B1 / B2 at phase 5i's shapes
              (phase_kernels_shards: a shard's chunk at row_start = d *
              n_loc + lo of a replicated table, the detect-only form over
              a shard's rows, B2 with row_ids into a table with a ghost
              tail)
  4. golden   paper_suite("tiny") x seeds 0-2 at distance 1 and 2 and with
              algorithm cat / gm / jp, and two bipartite graphs
              (mode="partial"), through repro_torch.api.color on the card
              against tests/torch_golden.json (made by the JAX reference
              package); the file's incremental streams (each tiny graph,
              10 batches of recolor_incremental) and its megabatched
              service run (8 tenants, 2 steps), entry for entry; its
              distributed sections (rsoc / cat on meshes of 1 and 4 shards
              x the tiny suite x seeds 0-2; mesh2d(24, 24)'s sharded
              streams); its lm_train section (the five LM smoke configs'
              — qwen3-1.7b, qwen3-32b, minicpm3-4b, phi3.5-moe,
              qwen2-moe — loss, gradients and three training steps) within
              LM_GOLDEN_TOL; its models section (the smoke nequip's and
              dcn-v2's forward, one leaf's gradient, nequip's through the
              forces, and three training steps) within MODELS_GOLDEN_TOL
  5. main     repro_torch.api.color(g), default spec, on the paper's graph
              classes at real size; launch counters zeroed before, read
              after, launches per design logged per graph (B1: vec16 on the
              RMATs, direct on the meshes); e2e_cold_ms from the first
              call, prepare_ms / solve_ms and their total e2e_traced_ms
              from a second, traced call
  5f. table1  on each graph of 5, while it is in memory: one traced
              api.color(g, algorithm=...) call each of CAT (every graph),
              GM (meshes, RMAT-ER) and JP (every graph), counts zeroed
              before each call and read after and checked exactly (CAT: B1
              n_chunks, B2 n_chunks a round, B2 detect-only 1 + rounds; GM:
              B1 n_chunks, detect-only 1; JP: nothing, no dispatch); after
              5c, the paper's Table 1: RSOC (5), CAT (5f), rsoc_compact (5c)
              solve_ms, rounds, gather passes, conflicts, colours
  5g. incr.   on RMAT-G and RMAT-B while they are in memory:
              api.color(g, mode="incremental", seed=1), then 10 batches of
              0.1 % of the undirected edges and one of 1 % (half random
              inserts, half deletes of current edges) through
              recolor_incremental, each traced (apply / repair ms), counts
              zeroed before and read after (B2 n_chunks a gather pass),
              proper on the card over ELL and overflow edges, gather passes
              held against 5's from-scratch run; the same stream from the
              same start state with kernel.fallback armed, field-equal at
              every batch
  5i. dist.   on each graph of 5 while it is in memory, on a mesh of
              DIST_D = 4 shards sharing the card: rsoc and cat with
              backend="distributed" on the meshes and RMAT-ER (proper;
              launches exact: RSOC B1 D x n_chunks, B2 D x n_chunks a
              round; CAT B1 D x n_chunks a phase A, B2 detect-only D a
              phase B; collectives = gather passes; the plain replay
              field-equal); the sharded incremental engine on RMAT-G with
              5g's batches (one shard field-equal to 5g's states, kept;
              four shards proper, the plain replay field-equal, halo bytes
              printed) and on mesh2d (halo bytes a round under n x 4);
              the phase's seconds logged
  5c. d2      api.color(g, distance=2) on the meshes and RMAT-ER,
              mode="partial" on a 2^20 x 2^20 Jacobian pattern,
              algorithm="rsoc_compact" on the meshes and RMAT-B; counters
              zeroed before, read after; properness by the host oracles (in
              worker processes) or, for RMAT-ER, on the card
  5b. plain   the problems of 5, CAT's of 5f (meshes, RMAT-ER) and the
              distance-2 and rsoc_compact meshes of 5c through the plain
              versions on the card (kernel.fallback fault site), results
              equal field by field; 5f's CAT / GM, 5c's rsoc_compact, 5b
              and 6 reuse the problems phase 5's traced call prepared
              (PreparedCache: the 2^22 RMATs' host prepare is not
              repeated; a reusing row says prepare_reused)
  5d. serve   ServeEngine on qwen3-1.7b at full width (random weights, seed
              0): 8 requests, prompts of 128-2048 tokens, 32 new tokens
              each; counters zeroed before, read after (one attention launch
              per layer per prefill, all on the sm90 design); the prompts'
              prefill logits against the plain attention on the card
              (kernel.fallback)
  5e. agg     ops.ell_aggregate on RMAT-ER's ELL table with d=100 features,
              float32 and bfloat16, sum / mean / max, against the plain
              version; counters zeroed before, read after
  5h. service two ColoringServices, megabatch=True and False, with 32
              tenants of erdos_renyi(65536, 8.0) (one slot class,
              bench_service.py's knobs), 4 steps of 4 batches (256
              inserts, 128 deletes) a tenant: bit-identical per tenant, no
              rollback, quarantine, degrade, escape or fallback; step p50 /
              p99 ms of both; B2's slot-stride launches against the looped
              path's (n_chunks a gather pass)
  5j. gnn     GNN training (no kernel of the port on this path; counts
              zeroed before, read after, logged): (a) GatedGCN at
              ogb_products' widths (16 layers, d 70) on rmat_er(16, 13),
              10 AdamW steps through train_loop.run checkpointing every 4,
              and a run stopped at 4 and restarted from LATEST: parameters
              and losses bit-equal, every loss finite, peak memory under
              GNN_MEM_LIMIT, ms a step with deterministic and with atomic
              scatters; (e) colored_segment_sum on (a)'s first-layer
              messages: bit-equal twice, within COLORED_TOL of the plain
              sum; (b) GAT and MeshGraphNet at cora's widths on
              erdos_renyi(2708, 3.9), 5 steps each; (c) the halo GatedGCN
              at full width on mesh2d(256, 256) at 4 shards sharing the
              card against the replicated one (loss, gradient norms,
              gathered bytes a layer); (d) tests/torch_golden.json's gnn
              section (the reference's loss histories, the halo ring's
              loss), and the card against the port's CPU run on
              rmat_er(12, 13)
  5k. lm      LM training on the card (no kernel of the port on this
              path, as the reference trains in jnp; counts zeroed before,
              read after, all 0): (a) qwen3-1.7b make_full() (28 layers,
              bfloat16, remat, chunks 1024) on TokenStream(2, 4096), 2
              microbatches, 6 steps of train_loop.run: losses and gradient
              norms finite, the last loss below the first, every leaf's
              step-1 gradient nonzero; ms a step, tokens/s, peak memory,
              a microbatch's and an update's device time split by
              torch.profiler (attention, cross entropy, optimizer, other
              matrix products, the rest);
              (b) flash_bwd True against False, one value_and_grad each
              (LM_FLASH_LOSS_RTOL, LM_FLASH_GRAD_REL), the peak memory each
              adds;
              (c) depth cut to 2, a restart from LATEST bit for bit, and
              ops.attention refusing inputs that require grad; (d)
              ServeEngine on qwen3-32b at full width cut to 8 layers, 4
              requests: exactly 8 x 4 attention launches, all on the sm90
              design (head dim 80), prefill logits against the plain
              attention within LOGITS_ATOL
  5l. models  dcn-v2 and nequip at full width (no kernel of the port on
              this path, as the reference computes both in jnp; counts
              zeroed before, read after, all 0): (a) dcn-v2 make_full()
              (26 tables of 1,000,000 x 16, 418,568,643 parameters)
              through launch.train.build_recsys, 6 AdamW steps of 65,536
              examples: ms a step, examples/s, peak memory, model FLOPs
              (launch.analysis) as a share of the float32 and bf16 peaks,
              one more step split into the host's batch, the forward and
              backward and the AdamW update (torch.profiler's kernel time
              in each, the card's idle share of a step);
              (c) predict at 512 and 262,144 examples, the candidate tower
              over 1,000,000 candidates and a top-100 retrieval (held to a
              host sort of the scores), 512 examples' logits against the
              card host's CPU within RECSYS_CPU_REL; (b) tables cut to
              65,536 rows, a restart from LATEST bit for bit; (d) nequip
              make_full() on 128 molecules of 30 atoms: the E(3) check
              within the reference test's tolerances, a double backward
              (energy_loss with forces) against the card host's CPU, 6
              AdamW steps and one split as in (a), segment_sum bit-equal
              to the sorted scatter;
              the phase's seconds logged
  5m. moe/mla MoE and MLA (ROADMAP A.5.4): (a) ServeEngine at full width
              on qwen2-moe-a2.7b (24 layers, 64 experts allocated for 60),
              minicpm3-4b (62 layers, MLA) and phi3.5-moe-42b-a6.6b (full
              width, depth cut from 32 to 8 layers: 83.5 GB of bfloat16
              weights do not fit), random weights from seed 0, each freed
              before the next: 4 requests of 128-1024 tokens, 8 new tokens;
              counts zeroed before, read after: exactly n_layers x 4 B5
              launches, all on sm90 (MoE, D 128; MLA, D 96); TTFT
              p50, decode ms a step, peak memory, parameter count;
              (b) every layer's attention of one prefill held to the plain
              version on its own q, k, v (FA_TOL, ROW_TOL); minicpm3-4b's
              prefill logits against the plain route within LOGITS_ATOL;
              the MoE configs' routing share and logits difference between
              the routes printed (a near-tied top-k may flip); layer 0's
              MoE of each MoE config in float32 on 512 tokens, the card
              against the card host's CPU (routing equal but for near-ties
              within MM_TIE, the output within MM_MOE_OUT_REL);
              (c) qwen2-moe-a2.7b and minicpm3-4b at full width cut to 2
              layers, 3 steps of 2 x 4096 tokens (memory reckoned before;
              ms a step, tokens/s, peak, model FLOPs as a share of the
              bf16 peak), qwen2-moe twice, the same bits in losses and
              parameters; no kernel launched; the phase's seconds against
              MM_BUDGET_S
  5n. sharded LM serving on a model mesh (launch/cells.py), the
              shards sharing the card, bf16, random weights from seed 0:
              (a) qwen3-32b at full width, 8 of 64 layers, (data 1, model
              4): a prefill cell of 1 x 4096 tokens (exactly 32 B5 launches,
              all sm90, 16 / 2 heads a shard at D 80) and the long_500k
              decode cell (B 1, S 524,288, write then attend, the cache
              sequence-sharded) for 8 steps from a seeded random cache, each
              within LOGITS_ATOL of the unsharded route on the same weights
              and cache; (b) phi3.5-moe, 8 of 32 layers, (data 2, model 2)
              with moe_ep: layer 0's MoE in float32 on 512 tokens sharded
              == unsharded (routing as integers, out within
              SH_MOE_OUT_TOL), a 2 x 2048 prefill cell (32 B5 launches,
              sm90) and a B 4 x 32,768 decode cell, logits and the share of
              shared routing choices printed; TTFT, decode ms a step, peak,
              per-shard bytes, collectives and gathered bytes, a profiled
              prefill split; counts zeroed before each sharded prefill
  5o. LM training on a model mesh (launch/cells.py's train cell), the
              shards sharing the card, random weights from seed 0, no
              kernel launched (counts zeroed before, read after, all 0):
              (a) qwen3-1.7b at full width, 28 layers, bf16, on (data 2,
              model 2) with fsdp_inner and act_shard: train_4k cut to 4 x
              4096 in 2 microbatches, two steps (the second under
              torch.profiler, device activity only), then the unsharded
              route (train_loop.make_train_step, the same OPT, weights and
              batch) after the cell is freed: step 1's loss within
              TM_LOSS_ATOL, grad_norm within TM_GNORM_REL; ms a step, peak,
              per-shard bytes of weights and moments, collectives and
              gathered bytes a step; (b) qwen2-moe-a2.7b, depth 2, (2, 2)
              with moe_ep, 2 x 2048: one step within TM_MOE_LOSS_ATOL /
              TM_MOE_GNORM_REL; (c) qwen3-1.7b, depth 2, float32, every
              knob and 2 microbatches: loss, grad_norm and every moment
              leaf within TM_F32_TOL of the unsharded route on the card;
              the phase's seconds against TM_BUDGET_S
  5p. MLA and the GNN / recsys cells on a model mesh (launch/cells.py),
              the shards sharing the card, random weights from seed 0:
              (a) minicpm3-4b at full width, all 62 layers, bf16, on (data
              1, model 4), the memory reckoned first: a prefill cell of 1 x
              4096 tokens (exactly 248 B5 launches, all sm90, 10 / 10 heads
              a shard at D 96; shard 0's first launch held to the plain
              attention on its own q, k, v) and the long_500k decode cell
              (write then attend, the latents sequence-sharded) for 8 steps
              from a seeded cache, the sharded cache freed before the
              unsharded route's is made: the prefill within LOGITS_ATOL of
              the unsharded route, the decode within MC_NOISE_FACTOR x the
              unsharded route's distance from itself under the other
              decode knob (the bf16 noise floor of 62 layers), and in
              float32 with the cache cut to 65,536 slots within
              MC_F32_LOGITS_ATOL; (b) its train cell, depth 2, on (2, 2) with
              fsdp_inner and act_shard, 2 x 2048, one step within
              TM_LOSS_ATOL / TM_GNORM_REL; (c) dcn-v2 uncut on (1, 4), the
              tables row-sharded: serve_p99, retrieval_cand at 1,000,000
              candidates (top 100 equal to a host sort) and one
              train_batch step of 65,536 against the unsharded route,
              per-shard table bytes; (d) gat-cora, meshgraphnet and
              gatedgcn on full_graph_sm and nequip on molecule at full
              width on (2, 2), edges split over the mesh, one step each
              against the unsharded route, and the halo gatedgcn on (1, 4)
              against the replicated loss; counts zeroed before each
              sharded step, read after (none but (a)'s prefill launches);
              the phase's seconds against MC_BUDGET_S
  5q. the dry run against the card, and the four examples (phase_dryrun)
  5r. train cells on a mesh whose positions sit on different devices
              (phase_train_devices): (1, 2) with one position on cuda:0
              and one on the host's cpu (TD_DEVICES), each cell against
              the same cell on a one-card (1, 2) mesh, two steps on copies
              of the same weights: (a) dcn-v2 at full width, 65,536 rows
              (half the tables and their moments on the host); (b) the
              smoke qwen3-1.7b (fsdp_inner, act_shard, remat, 2
              microbatches) and gatedgcn at full width (Cora) train cells;
              loss and grad_norm a step, every weight's update and moment
              after the last within TD_TOL, every replicated block's
              copies bit-equal after each step, each step's collectives
              and bytes past the one-card cell's equal to the all-reduces
              reckoned here from the specs; ms a step, the card's peak;
              (b)'s cells again under two planted faults (TD_FAULTS), each
              of which must trip the all-reduce count and the update or
              moment limit; (c) where the host has two cards, qwen3-1.7b
              at full width on (1, 2) over cuda:0 / cuda:1 against 5o
              (a)'s steps (one line where it has one); no kernel
              launched; the phase's seconds against TD_BUDGET_S
  (5, 5c: each row's prepare_ms + solve_ms must not pass e2e_traced_ms,
  the wall time of the call they split, by more than SPLIT_SLACK)
  6. times    per-kernel device time (device_ms; the back-to-back call time
              as call_ms) / plain-version time / bound (and, for the
              attention and aggregation kernels, the time of the one
              PyTorch call that computes the same function) at the shapes
              phases 5, 5c, 5d and 5e used — B1's vec16 chunks beside its
              direct design on the same inputs, in turns; B4's six (dtype,
              op) calls with embedding_bag, sparse.mm (sum, float32) and
              the gather floor; attention at L 512, 2048 and
              8192 in bfloat16 and at L 2048 in float32, each with its
              ratio to SDPA; attention at qwen3-32b's prefill (64 / 8
              heads, D 80, L 2048, bfloat16: the sm90 design) and at
              minicpm3-4b's (40 / 40 heads, D 96, L 2048, sm90) beside their
              bounds, SDPA and the fma kernel at the same shape (design id
              0, timed only); one shard's prefill of 5n (16 / 2 heads, D
              80, L 4096) and of 5p (10 / 10 heads, D 96, L 4096), the
              same way; one compacted repair pass per
              compacted path (detect_recolor with row_ids, forb0 and
              extra_defect on RMAT-B; twohop with row_ids on RMAT-ER),
              kernels against plain versions on the same inputs; B2's
              detect-only form at the full width CAT's detect pass
              launches it, beside the full B2 pass at that shape; B2's
              slot-stride form at 5h's chunk (phase_times_slots), beside
              one launch a tenant of the one-table form at the same rows

The last line of the standard output is the result object; the line before
it the card's name and power limit; before that one JSON object per kernel.

``--rehearse`` runs the same control flow on the CPU at toy sizes to find
wrong paths and shapes before a GPU run; it builds and launches no kernel,
prints no result object and exits with code 3.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time
import types

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


COLORING_KERNELS = ("firstfit", "detect_recolor", "twohop_detect_recolor")
KERNELS = COLORING_KERNELS + ("flash_attention", "ell_spmm")
# B2's detect-only form (CAT's and GM's detect pass): its comparisons are
# collected apart from the full pass's
DETECT_ONLY = "detect_recolor detect_only"
# B2's slot-stride form (the megabatched repair's pass): collected apart too
SLOT_STRIDE = "detect_recolor slot_stride"


class Cmp:
    """Kernel-vs-plain comparisons, collected per kernel: ``check`` for the
    integer kernels (bit-equal), ``close`` for the float ones (a stated
    tolerance, compared in float32)."""

    def __init__(self):
        self.max_err = {k: 0 for k in KERNELS + (DETECT_ONLY, SLOT_STRIDE)}
        self.max_row_err = {}
        self.cases = {k: [] for k in KERNELS + (DETECT_ONLY, SLOT_STRIDE)}

    def close(self, kernel, label, got, want, rtol, atol):
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{kernel} {label}: output is {got.dtype}{tuple(got.shape)}"
                 f", plain version gives {want.dtype}{tuple(want.shape)}")
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        err = float(diff.max())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        bad = int((~(diff <= atol + rtol * w.abs())).sum())
        if bad or not bool(torch.isfinite(g).all()):
            fail(f"{kernel} {label}: {bad} outputs differ from the plain "
                 f"version past rtol {rtol} / atol {atol} (max abs err "
                 f"{err}), or are not finite")
        self.cases[kernel].append(label)

    def rows(self, kernel, label, got, want, tol):
        """Per row (the last dimension), the RMS of the error over the RMS
        of the plain output, computed in float64: a check that scales with
        the row, where ``close``'s atol may be as large as a row's values
        (a late row of a long causal attention averages many keys)."""
        g, w = got.double(), want.double()
        rel = ((g - w).pow(2).mean(-1).sqrt()
               / w.pow(2).mean(-1).sqrt().clamp_min(1e-30))
        worst = float(rel.max())
        self.max_row_err[kernel] = max(self.max_row_err.get(kernel, 0.0),
                                       worst)
        if not worst <= tol:
            bad = int((~(rel <= tol)).sum())
            fail(f"{kernel} {label}: {bad} rows differ from the plain "
                 f"version past {tol} of their RMS (worst {worst})")

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
    phase_kernels_rows(device, launch, cmp)
    phase_kernels_shards(device, launch, cmp)
    phase_kernels_detect_only(device, launch, cmp)
    phase_kernels_slots(device, launch, cmp)
    phase_kernels_twohop(device, launch, cmp)
    phase_kernels_staged(device, launch, cmp)
    phase_kernels_attention(device, launch, cmp)
    phase_kernels_spmm(device, launch, cmp)
    return cmp


def phase_kernels_rows(device, launch: bool, cmp: Cmp):
    """``detect_recolor`` with ``row_ids`` (the compacted-frontier pass):
    rows of the full table, ids unsorted, clamped dead slots included."""
    from repro_torch.kernels import ops, ref
    kb = "cuda" if launch else "torch"
    names = ("newc", "recolored", "ovf")
    # (R, W, n, C)
    for R, W, n, C in [(256, 8, 1024, 32), (1000, 7, 3000, 33),
                       (77, 40, 500, 512), (333, 70, 2000, 1024)]:
        rng = np.random.default_rng(R + 7 * W)
        ell = dev(rand_ell(rng, n, W, n), device)
        colors = rng.integers(0, max(C // 2, 1), size=(n,)).astype(np.int32)
        colors[rng.integers(0, n, size=n // 10)] = -1
        colors = dev(colors, device)
        pri = dev(rng.permutation(n).astype(np.int32), device)
        ids = rng.permutation(n)[:R].astype(np.int32)
        ids[rng.random(R) < 0.1] = n + 5          # dead slots, clamped
        ids = dev(ids, device)
        U = dev(rng.random(R) < 0.7, device)
        opt = dict(forb0=rand_words(rng, R, C, device),
                   extra_defect=dev(rng.random(R) < 0.2, device),
                   force=dev(rng.random(R) < 0.2, device),
                   valid=dev(rng.random(R) < 0.8, device))
        for keys in ((), ("force",), tuple(opt)):
            kw = {k: opt[k] for k in keys}
            want = ref.detect_recolor_ref(ell, colors, pri, 0, U, C,
                                          row_ids=ids, **kw)
            got = ops.detect_recolor(ell, colors, pri, U, 0, C, backend=kb,
                                     row_ids=ids, **kw)
            cmp.check("detect_recolor",
                      f"R{R} W{W} n{n} C{C} +row_ids{'+' if keys else ''}"
                      f"{'+'.join(keys)}", got, want, names)


def phase_kernels_shards(device, launch: bool, cmp: Cmp):
    """B1 and B2 at the distributed engines' shapes (phase 5i), on both
    designs: a shard's chunk of rows at ``row_start = d * n_loc + lo`` of a
    replicated table longer than the rows, with the shard's validity (the
    replicated pass), and B2's detect-only form over a whole shard (CAT's
    detect); and B2 with ``row_ids`` into a shard's table with a ghost tail
    (the sharded compacted repair: ELL of the local rows only, ids into
    the whole table, live ids local rows, dead slots the table's length)."""
    from repro_torch.kernels import ops, ref
    kb = "cuda" if launch else "torch"
    names = ("newc", "recolored", "ovf")
    # replicated table: (D, n_loc, chunk rows, W, C)
    for D, n_loc, cs, W, C in [(4, 4096, 1024, 8, 32), (4, 4096, 1024, 44, 64),
                               (8, 2000, 500, 14, 32),
                               (4, 2048, 512, 516, 256)]:
        rng = np.random.default_rng(D * n_loc + W)
        n_pad = D * n_loc
        n = n_pad - 37                      # the last shard's tail is padding
        ell_all = rand_ell(rng, n_pad, W, n)
        ell_all[n:] = -1
        colors = rng.integers(0, max(C // 2, 1), size=(n_pad,)).astype(
            np.int32)
        colors[rng.integers(0, n_pad, size=n_pad // 10)] = -1
        colors[n:] = -1
        colors = dev(colors, device)
        pri = np.full((n_pad,), -1, np.int32)
        pri[:n] = rng.permutation(n)
        pri = dev(pri, device)
        for d in (1, D - 1):
            rs = d * n_loc + cs
            ell_k = dev(ell_all[rs:rs + cs], device)
            valid = dev(np.arange(rs, rs + cs) < n, device)
            U = dev(rng.random(cs) < 0.7, device)
            lab = f"shard D{D} d{d} R{cs} W{W} n{n_pad} C{C} rs{rs}"
            cmp.check("firstfit", lab, ops.firstfit(ell_k, colors, C,
                                                    backend=kb),
                      ref.firstfit_ref(ell_k, colors, C), ("mex", "ovf"))
            for kw in ({}, {"valid": valid}):
                cmp.check("detect_recolor", lab + ("+valid" if kw else ""),
                          ops.detect_recolor(ell_k, colors, pri, U, rs, C,
                                             backend=kb, **kw),
                          ref.detect_recolor_ref(ell_k, colors, pri, rs, U,
                                                 C, **kw), names)
            ell_d = dev(ell_all[d * n_loc:(d + 1) * n_loc], device)
            U = dev(rng.random(n_loc) < 0.5, device)
            cmp.check(DETECT_ONLY, f"shard D{D} d{d} R{n_loc} W{W} C{C}",
                      (ops.detect_recolor(ell_d, colors, pri, U, d * n_loc,
                                          C, backend=kb, detect_only=True),),
                      (ref.detect_recolor_ref(ell_d, colors, pri, d * n_loc,
                                              U, C, detect_only=True),),
                      ("recolored",))
    # a shard's table with a ghost tail: (n_loc, ghosts, W, C, frontier)
    for n_loc, G, W, C, R in [(4096, 1500, 12, 32, 512),
                              (4096, 1500, 48, 64, 512),
                              (2048, 700, 516, 256, 256)]:
        rng = np.random.default_rng(n_loc + G + W)
        n_tab = n_loc + G
        ell = dev(rand_ell(rng, n_loc, W, n_tab), device)
        colors = rng.integers(0, max(C // 2, 1), size=(n_tab,)).astype(
            np.int32)
        colors[rng.integers(0, n_tab, size=n_tab // 10)] = -1
        pri = dev(rng.permutation(n_tab).astype(np.int32), device)
        live = np.sort(rng.choice(n_loc, size=R * 3 // 4, replace=False))
        ids = np.full((R,), n_tab, np.int32)         # dead: off the table
        ids[:len(live)] = live
        valid = ids < n_tab
        force = valid & (colors[np.minimum(ids, n_tab - 1)] < 0)
        colors = dev(colors, device)
        ids, U, force = dev(ids, device), dev(valid, device), dev(force,
                                                                    device)
        opt = dict(force=force, forb0=rand_words(rng, R, C, device),
                   extra_defect=dev(rng.random(R) < 0.2, device) & U)
        for keys in ((), ("force",), tuple(opt)):
            kw = {k: opt[k] for k in keys}
            cmp.check("detect_recolor",
                      f"ghost tail n_loc{n_loc} G{G} R{R} W{W} C{C} "
                      f"+row_ids{'+' if keys else ''}{'+'.join(keys)}",
                      ops.detect_recolor(ell, colors, pri, U, 0, C,
                                         backend=kb, row_ids=ids, **kw),
                      ref.detect_recolor_ref(ell, colors, pri, 0, U, C,
                                             row_ids=ids, **kw), names)


def phase_kernels_detect_only(device, launch: bool, cmp: Cmp):
    """B2's detect-only form (CAT's and GM's detect pass) on both designs,
    bit-equal to its plain version and to the full pass's ``recolored``:
    rows of W 8 / 14 (``direct``) and 44 / 512 (``vec16``), C 32 / 64 /
    256, with and without ``extra_defect`` and ``valid``, a ragged R at an
    offset and one full-width R; each call counted once in
    ``launches_detect_<design>`` and never in ``launches``.  Then CAT's
    phase A after round 0 — ``detect_recolor`` with U all false and
    ``force`` the work mask — against first fit + ``apply_recolor`` on the
    card (both kernels), with the snapshot words."""
    from repro_torch.core import bitset
    from repro_torch.kernels import detect_recolor as dr_mod, ops, ref
    dr = dr_mod.detect_recolor
    kb = "cuda" if launch else "torch"
    n = 5000
    for W in (8, 14, 44, 512):
        route = dr_mod.design(W)
        for C in (32, 64, 256):
            rng = np.random.default_rng(W * C)
            table = dev(packed_ell(rng, n, W, n, rng.integers(0, W + 1,
                                                               size=n)),
                        device)
            colors = rng.integers(0, C // 2, size=n).astype(np.int32)
            colors[rng.integers(0, n, size=n // 10)] = -1
            colors = dev(colors, device)
            pri = dev(rng.permutation(n).astype(np.int32), device)
            for R, rs in ((1237, 1001), (n, 0)):
                ell = table[rs:rs + R]
                U = dev(rng.random(R) < 0.7, device)
                opt = dict(extra_defect=dev(rng.random(R) < 0.2, device),
                           valid=dev(rng.random(R) < 0.8, device))
                for keys in ((), ("extra_defect",), ("valid",), tuple(opt)):
                    kw = {k: opt[k] for k in keys}
                    before = (dr.launches, dr.launches_detect,
                              getattr(dr, f"launches_detect_{route}"))
                    got = ops.detect_recolor(ell, colors, pri, U, rs, C,
                                             backend=kb, detect_only=True,
                                             **kw)
                    after = (dr.launches, dr.launches_detect,
                             getattr(dr, f"launches_detect_{route}"))
                    if launch and after != (before[0], before[1] + 1,
                                            before[2] + 1):
                        fail(f"detect only W{W}: counts {before} -> {after}, "
                             f"expected one launch_detect on {route}")
                    want = ref.detect_recolor_ref(ell, colors, pri, rs, U, C,
                                                  detect_only=True, **kw)
                    label = (f"detect only R{R} rs{rs} W{W} ({route}) C{C} "
                             f"+{'+'.join(keys) or 'none'}")
                    cmp.check(DETECT_ONLY, label, [got], [want],
                              ("recolored",))
                    full = ref.detect_recolor_ref(ell, colors, pri, rs, U, C,
                                                  **kw)[1]
                    if not torch.equal(want, full):
                        fail(f"{label}: the plain detect-only flags differ "
                             f"from the full pass's recolored")
    # CAT's phase A route
    names = ("newc", "recolored", "ovf")
    for W in (8, 44, 512):
        for C in (4, 32, 256):
            rng = np.random.default_rng(W + C)
            R, rs = 1237, 1001
            table = dev(packed_ell(rng, n, W, n, rng.integers(0, W + 1,
                                                               size=n)),
                        device)
            colors = rng.integers(0, C if C == 4 else C // 2,
                                  size=n).astype(np.int32)
            if C > 4:
                colors[rng.integers(0, n, size=n // 10)] = -1
            colors = dev(colors, device)
            pri = dev(rng.permutation(n).astype(np.int32), device)
            ell = table[rs:rs + R]
            work = dev(rng.random(R) < 0.3, device)
            no_u = torch.zeros(R, dtype=torch.bool, device=device)
            f0 = rand_words(rng, R, C, device)
            got = ops.detect_recolor(ell, colors, pri, no_u, rs, C,
                                     backend=kb, forb0=f0, force=work)
            mex, full = ops.firstfit(ell, colors, C, backend=kb, forb0=f0)
            cmp.check("detect_recolor", f"phase A route R{R} W{W} C{C}",
                      got, bitset.apply_recolor(work, mex, full,
                                                colors[rs:rs + R]), names)
            cmp.check("detect_recolor", f"phase A route R{R} W{W} C{C} "
                      f"plain", got, ref.detect_recolor_ref(
                          ell, colors, pri, rs, no_u, C, forb0=f0,
                          force=work), names)
            if C == 4 and not bool(got[2].any()):
                fail(f"phase A route W{W} C4: no row overflowed")
    if launch:
        torch.cuda.synchronize()


SLOT_S = (1, 2, 5, 32)            # slots a launch of B2's slot-stride form
SLOT_W = (12, 16, 44, 516)        # 516: RMAT-B's 512 + the 4 slack slots
SLOT_C = (4, 32, 256)


def slot_case(rng, S, W, C, n_pad, device):
    """Stacked tables of S slots (n_pad rows each; ELL ids local, a few
    past the slot to test the clamp) and one launch's rows: every slot but
    the last takes part with a ragged live count (slot 0 none: an empty
    frontier), the last is frozen (no rows).  Returns (tables, per-slot
    (slot, ids, flags), the launch's flat inputs)."""
    from repro_torch.core import bitset
    ell = packed_ell(rng, S * n_pad, W, n_pad,
                     rng.integers(0, W + 1, size=S * n_pad))
    ell[(rng.random(ell.shape) < 0.01) & (ell >= 0)] = n_pad + 7
    top = C if C == 4 else max(C // 2, 1)
    colors = rng.integers(0, top, size=S * n_pad).astype(np.int32)
    if C > 4:
        colors[rng.random(S * n_pad) < 0.1] = -1
    pri = np.concatenate([rng.permutation(n_pad) for _ in range(S)]).astype(
        np.int32)
    tables = [dev(a, device) for a in (ell, colors, pri)]
    cs = 64
    parts = []
    for s in range(max(S - 1, 1)):
        m = 0 if (s == 0 and S > 2) else int(rng.integers(1, cs + 1))
        ids = np.full(cs, n_pad, np.int64)                # dead: clamped
        ids[:m] = rng.permutation(n_pad)[:m]
        live = np.arange(cs) < m
        flags = {"U": live & (rng.random(cs) < 0.8),
                 "force": live & (rng.random(cs) < 0.2),
                 "extra_defect": rng.random(cs) < 0.2}
        parts.append((s, ids, live, flags))
    dense = (rng.random((len(parts) * cs, C)) < 0.2).astype(np.uint8)
    forb0 = bitset.pack_dense(dev(dense, device), C).contiguous()
    return tables, parts, forb0, cs


def phase_kernels_slots(device, launch: bool, cmp: Cmp):
    """B2's slot-stride form (the megabatched repair's pass) on both
    designs: S in ``SLOT_S``, W in ``SLOT_W``, C in ``SLOT_C``, ragged live
    counts per slot, an empty frontier and a frozen slot; each launch
    bit-equal to its plain version AND to one launch a slot of the
    one-table form over that slot's own tables, and counted once in
    ``launches_slots_<design>`` (never in ``launches``)."""
    from repro_torch.kernels import detect_recolor as dr_mod, ops
    dr = dr_mod.detect_recolor
    kb = "cuda" if launch else "torch"
    names = ("newc", "recolored", "ovf")
    n_pad = 512
    for S in SLOT_S:
        for W in SLOT_W:
            route = dr_mod.design(W)
            for C in SLOT_C:
                rng = np.random.default_rng(S * 1000 + W * 10 + C)
                (ell, colors, pri), parts, forb0, cs = slot_case(
                    rng, S, W, C, n_pad, device)
                rows = np.concatenate([
                    s * n_pad + np.minimum(ids, n_pad - 1)
                    for s, ids, _, _ in parts]).astype(np.int32)
                flat = {k: dev(np.concatenate([f[k] for *_, f in parts]),
                               device) for k in parts[0][3]}
                valid = dev(np.concatenate([lv for _, _, lv, _ in parts]),
                            device)
                kw = dict(forb0=forb0, extra_defect=flat["extra_defect"],
                          force=flat["force"], valid=valid)
                before = (dr.launches, dr.launches_slots,
                          getattr(dr, f"launches_slots_{route}"))
                got = ops.detect_recolor(ell, colors, pri, flat["U"], 0, C,
                                         backend=kb, row_ids=dev(rows,
                                                                 device),
                                         slot_rows=n_pad, **kw)
                after = (dr.launches, dr.launches_slots,
                         getattr(dr, f"launches_slots_{route}"))
                if launch and after != (before[0], before[1] + 1,
                                        before[2] + 1):
                    fail(f"slot stride S{S} W{W}: counts {before} -> "
                         f"{after}, expected one launch_slots on {route}")
                label = f"slot stride S{S} W{W} ({route}) C{C}"
                want = ops.detect_recolor(ell, colors, pri, flat["U"], 0, C,
                                          backend="torch",
                                          row_ids=dev(rows, device),
                                          slot_rows=n_pad, **kw)
                cmp.check(SLOT_STRIDE, label, got, want, names)
                # one launch a slot, today's form, on the slot's own tables
                each = [[], [], []]
                for j, (s, ids, live, f) in enumerate(parts):
                    lo, hi = s * n_pad, (s + 1) * n_pad
                    one = ops.detect_recolor(
                        ell[lo:hi], colors[lo:hi], pri[lo:hi],
                        dev(f["U"], device), 0, C, backend=kb,
                        forb0=forb0[j * cs:(j + 1) * cs],
                        extra_defect=dev(f["extra_defect"], device),
                        force=dev(f["force"], device), valid=dev(live, device),
                        row_ids=dev(np.minimum(ids, n_pad - 1).astype(
                            np.int32), device))
                    for acc, o in zip(each, one):
                        acc.append(o)
                cmp.check(SLOT_STRIDE, label + " == per-slot launches", got,
                          [torch.cat(a) for a in each], names)
                if C == 4 and not bool(got[2].any()):
                    fail(f"{label}: no row overflowed at C=4")
    if launch:
        torch.cuda.synchronize()


def twohop_case(rng, R, W, n, C, device, n_all=None, top=None, fill=0.3):
    """Random inputs of one two-hop case: (ell_all, colors, pri, U)."""
    n_all = n if n_all is None else n_all
    ell_all = dev(rand_ell(rng, n_all, W, n_all, fill), device)
    top = max(C // 2, 1) if top is None else top
    colors = rng.integers(0, top, size=(n,)).astype(np.int32)
    colors[rng.integers(0, n, size=n // 10)] = -1
    return (ell_all, dev(colors, device),
            dev(rng.permutation(n).astype(np.int32), device),
            dev(rng.random(R) < 0.7, device))


def phase_kernels_twohop(device, launch: bool, cmp: Cmp):
    """``twohop_detect_recolor`` against ``twohop_ref`` on the card."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.firstfit import LANES, WINDOWS
    from repro_torch.kernels.twohop import twohop_detect_recolor
    kb = "cuda" if launch else "torch"
    names = ("newc", "recolored", "ovf")
    K = "twohop_detect_recolor"

    def both(label, ell_rows, ell_all, colors, pri, U, row_start, C, **kw):
        want = ref.twohop_ref(ell_rows, ell_all, colors, pri, row_start, U,
                              C, **{k: v for k, v in kw.items()
                                    if k != "page_rows"})
        got = ops.twohop(ell_rows, ell_all, colors, pri, U, row_start, C,
                         backend=kb, **kw)
        cmp.check(K, label, got, want, names)
        return got

    # (R, W, n, C, row_start): the reference's test shapes, then caps
    # 32 / 33 / 512 / 1024 (the last two past one register window); the
    # 1024 case draws colours so that many rows need the second window
    shapes = [(128, 4, 512, 32, 0, None), (128, 8, 512, 64, 128, None),
              (256, 2, 1024, 32, 256, None), (128, 6, 128, 32, 0, None),
              (333, 20, 2000, 32, 1, None), (333, 20, 2000, 33, 1, None),
              (200, 30, 3000, 512, 7, None), (64, 64, 4096, 1024, 100, 560),
              (1, 1, 1, 1, 0, None)]
    for R, W, n, C, rs, top in shapes:
        rng = np.random.default_rng(R * W + C)
        ell_all, colors, pri, U = twohop_case(rng, R, W, n, C, device,
                                              top=top)
        lab = f"R{R} W{W} n{n} C{C} rs{rs}"
        both(lab, ell_all[rs:rs + R], ell_all, colors, pri, U, rs, C)
        # the optional inputs, alone and together
        force = dev(rng.random(R) < 0.2, device)
        valid = dev(rng.random(R) < 0.8, device)
        ids = rng.permutation(n)[:R].astype(np.int32)
        ids[rng.random(R) < 0.1] = n + 3          # dead slots, clamped
        ids = dev(ids, device)
        for kw in (dict(force=force), dict(valid=valid),
                   dict(detect=False), dict(row_ids=ids),
                   dict(force=force, valid=valid, row_ids=ids),
                   dict(force=force, valid=valid, row_ids=ids,
                        detect=False)):
            rows = None if "row_ids" in kw else ell_all[rs:rs + R]
            both(f"{lab} +{'+'.join(kw)}", rows, ell_all, colors, pri, U,
                 rs, C, **kw)
    # colours shorter than the table (n < n_all): gathers clamp to n
    rng = np.random.default_rng(3)
    ell_all, colors, pri, U = twohop_case(rng, 100, 9, 700, 64, device,
                                          n_all=900)
    both("R100 W9 n700 n_all900 C64", ell_all[50:150], ell_all, colors, pri,
         U, 50, 64)
    # ragged page_rows: accepted, and the result does not depend on it
    rng = np.random.default_rng(1000)
    ell_all, colors, pri, U = twohop_case(rng, 128, 8, 1000, 32, device)
    for page_rows, rs in ((96, 0), (100, 128), (256, 256), (1, 5)):
        both(f"R128 W8 n1000 C32 rs{rs} page_rows{page_rows}",
             ell_all[rs:rs + 128], ell_all, colors, pri, U, rs, 32,
             page_rows=page_rows)
    # the saturation case of the reference's tests: ovf must fire
    rng = np.random.default_rng(33)
    n, W, R, C = 512, 16, 256, 4
    ell_all = dev(rand_ell(rng, n, W, n, 0.05), device)
    colors = dev(rng.integers(0, C, size=(n,)).astype(np.int32), device)
    pri = dev(rng.permutation(n).astype(np.int32), device)
    U = torch.ones(R, dtype=torch.bool, device=device)
    got = both("saturation C4", ell_all[:R], ell_all, colors, pri, U, 0, C)
    if not bool(got[2].any()):
        fail("twohop saturation case (C=4) did not raise the overflow flag")
    # every compiled (lanes, window) pair computes the same function
    if launch:
        rng = np.random.default_rng(6)
        R, W, n, C = 300, 45, 3000, 700
        ell_all, colors, pri, U = twohop_case(rng, R, W, n, C, device,
                                              top=300)
        ids = dev(rng.permutation(n)[:R].astype(np.int32), device)
        force = dev(rng.random(R) < 0.2, device)
        want = ref.twohop_ref(None, ell_all, colors, pri, 0, U, C,
                              row_ids=ids, force=force)
        for lanes in LANES:
            for window in WINDOWS:
                cmp.check(K, f"R{R} W{W} n{n} C{C} lanes{lanes} "
                          f"window{window}",
                          twohop_detect_recolor(
                              None, ell_all, colors, pri, U, 0, C,
                              row_ids=ids, force=force, lanes=lanes,
                              window=window), want, names)
        torch.cuda.synchronize()


def packed_ell(rng, R, W, n, deg):
    """(R, W) left-packed rows (as graphs/csr.py writes them): row r has
    deg[r] live ids, then FILL."""
    ell = rng.integers(0, n, size=(R, W)).astype(np.int32)
    ell[np.arange(W)[None, :] >= np.asarray(deg)[:, None]] = -1
    return ell


def resident_groups(kernel: str, W: int, launch: bool):
    """The groups the staged pass keeps resident for this call's shape on
    this card (its persistent grid); 64 on the CPU rehearsal; None where
    the wrapper picks the direct design (no persistent grid)."""
    from repro_torch.kernels import _build, detect_recolor as dr, twohop
    from repro_torch.kernels.firstfit import pick_lanes
    if kernel in ("firstfit", "detect_recolor"):
        lanes, route = dr.default_lanes(W), dr.design(W)
    elif not launch:            # the rehearsal has no library to ask
        lanes, route = pick_lanes(W), ("direct" if W <= twohop.DIRECT_MAX_W
                                       else "staged16")
    else:
        lanes = pick_lanes(W)
        route = twohop.design(W, twohop.staged_fits(lanes, W))
    if route == "direct":
        return None
    if not launch:
        return 64
    lib = _build.library()
    if kernel in ("firstfit", "detect_recolor"):
        shape = staged_shape(lib, 1, dr.DESIGNS.index(route), lanes, W)
    else:
        shape = staged_shape(lib, 2, twohop.DESIGNS.index(route), lanes, W)
    if shape is None:
        fail(f"{kernel}: no staged launch shape at W={W}, lanes={lanes}")
    return int(shape[2])


def phase_kernels_staged(device, launch: bool, cmp: Cmp):
    """The tile edges of the designs of ``firstfit`` (B1),
    ``detect_recolor`` (B2) and ``twohop_detect_recolor`` (B3), bit-equal
    to the plain versions (B1: every row works, R > n, caps 4 / 33 / 700):
    R at the staged designs' resident groups T - 1, T, T + 1 (a group's rows
    wrap the two-buffer ring); W in {1, 3, 4} (the direct designs), 17
    and 20 (the narrowest staged rows), 44, 45, 512 (W*4 % 16 != 0 takes
    B3's 4-B copies and B2's direct design) and, for B2 at 8 lanes, W
    252 / 256 / 260 around the stage slice's 256 ints (rows staged in one
    and in two batches); B3 rows with one fewer, as many
    and one more live neighbours than a stage batch holds; rows whose first
    window is full (C above one window); scattered ``row_ids``; ``forb0`` /
    ``extra_defect`` on and off."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.firstfit import pick_lanes
    kb = "cuda" if launch else "torch"
    names = ("newc", "recolored", "ovf")
    K1, K2, K3 = "firstfit", "detect_recolor", "twohop_detect_recolor"
    # ---- B1: as B2's tile edges, every row working, more rows than
    # colours (R > n), caps 4 (saturated rows), 33 and 700 ----
    for W in (1, 4, 16, 17, 20, 44, 45, 252, 256, 260, 512):
        T = resident_groups(K1, W, launch)
        Rs = ((257,) if T is None else
              (T - 1, T, T + 1) if W in (20, 44, 512) else (T + 1,))
        for R in Rs:
            rng = np.random.default_rng(3 * R + W)
            for C in ((4, 33, 700) if W in (44, 512) else (33,)):
                n = max(2 * W, R // 3)
                ell_np = packed_ell(rng, R, W, n, rng.integers(0, W + 1,
                                                                size=R))
                colors = rng.integers(0, 4 if C == 4 else min(C + 8, 560),
                                      size=n).astype(np.int32)
                if C > 4:
                    colors[rng.integers(0, n, size=n // 10)] = -1
                if W >= 512 and C > 512:
                    # rows 0-4 see colours 0..511 once each: a full first
                    # window
                    colors[:512] = np.arange(512)
                    ell_np[:5] = np.stack([rng.permutation(512) for _
                                           in range(5)]).astype(np.int32)
                ell, colors = dev(ell_np, device), dev(colors, device)
                f0 = rand_words(rng, R, C, device)
                for kw in ({}, dict(forb0=f0)):
                    want = ref.firstfit_ref(ell, colors, C, **kw)
                    got = ops.firstfit(ell, colors, C, backend=kb, **kw)
                    cmp.check(K1, f"staged edge R{R} (T{T}) W{W} n{n} C{C} "
                              f"+{'+'.join(kw) or 'none'}", got, want,
                              ("mex", "ovf"))
                    if C == 4 and launch and not bool(got[1].any()):
                        fail(f"{K1} staged edge W{W} C4: no row overflowed")
    # ---- B2 ----
    for W in (1, 3, 4, 17, 20, 44, 45, 252, 256, 260, 512):
        T = resident_groups(K2, W, launch)
        C = 700 if W >= 44 else 33
        n = max(4096, 2 * W, (T or 0) + 2)     # the tile's rows lie in [0, n)
        Rs = ((257,) if T is None else
              (T - 1, T, T + 1) if W in (20, 44, 512) else (T + 1,))
        for R in Rs:
            rng = np.random.default_rng(R + W)
            deg = rng.integers(0, W + 1, size=R)
            ell_np = packed_ell(rng, R, W, n, deg)
            colors = rng.integers(0, 560 if C > 512 else C - 1,
                                  size=n).astype(np.int32)
            colors[rng.integers(0, n, size=n // 10)] = -1
            if W >= 512:
                # rows 0-4 see colours 0..511 once each: a full first window
                colors[:512] = np.arange(512)
                ell_np[:5] = np.stack([rng.permutation(512)
                                       for _ in range(5)]).astype(np.int32)
            ell, colors = dev(ell_np, device), dev(colors, device)
            full = dev(packed_ell(rng, n, W, n, rng.integers(0, W + 1,
                                                             size=n)), device)
            pri = dev(rng.permutation(n).astype(np.int32), device)
            U = dev(rng.random(R) < 0.7, device)
            opt = dict(forb0=rand_words(rng, R, C, device),
                       extra_defect=dev(rng.random(R) < 0.2, device),
                       force=dev(rng.random(R) < 0.2, device),
                       valid=dev(rng.random(R) < 0.8, device))
            ids = rng.permutation(n)[:R] if R <= n else rng.integers(0, n, R)
            ids = ids.astype(np.int32)
            ids[rng.random(R) < 0.1] = n + 5          # dead slots, clamped
            ids = dev(ids, device)
            for keys, rows in (((), False), (("forb0", "extra_defect"), False),
                               (tuple(opt), False), ((), True),
                               (tuple(opt), True)):
                kw = {k: opt[k] for k in keys}
                e = full if rows else ell
                if rows:
                    kw["row_ids"] = ids
                want = ref.detect_recolor_ref(e, colors, pri, 0, U, C, **kw)
                got = ops.detect_recolor(e, colors, pri, U, 0, C, backend=kb,
                                         **kw)
                cmp.check(K2, f"staged edge R{R} (T{T}) W{W} C{C} "
                          f"+{'+'.join(kw) or 'none'}", got, want, names)
    # ---- B3 ----
    for W in (1, 3, 4, 17, 20, 44, 45, 512):
        lanes = pick_lanes(W)
        T = resident_groups(K3, W, launch)
        batch = max(1, 32 * lanes // W)        # neighbour rows a stage batch
        n = max(4096, 4 * W)
        Rs = ((257,) if T is None else
              (T - 1, T, T + 1) if W in (17, 44, 45) else (T + 1,))
        if W == 512:
            Rs = (33,)                         # the plain panels are W*W wide
        C = 700 if W >= 44 else 33
        for R in Rs:
            rng = np.random.default_rng(7 * R + W)
            deg = rng.integers(0, W + 1, size=n)
            # rows W..W+5: around a stage batch's neighbour count
            deg[W:W + 6] = np.clip([batch - 1, batch, batch + 1, W, 0, 1], 0,
                                   W)
            ell_all = packed_ell(rng, n, W, n, deg)
            colors = rng.integers(0, 560 if C > 512 else C - 1,
                                  size=n).astype(np.int32)
            colors[rng.integers(0, n, size=n // 10)] = -1
            if W in (44, 45):
                # row 0's two hops cover colours 0..511: a full first window
                colors[:W * W] = np.arange(W * W) % 512
                ell_all[:W] = (np.arange(W)[:, None] * W
                               + np.arange(W)[None, :]).astype(np.int32)
            ell_all, colors = dev(ell_all, device), dev(colors, device)
            pri = dev(rng.permutation(n).astype(np.int32), device)
            U = dev(rng.random(R) < 0.7, device)
            force = dev(rng.random(R) < 0.2, device)
            valid = dev(rng.random(R) < 0.8, device)
            ids = rng.integers(0, n, size=R).astype(np.int32)
            ids[rng.random(R) < 0.1] = n + 3          # dead slots, clamped
            ids[:7] = np.r_[0, np.arange(W, W + 6)]
            ids = dev(ids, device)
            rows = ell_all[:R] if R <= n else None
            for kw in (dict(), dict(force=force, valid=valid),
                       dict(detect=False), dict(row_ids=ids),
                       dict(row_ids=ids, force=force, valid=valid,
                            detect=False)):
                if rows is None and "row_ids" not in kw:
                    continue
                r = None if "row_ids" in kw else rows
                want = ref.twohop_ref(r, ell_all, colors, pri, 0, U, C, **kw)
                got = ops.twohop(r, ell_all, colors, pri, U, 0, C,
                                 backend=kb, **kw)
                cmp.check(K3, f"staged edge R{R} (T{T}) W{W} C{C} batch "
                          f"{batch} +{'+'.join(kw) or 'none'}", got, want,
                          names)


# Tolerances of the float kernels against their plain versions on the card.
# float32: tests/test_kernels.py's (the same float32 arithmetic summed in
# another order).  bfloat16 attention: the kernel rounds p to bfloat16 before
# P.V, as the TPU kernel does, where the plain version keeps float32, and
# both round the output once — one bfloat16 step (2^-8 relative, 0.0156 at
# |out| in [2, 4)) plus p's rounding (at most 2^-9 of max |v|).  bfloat16
# aggregation: tests/test_kernels.py's.
FA_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2e-2)}
# Beside FA_TOL, attention row by row (Cmp.rows: RMS of the error over the
# RMS of the plain row).  bfloat16: below one bfloat16 step of every element
# (2^-7 relative) even if each rounded the other way, where a wrong or stale
# key tile moves a row by its share of the keys; float32: the same float32
# arithmetic in another order (about 1e-6).
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SPMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-1)}


def randn(rng, shape, dtype, device):
    return dev(rng.standard_normal(shape).astype(np.float32), device).to(dtype)


def phase_kernels_attention(device, launch: bool, cmp: Cmp):
    """``flash_attention`` against ``flash_attention_ref`` on the card: the
    reference's test shapes, qwen3-1.7b's heads at ragged lengths, Lk > Lq,
    the head dims of the smoke configs; the tile edges of the sm90 design
    (128-row query tiles, 128-key tiles: L = 1, 63-65, 127-129,
    255, 257, 2049, and Lk > Lq with a ragged offset at GQA ratios 1, 2 and
    8, B = 2); causal and not, float32 and bfloat16; a few in the serving
    prefill's layout (views of (B, L, H, D) tensors, no copy); qwen3-32b's
    heads (64 / 8) at head dim 80, ragged and with Lk > Lq; minicpm3-4b's
    MLA heads (40 / 40) at head dim 96 and 12, ragged and with Lk > Lq; the
    sm90 design's tile edges at D 80 and 96 (its tail panel: L = 63-65,
    127-129, 255, 257, 2049, Lk > Lq ragged at GQA ratios 1 and 8, B = 2,
    views).  Each case
    is held to ``FA_TOL`` and, row by row, to ``ROW_TOL``, and checks that
    the launch went to the design ``design(dtype, D)`` names."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import design
    kb = "cuda" if launch else "torch"
    # (B, Hq, Hkv, Lq, Lk, D)
    shapes = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 256, 64),
              (1, 2, 1, 256, 256, 128)]
    shapes += [(1, 16, 8, L, L, 128) for L in (1, 17, 300, 1000)]
    shapes += [(1, 16, 8, 300, 1000, 128), (2, 4, 2, 33, 70, 16),
               (3, 4, 4, 65, 65, 32)]
    shapes += [(1, 16, 8, L, L, 128)
               for L in (63, 64, 65, 127, 128, 129, 255, 257, 2049)]
    shapes += [(2, 8, 8, 129, 257, 64), (2, 8, 4, 65, 300, 128),
               (2, 16, 2, 255, 383, 64), (2, 8, 1, 257, 257, 128),
               (2, 16, 2, 63, 191, 128)]
    # qwen3-32b's heads (64 / 8) at head dim 80 (bfloat16: the sm90
    # design's tail panel of 16 columns): ragged lengths, Lk > Lq
    shapes += [(1, 64, 8, L, L, 80) for L in (1, 63, 65, 300)]
    shapes += [(1, 64, 8, 129, 257, 80), (2, 64, 8, 33, 700, 80)]
    # minicpm3-4b's MLA heads (40 / 40) at head dim 96 (64 + 32; bfloat16:
    # sm90, a tail of 32 columns) and its smoke config's 12 (8 + 4,
    # zero-padded to 16 by the wrapper, fma)
    shapes += [(1, 40, 40, L, L, 96) for L in (1, 63, 65, 300)]
    shapes += [(1, 40, 40, 129, 257, 96), (2, 40, 40, 33, 70, 12)]
    # the sm90 design's tile edges at D 80 and 96: 128-row query tiles,
    # 128-key tiles, Lk > Lq with a ragged offset at GQA ratios 1 and 8
    shapes += [(1, 16, 2, L, L, D) for D in (80, 96)
               for L in (64, 127, 128, 129, 255, 257, 2049)]
    shapes += [(2, 16, 2, 129, 257, 80), (2, 8, 8, 255, 383, 80),
               (2, 8, 1, 65, 300, 96), (2, 8, 8, 63, 191, 96),
               (2, 16, 2, 257, 257, 96)]
    # one shard's prefill attention in phase 5n: qwen3-32b's 64 / 8 heads
    # over model 4 leave 16 / 2 a shard, at D 80 and 4096 tokens, read as
    # views of the shard's (B, L, H, D) projections
    shapes += [(1, 16, 2, 4096, 4096, 80)]
    views = {(1, 16, 8, 300, 300, 128), (2, 8, 4, 65, 300, 128),
             (1, 16, 2, 4096, 4096, 80),
             (2, 16, 2, 255, 383, 64), (1, 64, 8, 300, 300, 80),
             (2, 16, 2, 129, 257, 80), (2, 8, 1, 65, 300, 96),
             (1, 40, 40, 300, 300, 96)}

    def make(rng, shape, dtype, view):
        if not view:
            return randn(rng, shape, dtype, device)
        B, H, L, D = shape      # the prefill's layout: (B, L, H, D) memory
        return randn(rng, (B, L, H, D), dtype, device).transpose(1, 2)

    for B, Hq, Hkv, Lq, Lk, D in shapes:
        for view in (False, True) if (B, Hq, Hkv, Lq, Lk, D) in views \
                else (False,):
            rng = np.random.default_rng(Lq * 31 + Lk + D)
            for dtype in (torch.float32, torch.bfloat16):
                q = make(rng, (B, Hq, Lq, D), dtype, view)
                k = make(rng, (B, Hkv, Lk, D), dtype, view)
                v = make(rng, (B, Hkv, Lk, D), dtype, view)
                route = design(dtype, D)
                for causal in (True, False):
                    want = ref.flash_attention_ref(q, k, v, causal=causal)
                    before = attention_designs()
                    got = ops.attention(q, k, v, causal=causal, backend=kb)
                    after = attention_designs()
                    if launch and after[route] != before[route] + 1:
                        fail(f"flash_attention: a {dtype} D={D} call did "
                             f"not launch the {route} design ({before} -> "
                             f"{after})")
                    label = (f"B{B} Hq{Hq} Hkv{Hkv} Lq{Lq} Lk{Lk} D{D} "
                             f"{str(dtype)[6:]} causal={causal} {route}"
                             + (" view" if view else ""))
                    cmp.close("flash_attention", label, got, want,
                              *FA_TOL[dtype])
                    cmp.rows("flash_attention", label, got, want,
                             ROW_TOL[dtype])
    if launch:
        torch.cuda.synchronize()


def phase_kernels_spmm(device, launch: bool, cmp: Cmp):
    """``ell_spmm`` against ``ell_spmm_ref`` on the card: the reference's
    test shapes, all-FILL rows, ids >= n (clamped), ragged R and d, the
    kernel's edges (d 1-300, W 1-44, max over non-finite features), every
    compiled lane count; float32 and bfloat16, all three ops."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ell_spmm import LANES, ell_spmm
    kb = "cuda" if launch else "torch"
    # (R, W, n, d): the reference's shapes, then ragged ones
    shapes = [(128, 8, 256, 128), (256, 16, 1024, 256), (128, 4, 512, 128),
              (1000, 7, 300, 100), (77, 40, 50, 3), (5, 1, 5, 1),
              (333, 44, 4096, 100), (64, 3, 100, 1030)]
    for R, W, n, d in shapes:
        rng = np.random.default_rng(R * W + d)
        ell = rand_ell(rng, R, W, n + 5)     # ids up to n + 4: clamped
        ell[::7] = -1                        # all-FILL rows
        ell = dev(ell, device)
        for dtype in (torch.float32, torch.bfloat16):
            feats = randn(rng, (n, d), dtype, device)
            for op in ("sum", "mean", "max"):
                got = ops.ell_aggregate(ell, feats, op, backend=kb)
                cmp.close("ell_spmm", f"R{R} W{W} n{n} d{d} "
                          f"{str(dtype)[6:]} {op}", got,
                          ref.ell_spmm_ref(ell, feats, op), *SPMM_TOL[dtype])
                if bool((got[::7] != 0).any()):
                    fail(f"ell_spmm R{R} W{W} n{n} d{d} {op}: an all-FILL "
                         f"row is not 0")
    # the kernel's edges: the lane counts and vector widths the wrapper
    # picks for d (1, 3: one element a load; 129, 300: more feature chunks),
    # rows of 1 id and around a warp's ballot of 32 ids, RMAT-ER's 44; max
    # also over +-inf / NaN features (a non-finite result is 0)
    for d in (1, 3, 100, 128, 129, 300):
        for W in (1, 31, 32, 33, 44):
            rng = np.random.default_rng(d * 100 + W)
            ell = rand_ell(rng, 300, W, 205, 0.5)   # ids up to n + 4
            ell[::7] = -1
            ell = dev(ell, device)
            for dtype in (torch.float32, torch.bfloat16):
                f = rng.standard_normal((200, d)).astype(np.float32)
                for op in ("sum", "mean", "max"):
                    feats = dev(f, device).to(dtype)
                    cmp.close("ell_spmm", f"edge R300 W{W} n200 d{d} "
                              f"{str(dtype)[6:]} {op}",
                              ops.ell_aggregate(ell, feats, op,
                                                backend=kb),
                              ref.ell_spmm_ref(ell, feats, op),
                              *SPMM_TOL[dtype])
                f[3, 0], f[4, 0], f[5, -1] = np.inf, -np.inf, np.nan
                feats = dev(f, device).to(dtype)
                got = ops.ell_aggregate(ell, feats, "max", backend=kb)
                cmp.close("ell_spmm", f"edge R300 W{W} n200 d{d} "
                          f"{str(dtype)[6:]} max +-inf NaN", got,
                          ref.ell_spmm_ref(ell, feats, "max"),
                          *SPMM_TOL[dtype])
                if bool((got[::7] != 0).any()):
                    fail(f"ell_spmm edge W{W} d{d}: an all-FILL row is "
                         f"not 0")
    # every compiled lane count computes the same function
    if launch:
        rng = np.random.default_rng(8)
        ell = dev(rand_ell(rng, 300, 20, 2000), device)
        for dtype in (torch.float32, torch.bfloat16):
            feats = randn(rng, (2000, 200), dtype, device)
            for op in ("sum", "max"):
                want = ref.ell_spmm_ref(ell, feats, op)
                for lanes in LANES:
                    cmp.close("ell_spmm", f"R300 W20 n2000 d200 "
                              f"{str(dtype)[6:]} {op} lanes{lanes}",
                              ell_spmm(ell, feats, op, lanes=lanes), want,
                              *SPMM_TOL[dtype])
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phase 4: golden file
# --------------------------------------------------------------------------

def golden_module():
    """``tests/make_torch_golden.py``: the run list and entry format of
    ``tests/torch_golden.json`` (numpy only; it imports the reference
    package only in its ``main``, which is not called here)."""
    import importlib.util
    path = os.path.join(HERE, "tests", "make_torch_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_golden(device) -> int:
    from repro_torch import api
    from repro_torch.core.distance2 import (is_bipartite_partial_proper,
                                            is_distance_d_proper)
    from repro_torch.graphs import generators
    gm = golden_module()
    with open(gm.PATH) as f:
        golden = json.load(f)["results"]
    n = 0
    for key, g, kw in gm.runs(generators):
        res = api.color(g, device=device, **kw)
        got, want = gm.entry(res), golden[key]
        if got != want:
            fail(f"golden mismatch for {key}: got {got}, file has {want}")
        if kw.get("mode") == "partial":
            proper = is_bipartite_partial_proper(g, kw["n_left"], res.colors)
        else:
            proper = is_distance_d_proper(g, res.colors, kw.get("distance", 1))
        if not proper:
            fail(f"golden run {key} is not a proper coloring")
        n += 1
    if n != len(golden):
        fail(f"golden: {n} runs for {len(golden)} entries in the file")
    return n


def phase_golden_dynamic(device) -> tuple:
    """The file's dynamic sections on the card: each ``paper_suite("tiny")``
    graph's incremental stream (``api.color(mode="incremental")``, then
    ``recolor_incremental`` a batch) and the megabatched service run, entry
    for entry.  Returns (batches, service tenant-steps) checked."""
    from repro_torch import api
    from repro_torch.dynamic import ColoringService, recolor_incremental
    from repro_torch.graphs import generators
    gm = golden_module()
    with open(gm.PATH) as f:
        doc = json.load(f)
    n_inc = 0
    for name, g in generators.paper_suite("tiny").items():
        got = gm.incremental_stream(
            lambda g_, **kw: api.color(g_, device=device, **kw),
            recolor_incremental, g)
        for i, (a, b) in enumerate(zip(got, doc["incremental"][name])):
            if a != b:
                fail(f"golden incremental {name} batch {i}: got {a}, file "
                     f"has {b}")
        if len(got) != len(doc["incremental"][name]):
            fail(f"golden incremental {name}: {len(got)} batches")
        n_inc += len(got)
    got = gm.service_entries(
        ColoringService(megabatch=True, device=device, **gm.SVC_OPTS),
        generators)
    if got != doc["service"]:
        fail(f"golden service run differs from the file: {got} vs "
             f"{doc['service']}")
    return n_inc, sum(len(s) for s in got)


def phase_golden_mesh(device) -> tuple:
    """The file's distributed sections on the card: ``rsoc`` / ``cat`` with
    ``backend="distributed"`` on meshes of 1 and 4 shards over the tiny
    suite x seeds 0-2, and ``mesh2d(24, 24)``'s sharded streams, entry for
    entry.  Returns (static runs, sharded batches) checked."""
    from repro_torch import api
    from repro_torch.core.coloring import is_proper
    from repro_torch.core.mesh import make_mesh
    from repro_torch.dynamic import recolor_sharded
    from repro_torch.graphs import generators
    gm = golden_module()
    with open(gm.PATH) as f:
        doc = json.load(f)
    meshes = {D: make_mesh((D,), ("data",), device=device)
              for D in gm.DIST_SHARDS}
    n = 0
    for key, g, D, kw in gm.dist_runs(generators):
        res = api.color(g, mesh=meshes[D], **kw)
        got, want = gm.entry(res), doc["distributed"][key]
        if got != want:
            fail(f"golden mismatch for {key}: got {got}, file has {want}")
        if not is_proper(g, res.colors):
            fail(f"golden run {key} is not a proper coloring")
        n += 1
    if n != len(doc["distributed"]):
        fail(f"golden distributed: {n} runs for {len(doc['distributed'])} "
             f"entries")
    got = gm.sharded_stream(api.color, recolor_sharded, meshes.get,
                            generators)
    if got != doc["sharded"]:
        fail(f"golden sharded streams differ from the file: {got} vs "
             f"{doc['sharded']}")
    return n, sum(len(v) for v in got.values())


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
    """Worker-process body: one RMAT, returned as plain arrays, and for the
    ``INC_GRAPHS`` phase 5g's update stream (``make_batches``, made here so
    that its host work overlaps the phases before 5g) with its seconds."""
    from repro_torch.graphs import generators as gen
    t = time.perf_counter()
    g = getattr(gen, kind)(scale, edge_factor=8)
    secs = time.perf_counter() - t
    stream = None
    if kind in INC_GRAPHS:
        t = time.perf_counter()
        stream = make_batches(g, INC_FRACS) + (time.perf_counter() - t,)
    return g.indptr, g.indices, g.n_vertices, secs, stream


def start_rmats(pool, scale: int) -> dict:
    """Start the three RMAT generators in worker processes: the host-side
    numpy generation (tens of seconds each at 2^22) then overlaps the build,
    the kernel checks and the mesh runs instead of preceding each RMAT."""
    return {f"{kind}_{scale}": pool.apply_async(make_rmat, (kind, scale))
            for kind in ("rmat_er", "rmat_g", "rmat_b")}


def build_graphs(rmats: dict, rehearse: bool):
    """name -> zero-argument constructor returning (graph, generate
    seconds, phase 5g's stream or None), in running order."""
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.csr import CSRGraph

    def timed(fn):
        def make():
            t = time.perf_counter()
            g = fn()
            return g, time.perf_counter() - t, None
        return make

    def waited(fut):
        def make():
            indptr, indices, n, secs, stream = fut.get()
            return (CSRGraph(indptr=indptr, indices=indices, n_vertices=n),
                    secs, stream)
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


SPLIT_SLACK = 0.01    # prepare + solve may exceed their call's total by 1 %


def split_of(res, e2e_ms: float, what: str) -> dict:
    """``prepare_ms`` / ``solve_ms`` of a traced run, the wall time of that
    same call (``e2e_traced_ms``) and ``prepare_share`` = prepare over it;
    fails if the two phases add up to more than the call took (past
    ``SPLIT_SLACK``): a split and its total come from one call."""
    prepare_ms = res.trace.phase_wall_s("prepare") * 1e3
    solve_ms = res.trace.phase_wall_s("solve") * 1e3
    if prepare_ms + solve_ms > e2e_ms * (1 + SPLIT_SLACK):
        fail(f"{what}: prepare {prepare_ms:.2f} ms + solve {solve_ms:.3f} ms "
             f"exceed the traced call's {e2e_ms:.2f} ms")
    return {"e2e_traced_ms": round(e2e_ms, 2),
            "prepare_ms": round(prepare_ms, 2),
            "solve_ms": round(solve_ms, 3),
            "prepare_share": round(prepare_ms / e2e_ms, 4)}


def traced_split(g, device, what: str, **kw):
    """One traced ``api.color(g, **kw)`` call, timed on the host clock
    around a synchronize; returns (result, ``split_of`` its trace)."""
    from repro_torch import api
    sync(device)
    t = time.perf_counter()
    res = api.color(g, device=device, trace=True, **kw)
    sync(device)
    return res, split_of(res, (time.perf_counter() - t) * 1e3, what)


class PreparedCache:
    """``core.coloring.prepare``'s problems kept on the host, by graph and
    arguments, so that later calls skip the 2^22 RMATs' host ``prepare``
    (25-31 s a call) that phase 5's traced call already made: 5b's plain
    replay, phase 6's chunk times, and 5f's CAT and GM calls and 5c's
    ``rsoc_compact`` calls, whose prepare is RSOC's (the same function,
    graph and arguments; their rows carry ``prepare_reused`` and a
    ``prepare_ms`` that is the device copy).  Within ``record()`` a
    ``prepare`` runs as usual and keeps its arrays; within ``reuse()`` a
    kept problem is copied to the device (the copy ``prepare``'s last step
    makes) and anything else is prepared as usual.  The problems are
    read-only to the engines, so a reused one gives the same bits; phase
    5's own calls (the cold one as users make it) prepare."""

    def __init__(self):
        from repro_torch.core import coloring
        self.coloring, self.prepare = coloring, coloring.prepare
        self.kept, self.hits, self.saved_s = {}, 0, 0.0

    def _key(self, g, args, kw):
        names = ("seed", "n_chunks", "ell_cap", "C", "relabel")
        vals = dict(zip(names, args), **{k: v for k, v in kw.items()
                                         if k != "device"})
        return id(g), tuple(sorted(vals.items()))

    @staticmethod
    def _to(prob, device):
        return dataclasses.replace(prob, **{
            k: getattr(prob, k).to(device)
            for k in ("ell", "ovf_src", "ovf_dst", "pri")})

    @contextlib.contextmanager
    def record(self):
        def prepare(g, *args, device="cpu", **kw):
            t = time.perf_counter()
            prob = self.prepare(g, *args, device="cpu", **kw)
            self.kept[self._key(g, args, kw)] = (
                g, prob, time.perf_counter() - t)
            return self._to(prob, device)
        self.coloring.prepare = prepare
        try:
            yield
        finally:
            self.coloring.prepare = self.prepare

    @contextlib.contextmanager
    def reuse(self):
        """Yields this block's own count (``.hits``)."""
        block = types.SimpleNamespace(hits=0)

        def prepare(g, *args, device="cpu", **kw):
            hit = self.kept.get(self._key(g, args, kw))
            if hit is None or hit[0] is not g:
                return self.prepare(g, *args, device=device, **kw)
            self.hits += 1
            block.hits += 1
            self.saved_s += hit[2]
            return self._to(hit[1], device)
        self.coloring.prepare = prepare
        try:
            yield block
        finally:
            self.coloring.prepare = self.prepare

    def drop(self):
        self.kept.clear()


class Path:
    """One path's launch counts, summed over its calls.  Each call runs
    with every count set to 0 just before it and is read just after
    (``run``), so the calls of another path in between add nothing here."""

    def __init__(self):
        self.counts = dict.fromkeys(launch_counters(), 0)
        self.designs = {k: dict.fromkeys(d, 0) for k, d in DESIGNS.items()}
        self.detect = dict.fromkeys(detect_only_counts(), 0)
        self.slots = dict.fromkeys(slot_counts(), 0)

    def run(self, fn):
        """``fn()`` between zeroed and read counts; returns (its result,
        its launch counts, per design, of B2's detect-only form)."""
        zero_counts()
        out = fn()
        c, d, x = launch_counts(), design_counts(), detect_only_counts()
        for k, v in slot_counts().items():
            self.slots[k] += v
        for k, v in c.items():
            self.counts[k] += v
        for k, per in d.items():
            for design, v in per.items():
                self.designs[k][design] += v
        for k, v in x.items():
            self.detect[k] += v
        return out, c, d, x


def zero_designs() -> dict:
    return {k: dict.fromkeys(d, 0) for k, d in DESIGNS.items()}


def phase_main(rmats, device, rehearse: bool, prepared: PreparedCache):
    """Phase 5 (RSOC, the main path) and, on each graph while it is still
    in memory, phase 5f (the paper's Table 1: ``table1_graph``) and, on
    the ``INC_GRAPHS``, phase 5g (``phase_incremental``).  The traced call
    of phase 5 keeps its prepared problem in ``prepared``."""
    from repro_torch import api, obs
    from repro_torch.core.coloring import is_proper
    n_chunks = api.ColoringSpec().n_chunks
    rows, kept, t1_rows, kept_cat, inc_rows = [], {}, [], {}, []
    dist_rows, dist_s = [], 0.0
    main, table1, incremental, distributed = Path(), Path(), Path(), Path()
    for name, make in build_graphs(rmats, rehearse).items():
        g, gen_s, stream = make()
        obs.metrics.reset()

        # run 1: the default call, cold (includes host-side prepare)
        def cold():
            sync(device)
            t = time.perf_counter()
            r = api.color(g, device=device)
            sync(device)
            return r, (time.perf_counter() - t) * 1e3

        (res, e2e_ms), c, des, _ = main.run(cold)
        per_design = design_delta(zero_designs(), des, c, name)
        # run 2: the same call traced and timed, for the prepare / solve
        # split and the total they are a split of (the solve phase is
        # synchronize()-bracketed by the tracer)
        with prepared.record():
            (res2, split), _, _, _ = main.run(
                lambda: traced_split(g, device, f"{name}"))
        assert_same_result(res, res2, f"{name}: traced vs untraced run")
        if not is_proper(g, res.colors):
            fail(f"{name}: result is not a proper coloring")
        if res.colors.shape != (g.n_vertices,) or res.colors.dtype != np.int32:
            fail(f"{name}: colors have shape {res.colors.shape} "
                 f"dtype {res.colors.dtype}")
        if device.type == "cuda":
            exact_launch_counts(name, res)
            if c["firstfit"] != n_chunks:
                fail(f"{name}: firstfit launched {c['firstfit']} times, "
                     f"expected n_chunks = {n_chunks}")
            # the RMATs' rows (W 44, 512) take the staged pass, the meshes'
            # (W 8, 14) the direct design
            route = "vec16" if name.startswith("rmat") else "direct"
            if per_design["firstfit"] != {route: n_chunks}:
                fail(f"{name}: firstfit launched {per_design['firstfit']} "
                     f"per design, expected {{'{route}': {n_chunks}}}")
            if c["detect_recolor"] != n_chunks * res.n_rounds:
                fail(f"{name}: detect_recolor launched "
                     f"{c['detect_recolor']} times, expected "
                     f"n_chunks*n_rounds = {n_chunks * res.n_rounds}")
        fb = obs.metrics.counters_matching("kernels.fallback")
        if fb:
            fail(f"{name}: kernels.fallback counters are not empty: {fb}")
        row = {"graph": name, "n": g.n_vertices, "directed_edges": g.n_edges,
               "max_degree": g.max_degree, "proper": True,
               "n_colors": res.n_colors, "n_rounds": res.n_rounds,
               "conflicts": res.total_conflicts, "retries": res.retries,
               "final_C": res.final_C, "generate_ms": round(gen_s * 1e3, 1),
               "e2e_cold_ms": round(e2e_ms, 2), **split,
               "firstfit_launches": c["firstfit"],
               "detect_recolor_launches": c["detect_recolor"],
               "launches_per_design": per_design}
        log("main", json.dumps(row))
        rows.append(row)
        # ---- phase 5f: the paper's Table 1 on this graph ----
        t1_rows += table1_graph(name, g, row, device, table1, kept_cat,
                                prepared)
        # ---- phase 5g: incremental recoloring on this graph ----
        local = None
        if name.startswith(INC_GRAPHS):
            more, local = phase_incremental(
                name, g, stream, row, device, incremental,
                keep=name.startswith(SHARD_GRAPHS))
            inc_rows += more
        # ---- phase 5i: distributed coloring on this graph ----
        t5i = time.perf_counter()
        if name.startswith(DIST_GRAPHS):
            dist_rows += phase_distributed_static(name, g, row, device,
                                                  distributed)
        if name.startswith(SHARD_GRAPHS):
            sb = stream[0] if stream else make_batches(g, MESH_FRACS)[0]
            dist_rows += phase_sharded(name, g, sb, local, device,
                                       distributed)
        del local
        dist_s += time.perf_counter() - t5i
        # kept for phase 5b / 6: the meshes and the uniform and the skewed
        # RMAT (the last one is the largest ELL table of the run)
        if not name.startswith("rmat_g"):
            kept[name] = (g, res)
        del g
    if device.type == "cuda":
        for k in ("firstfit", "detect_recolor"):
            if main.counts[k] < 1:
                fail(f"the main path never launched the {k} kernel")
        for k in ("twohop_detect_recolor", "flash_attention", "ell_spmm"):
            if main.counts[k]:
                fail(f"the main path launched the {k} kernel")
        if main.detect["launches"] or main.slots["launches"]:
            fail("the main path launched the detect-only or the slot-stride "
                 "form of B2")
        if table1.detect["launches"] < 1:
            fail("the Table 1 path never launched the detect-only form")
    if device.type == "cuda" and not incremental.counts["detect_recolor"]:
        fail("the incremental path never launched the detect_recolor kernel")
    if device.type == "cuda":
        for k in ("firstfit", "detect_recolor"):
            if distributed.counts[k] < 1:
                fail(f"the distributed path never launched the {k} kernel")
        if distributed.detect["launches"] < 1:
            fail("the distributed path never launched the detect-only form")
    log("distributed", json.dumps({"phase_5i_seconds": round(dist_s, 1),
                                   "launches": distributed.counts,
                                   "detect_only_launches":
                                       distributed.detect}))
    return (rows, kept, main, t1_rows, table1, kept_cat, inc_rows,
            incremental, dist_rows, distributed)


# GM's serial repair is the reference's Python loop: it runs on the meshes
# and the uniform RMAT only (RMAT-B's defect count is far larger)
GM_GRAPHS = ("mesh2d", "bmw3_2", "pwtk", "rmat_er")


def table1_graph(name, g, rsoc_row, device, path: Path, kept_cat,
                 prepared: PreparedCache) -> list:
    """Phase 5f on one graph: one traced ``api.color(g, algorithm=...)``
    call each of CAT (every graph), GM (``GM_GRAPHS``) and JP (every
    graph), counts zeroed before each call and read after.  Launches,
    checked exactly: CAT first fit ``n_chunks`` (round 0), ``detect_recolor``
    ``n_chunks`` a round (phase A after round 0) and ``1 + n_rounds``
    detect-only launches (phase B); GM first fit ``n_chunks`` and one
    detect-only launch; JP no launch and no dispatch at all.  A run that
    doubled its cap is checked for at least its last attempt's launches (its
    earlier attempts' rounds are not in the result).  Each result must be
    proper and ``kernels.fallback`` empty.  CAT's results on the meshes and
    the uniform RMAT are kept for phase 5b."""
    from repro_torch import api, obs
    from repro_torch.core.coloring import is_proper
    n_chunks = api.ColoringSpec().n_chunks
    route = "vec16" if name.startswith("rmat") else "direct"
    other = "direct" if route == "vec16" else "vec16"
    rows = []
    algos = ["cat"] + (["gm"] if name.startswith(GM_GRAPHS) else []) + ["jp"]
    for algo in algos:
        obs.metrics.reset()
        if device.type == "cuda":
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        # CAT's and GM's prepare is RSOC's (the same function, graph and
        # arguments): phase 5's problem is reused, and the row says so
        with prepared.reuse() as reused:
            (res, split), c, des, det = path.run(
                lambda: traced_split(g, device, f"{name} {algo}",
                                     algorithm=algo))
        what = f"{name} {algo}"
        if not is_proper(g, res.colors) or res.colors.dtype != np.int32 \
                or res.colors.shape != (g.n_vertices,):
            fail(f"{what}: not a proper coloring of shape (n,) int32")
        r = res.n_rounds
        want = dict.fromkeys(c, 0)
        want_det = {"launches": 0, route: 0, other: 0}
        if algo == "cat":
            want.update(firstfit=n_chunks, detect_recolor=n_chunks * r)
            want_det.update(launches=1 + r, **{route: 1 + r})
        elif algo == "gm":
            want.update(firstfit=n_chunks)
            want_det.update(launches=1, **{route: 1})
        if device.type == "cuda":
            got_d = {k: des[k][route] for k in ("firstfit", "detect_recolor")}
            want_d = {k: want[k] for k in got_d}
            exact = (c == want and det == want_det and got_d == want_d)
            at_least = all(c[k] >= want[k] for k in c) and \
                det["launches"] >= want_det["launches"]
            if not (exact if res.retries == 0 else at_least):
                fail(f"{what}: launches {c} (on {route}: {got_d}), detect "
                     f"only {det}; expected {want}, detect only {want_det}")
        fb = obs.metrics.counters_matching("kernels.fallback")
        if fb:
            fail(f"{what}: kernels.fallback counters are not empty: {fb}")
        row = {"graph": name, "algorithm": algo, "n": g.n_vertices,
               "n_colors": res.n_colors, "n_rounds": r,
               "gather_passes": res.gather_passes,
               "conflicts": res.total_conflicts, "retries": res.retries,
               "final_C": res.final_C, **split,
               "prepare_reused": reused.hits > 0,
               "launches": {k: v for k, v in c.items() if v},
               "detect_only_launches": det["launches"]}
        if algo == "cat":
            row["cat_over_rsoc_solve"] = round(
                split["solve_ms"] / rsoc_row["solve_ms"], 4)
            row["rsoc_solve_ms"] = rsoc_row["solve_ms"]
            row["rsoc_n_rounds"] = rsoc_row["n_rounds"]
            if not name.startswith(("rmat_g", "rmat_b")):
                kept_cat[name] = (g, res)
        if algo == "gm":
            rep = next(p for p in res.trace.phases
                       if p.name == "serial_repair")
            row["serial_repair_ms"] = round(rep.wall_s * 1e3, 2)
            row["defects"] = rep.meta["n_defects"]
        if algo == "jp":
            disp = obs.metrics.total_matching("kernels.dispatch")
            if disp:
                fail(f"{what}: JP dispatched {disp} kernel calls")
            row["snapshot_mb"] = round(g.n_vertices * res.final_C / 2 ** 20,
                                       1)
            if device.type == "cuda":
                row["peak_mem_mb"] = round(
                    (torch.cuda.max_memory_allocated(device) - base)
                    / 2 ** 20, 1)
        log("table1", json.dumps(row))
        rows.append(row)
    obs.metrics.reset()
    return rows


def table1_summary(main_rows, t1_rows, d2_rows) -> list:
    """The paper's Table 1 on the card, one row a graph: RSOC (phase 5's
    traced call), CAT (phase 5f), ``rsoc_compact`` (phase 5c's, where it
    ran); ``solve_ms``, rounds, ``gather_passes``, conflicts, colours, and
    CAT's ``solve_ms`` over RSOC's."""
    keys = ("solve_ms", "prepare_ms", "e2e_traced_ms", "n_rounds",
            "gather_passes", "conflicts", "n_colors")
    out = []
    for m in main_rows:
        name = m["graph"]
        cat = next(r for r in t1_rows
                   if r["graph"] == name and r["algorithm"] == "cat")
        comp = next((r for r in d2_rows if r["graph"] == name
                     and r["run"] == "rsoc_compact"), None)
        rsoc = {k: m[k] for k in keys if k in m}
        rsoc["gather_passes"] = 1 + m["n_rounds"]
        row = {"graph": name, "rsoc": rsoc,
               "cat": {k: cat[k] for k in keys},
               "rsoc_compact": ({k: comp[k] for k in keys if k in comp}
                                if comp else None),
               "cat_over_rsoc_solve": cat["cat_over_rsoc_solve"]}
        out.append(row)
    return out


# --------------------------------------------------------------------------
# phase 5g: incremental recoloring at real size
# --------------------------------------------------------------------------

# the stream of bench_incremental.py's sizes: ten batches of 0.1 % of the
# undirected edges, then one of 1 %
INC_FRACS = (0.001,) * 10 + (0.01,)
INC_GRAPHS = ("rmat_g", "rmat_b")      # bench_incremental.py's graphs
PROPER_BLOCK = 2 ** 17                 # rows a block of the on-card check


def undirected_keys(g) -> np.ndarray:
    """Sorted int64 keys ``u << 32 | v`` (u < v) of a CSR graph's edges
    (already sorted and unique when the rows are, as ``from_edges`` writes
    them)."""
    src = np.repeat(np.arange(g.n_vertices, dtype=np.int64),
                    np.diff(g.indptr))
    dst = np.asarray(g.indices, np.int64)
    keep = src < dst
    keys = (src[keep] << 32) | dst[keep]
    if len(keys) > 1 and not bool((keys[1:] > keys[:-1]).all()):
        keys = np.unique(keys)
    return keys


def make_batches(g, fracs, seed: int = 0):
    """``bench_incremental._make_batch`` for each fraction, from one
    ``np.random.default_rng(seed)``: k/2 random inserts and k/2 deletes
    drawn from the current undirected edge set, k = max(2, m * frac).  The
    set is kept on the host as a sorted key array, updated by each batch
    (the benchmark decodes it from the state instead: the same set)."""
    rng = np.random.default_rng(seed)
    und = undirected_keys(g)
    m0 = len(und)
    out = []
    for frac in fracs:
        k = max(2, int(len(und) * frac))
        ins = rng.integers(0, g.n_vertices, size=(k - k // 2, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        pick = rng.choice(len(und), size=min(k // 2, len(und)),
                          replace=False)
        dels = np.stack([und[pick] >> 32, und[pick] & 0xFFFFFFFF], axis=1)
        und = np.delete(und, pick)
        new = np.unique((np.minimum(ins[:, 0], ins[:, 1]).astype(np.int64)
                         << 32) | np.maximum(ins[:, 0], ins[:, 1]))
        at = np.searchsorted(und, new)
        have = (at < len(und)) & (und[np.minimum(at, len(und) - 1)] == new)
        new = new[~have]
        und = np.insert(und, np.searchsorted(und, new), new)
        out.append((ins, dels, k))
    return out, m0


def conflicts_on_card(st) -> int:
    """Edges of a dynamic state whose endpoints share a colour, counted on
    the card over the ELL slots and the live overflow entries; -1 if a
    vertex is uncoloured."""
    c = st.colors_dev
    if bool((c[:st.n] < 0).any()):
        return -1
    bad = torch.zeros((), dtype=torch.int64, device=c.device)
    for lo in range(0, st.n, PROPER_BLOCK):
        hi = min(lo + PROPER_BLOCK, st.n)
        e = st.ell[lo:hi]
        bad += ((e >= 0) & (c[e.clamp(min=0).long()] == c[lo:hi, None])).sum()
    s_, d_ = st.ovf_src, st.ovf_dst
    live = (s_ >= 0) & (d_ >= 0)
    bad += (live & (c[s_.clamp(min=0).long()]
                    == c[d_.clamp(min=0).long()])).sum()
    return int(bad)


def checksum(t) -> tuple:
    """A position-sensitive checksum of a tensor, taken on the card in
    blocks: the sums of x and of x * (1 + i mod 65521) over its flat int64
    view (i the flat position).  Any write that changes a value changes one
    of them but with odds about 2**-64."""
    flat = t.reshape(-1)
    a = torch.zeros((), dtype=torch.int64, device=flat.device)
    b = torch.zeros_like(a)
    for lo in range(0, flat.numel(), FINGERPRINT_BLOCK):
        x = flat[lo:lo + FINGERPRINT_BLOCK].long()
        i = torch.arange(lo, lo + x.numel(), device=flat.device)
        a += x.sum()
        b += (x * (i % 65521 + 1)).sum()
    return int(a), int(b)


def fingerprint(st) -> list:
    """``checksum`` of each tensor of a dynamic state."""
    from repro_torch.dynamic.incremental import TENSOR_FIELDS
    return [(f,) + checksum(getattr(st, f)) for f in TENSOR_FIELDS]


FINGERPRINT_BLOCK = 2 ** 25           # elements a block of ``fingerprint``


def state_fields(st) -> dict:
    """What a 5g batch is compared on: the summary and the five tensors."""
    from repro_torch.dynamic.incremental import TENSOR_FIELDS
    return {"summary": st.summary(),
            **{f: getattr(st, f) for f in TENSOR_FIELDS}}


def phase_incremental(name, g, stream, scratch_row, device, path: Path,
                      keep: bool = False):
    """Phase 5g on one graph: ``api.color(g, mode="incremental", seed=1)``,
    then the ``INC_FRACS`` stream through ``recolor_incremental``, each
    batch traced (its ``apply`` and ``solve`` phases: the waves and the
    repair, each waited for) with the counts zeroed before and read after
    (B2 exactly ``n_chunks`` a gather pass, B1 none), proper on the card;
    and the same stream from the same start state with ``kernel.fallback``
    armed (the plain versions on the card), field-equal and colour-equal at
    every batch.  Each batch's gather passes are held against phase 5's
    from-scratch ``n_rounds + 1``.  ``stream`` is ``make_batches``' output
    and its seconds, made in the graph's generator process.  Returns the
    batches' rows and, with ``keep``, what phase 5i's one-shard stream is
    held to: per state (the start, then each batch) its summary, colours
    and ``fingerprint``."""
    from repro_torch import api, obs
    from repro_torch.dynamic import recolor_incremental
    from repro_torch.resilience import faults
    n_chunks = api.ColoringSpec().n_chunks
    batches, m, batch_s = stream

    def start():
        sync(device)
        t = time.perf_counter()
        r = api.color(g, mode="incremental", seed=1, device=device)
        sync(device)
        return r, (time.perf_counter() - t) * 1e3

    (res, e2e_ms), c, _, _ = path.run(start)
    st0 = res.state
    if device.type == "cuda":
        exact_launch_counts(f"{name} incremental start", res)
        if (c["firstfit"], c["detect_recolor"]) != (
                n_chunks, n_chunks * st0.last_rounds):
            fail(f"{name} incremental start: launches {c}")
    scratch_passes = scratch_row["n_rounds"] + 1
    log("incremental", json.dumps({
        "graph": name, "n": g.n_vertices, "undirected_edges": m,
        "W": int(st0.ell.shape[1]), "ovf_cap": int(st0.ovf_src.shape[0]),
        "frontier_cap": st0.frontier_cap, "start_e2e_ms": round(e2e_ms, 2),
        "start": st0.summary(), "batches_made_s": round(batch_s, 2)}))
    rows = []
    st, st_f = st0, st0
    fp0 = fingerprint(st0)
    kept = [(st0.summary(), st0.colors, fp0)] if keep else None
    for i, (ins, dels, k) in enumerate(batches):
        def one():
            with obs.run_tracer() as tr:
                sync(device)
                t = time.perf_counter()
                out = recolor_incremental(st, ins, dels)
                sync(device)
                wall = (time.perf_counter() - t) * 1e3
            return (out, tr.phase_wall_s("apply") * 1e3,
                    tr.phase_wall_s("solve") * 1e3, wall)

        (st, apply_ms, repair_ms, wall_ms), c, des, _ = path.run(one)
        per_design = design_delta(zero_designs(), des, c,
                                  f"{name} batch {i}")
        passes = st.last_gather_passes
        if device.type == "cuda":
            if st.retries != st0.retries:
                fail(f"{name} batch {i}: a cap-doubling retry; its launch "
                     f"counts cannot be checked exactly")
            if (c["firstfit"], c["detect_recolor"]) != (0, n_chunks * passes):
                fail(f"{name} batch {i}: launches {c}, expected B2 "
                     f"n_chunks x {passes} gather passes")
        bad = conflicts_on_card(st)
        if bad:
            fail(f"{name} batch {i}: {bad} conflicting edges on the card")
        with faults.inject("kernel.fallback"):
            st_f = recolor_incremental(st_f, ins, dels)
        a, b = state_fields(st), state_fields(st_f)
        for f in a:
            same = (torch.equal(a[f], b[f]) if isinstance(a[f], torch.Tensor)
                    else a[f] == b[f])
            if not same:
                fail(f"{name} batch {i}: kernel path and plain path differ "
                     f"in {f}")
        if passes > scratch_passes:
            fail(f"{name} batch {i}: {passes} gather passes, more than the "
                 f"from-scratch run's {scratch_passes}")
        row = {"graph": name, "batch": i, "frac": INC_FRACS[i], "edges": k,
               "inserts": len(ins), "deletes": len(dels),
               "apply_ms": round(apply_ms, 3), "repair_ms": round(repair_ms, 3),
               "wall_ms": round(wall_ms, 3), "rounds": st.last_rounds,
               "gather_passes": passes, "scratch_passes": scratch_passes,
               "conflicts": st.last_conflicts, "colours": st.n_colors,
               "final_C": st.C, "ovf_grows": st.ovf_grows,
               "ovf_load": st.summary()["ovf_load"], "proper": True,
               "b2_launches": per_design.get("detect_recolor", {}),
               "plain_path_equal": True}
        log("incremental", json.dumps(row))
        rows.append(row)
        if keep:
            kept.append((st.summary(), st.colors, fingerprint(st)))
    # the start state was never written (copy-on-write): the plain replay
    # began from it
    if fingerprint(st0) != fp0:
        fail(f"{name}: the start state changed under the stream")
    return rows, kept


# --------------------------------------------------------------------------
# phase 5i: distributed coloring on the card
# --------------------------------------------------------------------------

DIST_D = 4                                 # shards of phase 5i's meshes
DIST_GRAPHS = ("mesh2d", "bmw3_2", "pwtk", "rmat_er")   # static engines
SHARD_GRAPHS = ("rmat_g", "mesh2d")        # the sharded incremental engine
MESH_FRACS = (0.001,) * 3                  # mesh2d's sharded batches
# what the one-shard stream is held to of 5g's states: their summaries'
# keys (a sharded summary has more), colours and tensors
LOCAL_SUMMARY = ("version", "colors", "rounds", "conflicts",
                 "gather_passes", "total_gather_passes", "final_C",
                 "retries", "ovf_grows", "degrade_rung", "ovf_load")


def dist_mesh(device, D: int):
    from repro_torch.core.mesh import make_mesh
    return make_mesh((D,), ("data",), device=device)


def phase_distributed_static(name, g, rsoc_row, device, path: Path) -> list:
    """Phase 5i, static: ``api.color(g, backend="distributed",
    algorithm=...)`` on a mesh of ``DIST_D`` shards sharing the card, RSOC
    and CAT, each one traced call with the counts zeroed before and read
    after, then replayed with ``kernel.fallback`` armed (the plain versions
    on the card) and held field-equal.  Launches are checked exactly: RSOC
    B1 D x n_chunks (round 0) and B2 D x n_chunks a round; CAT B1 D x
    n_chunks in round 0 and in each round's phase A, B2's detect-only form
    D in round 0's and each round's phase B, and no full B2 pass.
    Collectives are one a round and one for round 0 (RSOC), two (CAT): the
    gather passes; the bytes gathered are one colour vector and one int32 a
    shard a round."""
    from repro_torch import api, obs
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.coloring import is_proper
    from repro_torch.resilience import faults
    n_chunks = api.ColoringSpec().n_chunks
    D = DIST_D
    mesh = dist_mesh(device, D)
    n_loc = -(-(-(-g.n_vertices // D)) // n_chunks) * n_chunks
    rows = []
    for algo in ("rsoc", "cat"):
        what = f"{name} {algo} D={D}"
        obs.metrics.reset()
        (res, split), c, des, x = path.run(lambda: traced_split(
            g, device, what, algorithm=algo, backend="distributed",
            mesh=mesh))
        coll, gb = mesh_mod.collectives(), mesh_mod.gathered_bytes()
        fb = obs.metrics.counters_matching("kernels.fallback")
        if fb:
            fail(f"{what}: kernels.fallback counters are not empty: {fb}")
        if not is_proper(g, res.colors):
            fail(f"{what}: result is not a proper coloring")
        r = res.n_rounds
        got = {"firstfit": c["firstfit"], "detect_recolor": c["detect_recolor"],
               "detect_only": x["launches"]}
        want = ({"firstfit": D * n_chunks, "detect_recolor": D * n_chunks * r,
                 "detect_only": 0} if algo == "rsoc" else
                {"firstfit": D * n_chunks * (1 + r), "detect_recolor": 0,
                 "detect_only": D * (1 + r)})
        if device.type == "cuda" and got != want:
            fail(f"{what}: launches {got}, the loop implies {want}")
        if coll != res.gather_passes:
            fail(f"{what}: {coll} collectives for {res.gather_passes} "
                 f"gather passes")
        if gb != (1 + r) * D * (n_loc + 1) * 4:
            fail(f"{what}: {gb} bytes gathered, expected "
                 f"{(1 + r) * D * (n_loc + 1) * 4}")
        t = time.perf_counter()
        with faults.inject("kernel.fallback"):
            res_f = api.color(g, algorithm=algo, backend="distributed",
                              mesh=mesh)
        assert_same_result(res, res_f, f"{what}: kernel vs plain path")
        replay_s = time.perf_counter() - t
        row = {"graph": name, "algorithm": algo, "shards": D,
               "n": g.n_vertices, "n_loc": n_loc, "proper": True,
               "n_rounds": r, "n_colors": res.n_colors,
               "conflicts": res.total_conflicts,
               "gather_passes": res.gather_passes, **split,
               "collectives": coll, "gathered_bytes": gb,
               "launches": got,
               "launches_per_design": design_delta(zero_designs(), des, c,
                                                   what),
               "local_rsoc": {k: rsoc_row[k] for k in (
                   "n_rounds", "n_colors", "conflicts", "solve_ms")},
               "plain_path_equal": True, "replay_s": round(replay_s, 2)}
        log("distributed", json.dumps(row))
        rows.append(row)
    return rows


def conflicts_on_card_sharded(st) -> int:
    """Edges of a sharded state whose endpoints share a colour, counted on
    the card over each shard's ELL slots and live overflow entries, a ghost
    slot read at its owner's colour (not the shard's copy); -1 if a vertex
    is uncoloured."""
    if int(st.colors.min()) < 0:
        return -1
    dev0 = st.colors_tab[0].device
    flat = torch.cat([t[:st.n_loc].to(dev0) for t in st.colors_tab])
    bad = 0
    for d in range(st.n_shards):
        true = st.colors_tab[d].clone()
        ng = int(st.n_ghost[d])
        if ng:
            rows = torch.from_numpy(st.row_of[st.ghost_ids[d, :ng]]).to(dev0)
            true[st.n_loc:st.n_loc + ng] = flat[rows].to(true.device)
        ell = st.ell[d]
        for lo in range(0, st.n_loc, PROPER_BLOCK):
            e = ell[lo:lo + PROPER_BLOCK]
            c = true[lo:lo + e.shape[0]]
            bad += int(((e >= 0) & (true[e.clamp(min=0).long()]
                                    == c[:, None])).sum())
        s_, d_ = st.ovf_src[d], st.ovf_dst[d]
        live = (s_ >= 0) & (d_ >= 0)
        bad += int((live & (true[s_.clamp(min=0).long()]
                            == true[d_.clamp(min=0).long()])).sum())
    return bad


def sharded_fields(st) -> dict:
    """What a sharded batch's plain replay is compared on: the summary,
    the host halo arrays and each shard's five tensors."""
    from repro_torch.dynamic.sharded import TENSOR_FIELDS
    out = {"summary": st.summary()}
    for f in ("boundary", "n_boundary", "ghost_ids", "ghost_flat",
              "n_ghost"):
        out[f] = getattr(st, f)
    for f in TENSOR_FIELDS:
        for d, t in enumerate(getattr(st, f)):
            out[f"{f}[{d}]"] = t
    return out


def differ(a: dict, b: dict) -> list:
    """The keys of two field dicts whose values differ."""
    out = []
    for k in a:
        x, y = a[k], b[k]
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else np.array_equal(x, y) if isinstance(x, np.ndarray)
                else x == y)
        if not same:
            out.append(k)
    return out


def held_to_local(st, local, what: str):
    """A one-shard state against 5g's local state at the same batch
    (``phase_incremental(keep=True)``): summary, colours, and the checksums
    of the local state's tensors taken of the shard's (its priority and
    colour tables cut to the local rows: the rest is the ghost tail)."""
    summary, colors, fp = local
    s = st.summary()
    bad = [k for k in LOCAL_SUMMARY if s[k] != summary[k]]
    if bad or not np.array_equal(st.colors, colors):
        fail(f"{what}: one shard differs from phase 5g's local state in "
             f"{bad or ['colors']}")
    mine = [st.ell[0], st.ovf_src[0], st.ovf_dst[0],
            st.pri_tab[0][:st.n_loc], st.colors_tab[0][:st.n_loc]]
    for (f, a, b), t in zip(fp, mine):
        if checksum(t) != (a, b):
            fail(f"{what}: one shard's {f} differs from phase 5g's")


def phase_sharded(name, g, batches, local, device, path: Path,
                  shards=(1, DIST_D)) -> list:
    """Phase 5i, sharded: ``api.color(g, mode="incremental",
    backend="distributed", seed=1)`` on meshes of ``shards`` shards sharing
    the card, then ``batches`` through ``recolor_sharded``, each traced
    (apply / repair ms) with the counts zeroed before and read after: the
    start B1 D x n_chunks and B2 D x n_chunks a round, a batch B2 D x
    n_chunks a gather pass (every shard runs every round); the collectives
    one for the up-front ghost refresh and one a round, their bytes the
    state's ``last_halo_bytes``; every batch proper on the card.  One
    shard is held field for field to ``local`` (phase 5g's states, kept);
    more shards to the plain replay (``kernel.fallback``) from the same
    start state."""
    from repro_torch import api, obs
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.dynamic import recolor_sharded
    from repro_torch.resilience import faults
    n_chunks = api.ColoringSpec().n_chunks
    rows = []
    for D in shards:
        if D == 1 and local is None:
            continue
        mesh = dist_mesh(device, D)
        what = f"{name} sharded D={D}"

        def start():
            sync(device)
            t = time.perf_counter()
            r = api.color(g, mode="incremental", backend="distributed",
                          mesh=mesh, seed=1)
            sync(device)
            return r, (time.perf_counter() - t) * 1e3

        obs.metrics.reset()
        (res, e2e_ms), c, _, _ = path.run(start)
        st0 = res.state
        if device.type == "cuda":
            exact_launch_counts(f"{what} start", res)
            if (c["firstfit"], c["detect_recolor"]) != (
                    D * n_chunks, D * n_chunks * st0.last_rounds):
                fail(f"{what} start: launches {c}")
        if mesh_mod.gathered_bytes() != st0.last_halo_bytes:
            fail(f"{what} start: {mesh_mod.gathered_bytes()} bytes "
                 f"gathered, the state counts {st0.last_halo_bytes}")
        if D == 1:
            held_to_local(st0, local[0], f"{what} start")
        if conflicts_on_card_sharded(st0):
            fail(f"{what} start: not a proper colouring")
        log("distributed", json.dumps({
            "graph": name, "shards": D, "sharded_start": st0.summary(),
            "start_e2e_ms": round(e2e_ms, 2), "n_loc": st0.n_loc,
            "n_tab": st0.n_tab, "max_b_cap": st0.max_b_cap,
            "max_g_cap": st0.max_g_cap,
            "ghosts": [int(x) for x in st0.n_ghost],
            "W": st0.ell_width, "ovf_cap": st0.ovf_cap,
            "collectives": mesh_mod.collectives()}))
        st, st_f = st0, st0
        for i, (ins, dels, k) in enumerate(batches):
            def one():
                with obs.run_tracer() as tr:
                    sync(device)
                    t = time.perf_counter()
                    out = recolor_sharded(st, ins, dels)
                    sync(device)
                    wall = (time.perf_counter() - t) * 1e3
                return (out, tr.phase_wall_s("apply") * 1e3,
                        tr.phase_wall_s("solve") * 1e3, wall)

            obs.metrics.reset()
            (st, apply_ms, repair_ms, wall_ms), c, des, _ = path.run(one)
            coll, gb = mesh_mod.collectives(), mesh_mod.gathered_bytes()
            passes = st.last_gather_passes
            if device.type == "cuda":
                if st.retries != st0.retries:
                    fail(f"{what} batch {i}: a cap-doubling retry; its "
                         f"launch counts cannot be checked exactly")
                if (c["firstfit"], c["detect_recolor"]) != (
                        0, D * n_chunks * passes):
                    fail(f"{what} batch {i}: launches {c}, expected B2 "
                         f"D x n_chunks x {passes} gather passes")
            if (coll, gb) != (1 + passes, st.last_halo_bytes):
                fail(f"{what} batch {i}: {coll} collectives of {gb} bytes, "
                     f"the state counts {1 + passes} of "
                     f"{st.last_halo_bytes}")
            t = time.perf_counter()
            bad = conflicts_on_card_sharded(st)
            if bad:
                fail(f"{what} batch {i}: {bad} conflicting edges on the "
                     f"card")
            check_s = time.perf_counter() - t
            t = time.perf_counter()
            if D == 1:
                held_to_local(st, local[i + 1], f"{what} batch {i}")
            else:
                with faults.inject("kernel.fallback"):
                    st_f = recolor_sharded(st_f, ins, dels)
                bad = differ(sharded_fields(st), sharded_fields(st_f))
                if bad:
                    fail(f"{what} batch {i}: kernel path and plain path "
                         f"differ in {bad}")
            held_s = time.perf_counter() - t
            row = {"graph": name, "shards": D, "batch": i, "edges": k,
                   "apply_ms": round(apply_ms, 3),
                   "repair_ms": round(repair_ms, 3),
                   "wall_ms": round(wall_ms, 3), "rounds": st.last_rounds,
                   "gather_passes": passes, "conflicts": st.last_conflicts,
                   "colours": st.n_colors, "final_C": st.C,
                   "replans": st.replans,
                   "halo_bytes_per_round": st.halo_bytes_per_round,
                   "last_halo_bytes": st.last_halo_bytes,
                   "collectives": coll, "gathered_bytes": gb,
                   "n_bytes": g.n_vertices * 4,
                   "b2_launches": design_delta(zero_designs(), des, c, what
                                               ).get("detect_recolor", {}),
                   "proper": True, "proper_check_s": round(check_s, 2),
                   "held_to": "phase 5g" if D == 1 else "plain path",
                   "held_s": round(held_s, 2)}
            log("distributed", json.dumps(row))
            rows.append(row)
        if name.startswith("mesh2d") and not (
                0 < st.halo_bytes_per_round < g.n_vertices * 4):
            fail(f"{what}: {st.halo_bytes_per_round} halo bytes a round, "
                 f"not under the O(n) all-gather's {g.n_vertices * 4}")
    return rows


# --------------------------------------------------------------------------
# phase 5h: the megabatched multi-tenant service
# --------------------------------------------------------------------------

# one slot class of bench_service.py's knobs at a real tenant size: ER
# graphs of 65536 vertices, mean degree 8; ell_cap below their max degree
# and ovf_cap above their largest spill, so every tenant has the same shape
SVC_TENANTS, SVC_N, SVC_DEG = 32, 65536, 8.0
SVC_OPTS = dict(seed=0, n_chunks=16, ell_cap=12, C=32, ovf_cap=32768,
                delta_cap=1024, frontier_frac=0.5)
SVC_STEPS, SVC_BATCHES, SVC_INS, SVC_DEL = 4, 4, 256, 128


def service_streams(T: int, n: int, seed: int = 0):
    """``[step][tenant]`` lists of ``SVC_BATCHES`` (inserts, deletes)
    batches: ``SVC_INS`` random inserts (self-loops dropped) and
    ``SVC_DEL`` random deletes (mostly absent edges, as in
    bench_service.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SVC_STEPS):
        per_t = []
        for _t in range(T):
            q = []
            for _b in range(SVC_BATCHES):
                ins = rng.integers(0, n, (SVC_INS, 2))
                ins = ins[ins[:, 0] != ins[:, 1]]
                q.append((ins, rng.integers(0, n, (SVC_DEL, 2))))
            per_t.append(q)
        out.append(per_t)
    return out


def phase_service(device, rehearse: bool):
    """Phase 5h: two ``ColoringService``s, ``megabatch=True`` and
    ``megabatch=False``, with the same ``SVC_TENANTS`` tenants (one slot
    class), stepped ``SVC_STEPS`` times through the same streams, the two
    interleaved step by step; counts zeroed before each step and read
    after.  Per tenant the two must be bit-identical (colours, version,
    summary), with no rollback, quarantine, degrade, escape, solo drain or
    kernel fallback.  Returns (row, the megabatched service's states, the
    counts of each path)."""
    from repro_torch import obs
    from repro_torch.dynamic import ColoringService, slot_key
    from repro_torch.graphs import generators as gen
    T, n = (4, 2048) if rehearse else (SVC_TENANTS, SVC_N)
    opts = dict(SVC_OPTS, ovf_cap=2048) if rehearse else SVC_OPTS
    svcs = {m: ColoringService(megabatch=m, device=device, **opts)
            for m in (True, False)}
    t = time.perf_counter()
    graphs = [gen.erdos_renyi(n, SVC_DEG, seed=i) for i in range(T)]
    for i, g in enumerate(graphs):
        for svc in svcs.values():
            svc.add_graph(f"g{i}", g)
    add_s = time.perf_counter() - t
    keys = {slot_key(svc.snapshot(f"g{i}")) for svc in svcs.values()
            for i in range(T)}
    if len(keys) != 1:
        fail(f"service: the tenants fall in {len(keys)} slot classes")
    passes0 = {i: svcs[False].snapshot(f"g{i}").total_gather_passes
               for i in range(T)}
    obs.metrics.reset()
    paths = {m: Path() for m in svcs}
    step_ms = {m: [] for m in svcs}
    for per_t in service_streams(T, n):
        for i, q in enumerate(per_t):
            for ins, dels in q:
                for svc in svcs.values():
                    svc.submit(f"g{i}", inserts=ins, deletes=dels)
        for m, svc in svcs.items():
            def step():
                t = time.perf_counter()
                svc.step()                 # waits for the device inside
                return (time.perf_counter() - t) * 1e3
            ms, _, _, _ = paths[m].run(step)
            step_ms[m].append(ms)
    for i in range(T):
        a, b = svcs[True], svcs[False]
        nm = f"g{i}"
        if not np.array_equal(a.colors(nm), b.colors(nm)) \
                or a.version(nm) != b.version(nm) \
                or a.stats(nm) != b.stats(nm):
            fail(f"service {nm}: megabatched {a.stats(nm)} != looped "
                 f"{b.stats(nm)}")
        if a.version(nm) != SVC_STEPS * SVC_BATCHES:
            fail(f"service {nm}: version {a.version(nm)}")
        st = a.snapshot(nm)
        bad = conflicts_on_card(st)
        if bad:
            fail(f"service {nm}: {bad} conflicting edges on the card")
    outcomes = obs.metrics.counters_matching("service.mega")
    trouble = {k: v for k, v in obs.metrics.snapshot().get(
        "counters", {}).items()
        if k.startswith(("resilience.", "kernels.fallback")) and v}
    if trouble:
        fail(f"service: rollback / quarantine / degrade / fallback counts "
             f"{trouble}")
    for o in ("escaped", "solo", "group_fail"):
        if outcomes.get(f"service.mega{{outcome={o}}}", 0):
            fail(f"service: {outcomes}: an escape, solo drain or group "
                 f"failure (none is expected at these knobs)")
    loop_passes = sum(svcs[False].snapshot(f"g{i}").total_gather_passes
                      - passes0[i] for i in range(T))
    n_chunks = opts["n_chunks"]
    mc, lc = paths[True], paths[False]
    if device.type == "cuda":
        if mc.counts["detect_recolor"] or mc.counts["firstfit"] \
                or not mc.slots["launches"]:
            fail(f"service, megabatched: launches {mc.counts}, slot stride "
                 f"{mc.slots}")
        if lc.slots["launches"] or lc.counts["detect_recolor"] != \
                n_chunks * loop_passes:
            fail(f"service, looped: B2 {lc.counts['detect_recolor']} "
                 f"launches for {loop_passes} gather passes, slot stride "
                 f"{lc.slots}")

    def pct(xs, q):
        return round(float(np.percentile(xs, q)), 3)

    row = {"tenants": T, "n": n, "mean_degree": SVC_DEG, **opts,
           "steps": SVC_STEPS, "batches_per_step": SVC_BATCHES,
           "inserts": SVC_INS, "deletes": SVC_DEL,
           "add_graphs_s": round(add_s, 2),
           "mega_step_ms": [round(x, 3) for x in step_ms[True]],
           "loop_step_ms": [round(x, 3) for x in step_ms[False]],
           "mega_p50_ms": pct(step_ms[True], 50),
           "mega_p99_ms": pct(step_ms[True], 99),
           "loop_p50_ms": pct(step_ms[False], 50),
           "loop_p99_ms": pct(step_ms[False], 99),
           "mega_slot_stride_launches": mc.slots,
           "loop_b2_launches": lc.counts["detect_recolor"],
           "loop_gather_passes": loop_passes,
           "outcomes": outcomes, "identical": True, "proper": True}
    log("service", json.dumps(row))
    return row, [svcs[True].snapshot(f"g{i}") for i in range(T)], \
        {"service_mega": mc.counts, "service_loop": lc.counts}, mc


# --------------------------------------------------------------------------
# phase 5j: GNN training on the card
# --------------------------------------------------------------------------

# (a) GatedGCN at ogb_products' widths on an RMAT-ER of 2^16 vertices at 13
# undirected edges a vertex: 26.0 directed edges a node against the shape's
# 25.3, the vertex count cut from 2,449,029 so that the activations autograd
# keeps (16 layers of (E, d) tensors) fit the card with room
GNN_SCALE = 16
GNN_EDGE_FACTOR = 13
GNN_STEPS = 10
GNN_CKPT_EVERY = 4
GNN_RESTART_AT = 4            # the second run stops here and restarts
GNN_MEM_LIMIT = 60e9          # bytes: the activations reckoned at ~40 GB
GNN_ATOMIC_STEPS = 4          # steps timed with atomic scatters
# (b) cora's shape: erdos_renyi(2708, 3.9) gives 10,546 directed edges
CORA_N, CORA_DEG, CORA_STEPS = 2708, 3.9, 5
# (c) the halo GatedGCN: mesh2d(256, 256) at 4 shards sharing the card
HALO_MESH, HALO_SHARDS = (256, 256), 4
HALO_REL = 1e-5               # halo loss against the replicated one
HALO_NORM_REL = 1e-4          # the gradients' global norms
# (d) the card against the reference (tests/torch_golden.json) and against
# the port's own CPU run on an RMAT-ER cut to 2^12
GNN_GOLDEN_RTOL = 1e-4        # float32 in another order, six AdamW steps
GNN_CPU_SCALE, GNN_CPU_STEPS = 12, 3
GNN_CPU_RTOL = 1e-4
# (e) colored_segment_sum against the plain segment sum
COLORED_TOL = dict(rtol=1e-5, atol=1e-5)


def train_steps(loss_fn, params, stream, device, total: int, opt,
                ckpt_dir=None, ckpt_every: int = 1):
    """``train_loop.run`` of ``params`` on ``stream``; returns (params,
    losses, per-step wall ms: every step's metrics are read, which waits
    for the card)."""
    from repro_torch.launch.train import to_device
    from repro_torch.training import train_loop as TL
    stamps = [time.perf_counter()]
    params, _, hist = TL.run(
        loss_fn, params, stream, opt,
        TL.TrainLoopConfig(total_steps=total, log_every=1,
                           ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
        to_device=lambda b: to_device(b, device),
        on_metrics=lambda m: stamps.append(time.perf_counter()))
    ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return params, [h["loss"] for h in hist], ms


def gnn_train(loss_fn, cfg, stream_of, device, total: int, opt,
              ckpt_dir=None, init=None):
    """``train_steps`` of a GNN from ``init`` (a ``ParamTree``; None:
    ``gatedgcn_init`` from seed 0 on ``device``) on a fresh stream,
    checkpointing every ``GNN_CKPT_EVERY``; returns (params, losses,
    per-step wall times in ms)."""
    from repro_torch.models import gnn as GNN
    params = init if init is not None else GNN.gatedgcn_init(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    return train_steps(loss_fn, params, stream_of(), device, total, opt,
                       ckpt_dir, GNN_CKPT_EVERY)


def median_after_first(ms: list) -> float:
    return statistics.median(ms[1:]) if len(ms) > 1 else ms[0]


def phase_gnn_full(device, rehearse: bool) -> tuple:
    """(a) GatedGCN at full width (16 layers, d 70; ogb_products' 100
    features and 47 classes) on ``rmat_er(GNN_SCALE, 13)``:
    ``GNN_STEPS`` AdamW steps through ``train_loop.run`` checkpointing
    every ``GNN_CKPT_EVERY`` into a temporary directory; a second run
    stopped at ``GNN_RESTART_AT`` and restarted from LATEST to the end must
    give the first run's parameters and losses bit for bit.  Then the same
    steps with atomic scatters, timed (and whether their bits repeat).
    Returns (row, graph, batch, params) for (e)."""
    import tempfile
    from repro_torch import configs, tree
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data import pipeline as DP
    from repro_torch.graphs import generators as gen
    from repro_torch.models import gnn as GNN
    from repro_torch.training.optimizer import OptimizerConfig
    shp = GNN_SHAPES["ogb_products"]
    arch = configs.get("gatedgcn")
    cfg = arch.make_full(d_in=shp["d_feat"], n_classes=shp["n_classes"])
    scale = 9 if rehearse else GNN_SCALE
    t = time.perf_counter()
    g = gen.rmat_er(scale, edge_factor=GNN_EDGE_FACTOR)
    stream_of = lambda: DP.FullGraphStream(  # noqa: E731
        g, d_feat=shp["d_feat"], n_classes=shp["n_classes"],
        pad_edges_to=1024)
    batch0 = next(stream_of())
    host_s = time.perf_counter() - t
    loss_fn = GNN.gnn_loss_fn(arch, shp, cfg, g.n_vertices + 1)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=GNN_STEPS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        p1, l1, ms1 = gnn_train(loss_fn, cfg, stream_of, device, GNN_STEPS,
                                opt, d1)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        _, l2a, _ = gnn_train(loss_fn, cfg, stream_of, device,
                              GNN_RESTART_AT, opt, d2)
        p2, l2b, _ = gnn_train(loss_fn, cfg, stream_of, device, GNN_STEPS,
                               opt, d2)
    if not all(np.isfinite(l1)):
        fail(f"gnn train (a): a loss is not finite: {l1}")
    if l2a + l2b != l1:
        fail(f"gnn train (a): the restarted run's losses {l2a + l2b} are not "
             f"the uninterrupted run's {l1} bit for bit")
    for (k, a), b in zip(tree.flatten_with_paths(p1), tree.leaves(p2)):
        if not torch.equal(a, b):
            fail(f"gnn train (a): parameter {k} after the restart differs "
                 f"from the uninterrupted run's")
    if peak > GNN_MEM_LIMIT:
        fail(f"gnn train (a): peak memory {peak} B over {GNN_MEM_LIMIT}")
    with GNN.atomic_scatter():
        _, la, msa = gnn_train(loss_fn, cfg, stream_of, device,
                               GNN_ATOMIC_STEPS, opt)
        _, lb, _ = gnn_train(loss_fn, cfg, stream_of, device,
                             GNN_ATOMIC_STEPS, opt)
    row = {"graph": f"rmat_er({scale}, edge_factor={GNN_EDGE_FACTOR})",
           "n_nodes": g.n_vertices + 1, "n_edges": g.n_edges,
           "n_edges_padded": int(batch0["src"].shape[0]),
           "cut_from": {"n_nodes": shp["n_nodes"], "n_edges": shp["n_edges"]},
           "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
           "d_feat": cfg.d_in, "classes": cfg.d_out,
           "host_graph_and_stream_s": round(host_s, 3),
           "losses": l1, "step_ms": [round(x, 3) for x in ms1],
           "ms_per_step": round(median_after_first(ms1), 3),
           "restart_bit_equal": True,
           "peak_memory_bytes": int(peak),
           "atomic_ms_per_step": round(median_after_first(msa), 3),
           "atomic_losses": la, "atomic_repeats_bits": la == lb,
           "atomic_equals_deterministic": la == l1[:GNN_ATOMIC_STEPS]}
    return row, g, batch0, p1


def phase_gnn_colored(device, g, batch, params) -> dict:
    """(e) ``colored_segment_sum`` on (a)'s first-layer messages with
    ``edge_color_by_dst`` classes (the graph's edges, not the sink's
    padding): twice bit-equal, and equal to the plain segment sum within
    ``COLORED_TOL``; the plain (sorted) segment sum twice bit-equal too."""
    from repro_torch.core import schedule
    from repro_torch.models import gnn as GNN
    E = g.n_edges
    src_np, dst_np = batch["src"][:E], batch["dst"][:E]
    t = time.perf_counter()
    ec, k = schedule.edge_color_by_dst(src_np, dst_np, g.n_vertices + 1)
    color_s = time.perf_counter() - t
    src, dst = dev(src_np, device), dev(dst_np, device)
    ec = dev(ec, device)
    n = g.n_vertices + 1
    with torch.no_grad():
        h = dev(batch["feats"], device) @ params["embed"]
        blk = params["blocks"][0]
        e_new = GNN.gather(h @ blk["D"], src) + GNN.gather(h @ blk["E"], dst)
        msg = torch.sigmoid(e_new) * GNN.gather(h @ blk["B"], src)
        a = GNN.colored_segment_sum(msg, dst, n, ec, k)
        b = GNN.colored_segment_sum(msg, dst, n, ec, k)
        plain = GNN.segment_sum(msg, dst, n)
        if not torch.equal(a, b):
            fail("gnn train (e): colored_segment_sum differs between two "
                 "runs")
        if not torch.equal(GNN.segment_sum(msg, dst, n), plain):
            fail("gnn train (e): the sorted segment sum differs between two "
                 "runs")
        err = float((a - plain).abs().max())
        if not torch.allclose(a, plain, **COLORED_TOL):
            fail(f"gnn train (e): colored_segment_sum differs from the "
                 f"plain segment sum by {err} (past {COLORED_TOL})")
        with GNN.atomic_scatter():
            atomic_ms = time_ms(lambda: GNN.segment_sum(msg, dst, n), device,
                                3)
        row = {"edges": E, "d": int(msg.shape[1]), "classes": k,
               "host_edge_coloring_s": round(color_s, 3),
               "max_abs_err_vs_plain": err, "bit_equal_twice": True,
               "colored_ms": time_ms(lambda: GNN.colored_segment_sum(
                   msg, dst, n, ec, k), device, 3),
               "deterministic_segment_sum_ms": time_ms(
                   lambda: GNN.segment_sum(msg, dst, n), device, 3),
               "atomic_segment_sum_ms": atomic_ms}
    return row


def phase_gnn_cora(device, rehearse: bool) -> dict:
    """(b) GAT (2 layers, 8 x 8 heads) and MeshGraphNet (15 layers, d 128,
    zero edge features) at cora's widths (1433 features, 7 classes) on
    ``erdos_renyi(2708, 3.9)``: ``CORA_STEPS`` steps each, ms a step."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data import pipeline as DP
    from repro_torch.graphs import generators as gen
    from repro_torch.models import gnn as GNN
    from repro_torch.training.optimizer import OptimizerConfig
    shp = GNN_SHAPES["full_graph_sm"]
    g = gen.erdos_renyi(CORA_N, CORA_DEG)
    out = {"graph": f"erdos_renyi({CORA_N}, {CORA_DEG})",
           "n_edges": g.n_edges, "cora_n_edges": shp["n_edges"]}
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=CORA_STEPS)
    for name, init in (("gat-cora", GNN.gat_init),
                       ("meshgraphnet", GNN.mgn_init)):
        arch = configs.get(name)
        cfg = arch.make_full(d_in=shp["d_feat"], n_classes=shp["n_classes"])
        loss = GNN.gnn_loss_fn(arch, shp, cfg, g.n_vertices + 1)
        if name == "meshgraphnet":
            base = loss

            def loss(p, b, base=base):        # the launcher's zero features
                return base(p, dict(b, edge_feats=torch.zeros(
                    (b["src"].shape[0], cfg.d_edge_in), device=device)))
        params = init(torch.Generator(device=device).manual_seed(0), cfg,
                      device)
        _, losses, ms = gnn_train(
            loss, cfg, lambda: DP.FullGraphStream(
                g, d_feat=shp["d_feat"], n_classes=shp["n_classes"],
                pad_edges_to=1024),
            device, CORA_STEPS, opt, init=params)
        if not all(np.isfinite(losses)):
            fail(f"gnn train (b): {name}'s losses are not finite: {losses}")
        out[name] = {"losses": losses,
                     "ms_per_step": round(median_after_first(ms), 3),
                     "step_ms": [round(x, 3) for x in ms]}
    return out


def phase_gnn_halo(device, rehearse: bool) -> dict:
    """(c) The halo GatedGCN at full width (ogb_products' widths) on
    ``mesh2d(256, 256)`` through ``block_partition`` / ``build_halo`` at
    ``HALO_SHARDS`` shards sharing the card, against the replicated
    GatedGCN on the same relabeled graph: loss within ``HALO_REL``, the
    gradients' global norms within ``HALO_NORM_REL``; gathered bytes a
    layer counted."""
    from repro_torch import configs, tree
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core import mesh as M
    from repro_torch.core import partition
    from repro_torch.graphs import generators as gen
    from repro_torch.graphs.csr import to_edge_list
    from repro_torch.models import gnn as GNN
    from repro_torch.obs import metrics
    from repro_torch.training.optimizer import global_norm
    gm = golden_module()
    shp = GNN_SHAPES["ogb_products"]
    cfg = configs.get("gatedgcn").make_full(d_in=shp["d_feat"],
                                            n_classes=shp["n_classes"])
    nx, ny = (32, 32) if rehearse else HALO_MESH
    g = gen.mesh2d(nx, ny)
    t = time.perf_counter()
    part = partition.block_partition(g, HALO_SHARDS, seed=0)
    plan = partition.build_halo(part)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((part.n_pad, shp["d_feat"])).astype(
        np.float32)
    labels = rng.integers(0, shp["n_classes"], part.n_pad).astype(np.int32)
    mask = (rng.random(part.n_pad) < 0.6).astype(np.float32)
    shards = [{k: dev(v, device) for k, v in s.items()}
              for s in gm.halo_shards(part, plan, feats, labels, mask)]
    e = to_edge_list(part.graph)
    host_s = time.perf_counter() - t
    params = GNN.gatedgcn_init(torch.Generator(device=device).manual_seed(0),
                               cfg, device)
    mesh = M.make_mesh((HALO_SHARDS,), ("data",), device=device)
    leaves = tree.leaves(params)

    def grads(loss):
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)

    sync(device)
    t = time.perf_counter()
    metrics.reset()
    lh = GNN.gatedgcn_halo_loss(params, cfg, shards, mesh)
    gh = grads(lh)
    sync(device)
    halo_ms = 1e3 * (time.perf_counter() - t)
    coll, gbytes = M.collectives(), M.gathered_bytes()
    t = time.perf_counter()
    lr = GNN.node_classification_loss(
        GNN.gatedgcn_apply(params, cfg, dev(feats, device),
                           dev(e[:, 0].astype(np.int32), device),
                           dev(e[:, 1].astype(np.int32), device),
                           part.n_pad),
        dev(labels, device), dev(mask, device))
    gr = grads(lr)
    sync(device)
    rep_ms = 1e3 * (time.perf_counter() - t)
    lh, lr = float(lh.detach()), float(lr.detach())
    nh, nr = float(global_norm(gh)), float(global_norm(gr))
    rel = abs(lh - lr) / abs(lr)
    nrel = abs(nh - nr) / nr
    if not rel <= HALO_REL:
        fail(f"gnn train (c): halo loss {lh} against the replicated {lr} "
             f"(relative {rel} past {HALO_REL})")
    if not nrel <= HALO_NORM_REL:
        fail(f"gnn train (c): gradient norms {nh} / {nr} (relative {nrel} "
             f"past {HALO_NORM_REL})")
    per_layer = HALO_SHARDS * plan.max_b * cfg.d_hidden * 4
    if coll != cfg.n_layers + 1 or gbytes != (cfg.n_layers * per_layer
                                              + HALO_SHARDS * 2 * 4):
        fail(f"gnn train (c): {coll} collectives and {gbytes} gathered bytes "
             f"for {cfg.n_layers} layers of {per_layer} B and the loss's")
    return {"graph": f"mesh2d({nx}, {ny})", "n": g.n_vertices,
            "n_edges": g.n_edges, "shards": HALO_SHARDS, "max_b": plan.max_b,
            "max_g": plan.max_g,
            "edges_per_shard": [int(s["src"].shape[0]) for s in shards],
            "host_partition_s": round(host_s, 3),
            "halo_loss": lh, "replicated_loss": lr, "loss_rel_err": rel,
            "grad_norm_halo": nh, "grad_norm_replicated": nr,
            "grad_norm_rel_err": nrel, "collectives": coll,
            "gathered_bytes_per_layer": per_layer,
            "replicated_vector_bytes": part.n_pad * cfg.d_hidden * 4,
            "halo_fwd_bwd_ms": round(halo_ms, 3),
            "replicated_fwd_bwd_ms": round(rep_ms, 3)}


def phase_gnn_golden(device, rehearse: bool) -> dict:
    """(d) The card against ``tests/torch_golden.json``'s ``gnn`` section:
    each smoke model's six losses within ``GNN_GOLDEN_RTOL``, the halo
    ring's loss within ``HALO_REL``; and the full-width GatedGCN on
    ``rmat_er(GNN_CPU_SCALE, 13)``: the card's loss history against the
    port's own CPU run of the same steps from the same weights."""
    from repro_torch import configs, tree
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core import mesh as M
    from repro_torch.core import partition
    from repro_torch.data import pipeline as DP
    from repro_torch.graphs import csr
    from repro_torch.graphs import generators as gen
    from repro_torch.models import gnn as GNN
    from repro_torch.training.optimizer import OptimizerConfig
    gm = golden_module()
    with open(gm.PATH) as f:
        golden = json.load(f)["gnn"]
    got = gm.port_gnn_losses(device)
    worst = 0.0
    for arch, want in golden["losses"].items():
        rel = float(np.max(np.abs(np.subtract(got[arch], want))
                           / np.abs(want)))
        worst = max(worst, rel)
        if not rel <= GNN_GOLDEN_RTOL:
            fail(f"gnn train (d): {arch}'s losses {got[arch]} against the "
                 f"reference's {want} (relative {rel})")
    _, shards, _ = gm.halo_ring(partition, csr)
    cfg = GNN.GatedGCNConfig(**gm.HALO_CFG)
    params = GNN.gatedgcn_init(torch.Generator(device=device).manual_seed(0),
                               cfg, device)
    vals = gm.gnn_leaf_values([(k, tuple(x.shape))
                               for k, x in tree.flatten_with_paths(params)])
    with torch.no_grad():
        for k, x in tree.flatten_with_paths(params):
            x.copy_(dev(vals[k], device))
    halo = float(GNN.gatedgcn_halo_loss(
        params, cfg, [{k: dev(v, device) for k, v in s.items()}
                      for s in shards],
        M.make_mesh((gm.HALO_D,), ("data",), device=device)).detach())
    halo_rel = abs(halo - golden["halo_loss"]) / abs(golden["halo_loss"])
    if not halo_rel <= HALO_REL:
        fail(f"gnn train (d): the halo ring's loss {halo} against the "
             f"reference's {golden['halo_loss']} (relative {halo_rel})")
    # the card against the port's CPU run (weights made on the CPU)
    shp = GNN_SHAPES["ogb_products"]
    arch = configs.get("gatedgcn")
    cfg = arch.make_full(d_in=shp["d_feat"], n_classes=shp["n_classes"])
    scale = 9 if rehearse else GNN_CPU_SCALE
    g = gen.rmat_er(scale, edge_factor=GNN_EDGE_FACTOR)
    loss_fn = GNN.gnn_loss_fn(arch, shp, cfg, g.n_vertices + 1)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1,
                          total_steps=GNN_CPU_STEPS)
    p0 = GNN.gatedgcn_init(torch.Generator().manual_seed(0), cfg, "cpu")
    p0 = tree.tree_map(lambda t: t.detach().numpy(), p0)
    runs = {}
    for where in (torch.device("cpu"), device):
        _, runs[where.type], _ = gnn_train(
            loss_fn, cfg, lambda: DP.FullGraphStream(
                g, d_feat=shp["d_feat"], n_classes=shp["n_classes"],
                pad_edges_to=1024),
            where, GNN_CPU_STEPS, opt,
            init=GNN.params_from_reference("gatedgcn", p0, where))
    cpu_rel = float(np.max(np.abs(np.subtract(runs[device.type],
                                              runs["cpu"]))
                           / np.abs(runs["cpu"])))
    if not cpu_rel <= GNN_CPU_RTOL:
        fail(f"gnn train (d): the card's losses {runs[device.type]} against "
             f"the CPU's {runs['cpu']} (relative {cpu_rel})")
    return {"smoke_losses": got, "smoke_max_rel_err": worst,
            "halo_ring_loss": halo, "halo_ring_rel_err": halo_rel,
            "cpu_graph": f"rmat_er({scale}, {GNN_EDGE_FACTOR})",
            "cpu_losses": runs["cpu"], "card_losses": runs[device.type],
            "cpu_max_rel_err": cpu_rel}


def phase_gnn(device, card: str, rehearse: bool) -> dict:
    """Phase 5j: GNN training on the card, (a)-(e).  No kernel of the port
    lies on this path (the reference's GNNs run no Pallas kernel): the
    launch counts are zeroed before and read after, and logged."""
    t0 = time.perf_counter()
    zero_counts()
    full, g, batch, params = phase_gnn_full(device, rehearse)
    log("gnn", json.dumps({"full_width": full, "card": card}))
    colored = phase_gnn_colored(device, g, batch, params)
    log("gnn", json.dumps({"colored_segment_sum": colored, "card": card}))
    del g, batch, params
    cora = phase_gnn_cora(device, rehearse)
    log("gnn", json.dumps({"cora_shape": cora, "card": card}))
    halo = phase_gnn_halo(device, rehearse)
    log("gnn", json.dumps({"halo": halo, "card": card}))
    golden = phase_gnn_golden(device, rehearse)
    log("gnn", json.dumps({"golden": golden, "card": card}))
    row = {"card": card, "full_width": full, "colored_segment_sum": colored,
           "cora_shape": cora, "halo": halo, "golden": golden,
           "launches": launch_counts(),
           "seconds": round(time.perf_counter() - t0, 3)}
    log("gnn", f"phase 5j: {row['seconds']} s, launches of the port's "
               f"kernels {row['launches']}")
    return row


# --------------------------------------------------------------------------
# phase 5k: LM training at full width, and qwen3-32b serving (B5 at D 80)
# --------------------------------------------------------------------------

LM_BATCH, LM_SEQ = 2, 4096     # train_4k's length; its batch cut 256 -> 2
LM_MICROBATCHES = 2
LM_STEPS = 6
LM_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=LM_STEPS)  # the launcher's
# (b) flash_bwd True against False, bfloat16: the forward runs the same
# tiles in the same order (the losses are expected equal); the two
# backwards round differently (the FA-2 one casts ds and p to bfloat16
# before its products, autograd keeps them float32), measured at about 1e-2
# relative (L2, a leaf) on the CPU at the smoke widths
LM_FLASH_LOSS_RTOL = 1e-3
LM_FLASH_GRAD_REL = 5e-2
# (c) the restart: full width, depth cut to keep a checkpoint near 4 GB
LM_RESTART_LAYERS, LM_CKPT_EVERY, LM_RESTART_STEPS = 2, 2, 4
# (d) qwen3-32b at full width, depth cut from 64 to 8 layers (8.8 GB of
# bfloat16 weights beside the earlier phases), 4 requests of 128-1024
LM32_LAYERS, LM32_REQUESTS, LM32_NEW_TOKENS = 8, 4, 8
LM32_PROMPT_LENS = (128, 1024)
# the golden phase: the card's smoke-config LM training against the file's
# lm_train section (float32 in another order; the CPU is within 1e-6)
LM_GOLDEN_TOL = dict(loss_rtol=1e-4, grad_atol=1e-3, after_atol=1e-4)
# the profiler split's ranges, put around the port's functions for one call
LM_SPANS = ("lm.attention", "lm.cross_entropy", "lm.optimizer")
GEMM_KERNEL = re.compile(r"gemm|cutlass|xmma|sm90_|cublas|matmul|nvjet",
                         re.IGNORECASE)


def lm_memory_reckoning(cfg, micro: int) -> dict:
    """Bytes the step holds, reckoned before the run: bfloat16 weights and
    gradients, float32 moments and gradient accumulator, and one
    microbatch's float32 logits; the weights as ``init_params`` allocates
    them (``allocated_params``)."""
    n = allocated_params(cfg)
    return {"params": n, "bf16_weights": 2 * n, "bf16_grads": 2 * n,
            "f32_moments": 8 * n, "f32_grad_accumulator": 4 * n,
            "f32_logits_one_microbatch": 4 * micro * LM_SEQ * cfg.vocab}


def lm_step_split(device, loss_fn, opt_cfg, params, opt_state,
                  batch) -> dict:
    """One microbatch's forward and backward (the first sequence of
    ``batch``) and one optimizer update under ``torch.profiler`` (a step
    runs ``LM_MICROBATCHES`` of the first and one of the second; the
    profiler's own post-processing takes tens of seconds for a whole
    step), its device time split into the attention (``chunked_attention``:
    its tiles forward, in the remat recompute and backward), the cross
    entropy, the optimizer, the other matrix products (kernels named as
    GEMMs) and the rest.  The port's ``chunked_attention`` and
    ``cross_entropy`` run inside ``record_function`` ranges for this call
    only, the update inside one of its own; a backward kernel is given the
    range of the forward op its autograd node came from (the profiler's
    sequence numbers).  On the CPU rehearsal the CPU time of each op
    stands in for the kernels'."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import tree
    from repro_torch.models import layers as L
    from repro_torch.training.optimizer import adamw_update

    def ranged(fn, label):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    saved = (L.chunked_attention, L.cross_entropy)
    L.chunked_attention = ranged(saved[0], LM_SPANS[0])
    L.cross_entropy = ranged(saved[1], LM_SPANS[1])
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    mb = {k: v[:1] for k, v in batch.items()}
    try:
        sync(device)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            loss = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, tree.leaves(params))
            with record_function(LM_SPANS[2]):
                adamw_update(opt_cfg, params,
                             tree.unflatten(params, grads), opt_state)
            sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        L.chunked_attention, L.cross_entropy = saved
    t0 = time.perf_counter()
    events = prof.events()

    def span_above(e):
        while e is not None:
            if e.name in LM_SPANS:
                return e.name
            e = e.cpu_parent
        return None

    seq_span = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            s = span_above(e)
            if s:
                seq_span.setdefault(e.sequence_nr, s)
    ms = dict.fromkeys(LM_SPANS + ("lm.other_matmuls", "lm.rest"), 0.0)
    for e in events:
        x, span = e, None
        while x is not None:
            if x.name in LM_SPANS:
                span = x.name
                break
            if x.name.startswith("autograd::engine::evaluate_function"):
                span = seq_span.get(x.sequence_nr)
                break
            x = x.cpu_parent
        if device.type == "cuda":
            parts = [(k.name, k.duration / 1e3) for k in e.kernels]
        else:
            parts = [(e.name, e.self_cpu_time_total / 1e3)]
        for name, t in parts:
            key = span or ("lm.other_matmuls" if GEMM_KERNEL.search(name)
                           else "lm.rest")
            ms[key] += t
    busy = sum(ms.values())
    return {"profiled": "one microbatch forward + backward, one update",
            "profiled_wall_ms": wall,
            "post_processing_s": time.perf_counter() - t0,
            "device_busy_ms": busy,
            "ms": {k.split(".")[1]: v for k, v in ms.items()},
            "share": {k.split(".")[1]: v / busy if busy else None
                      for k, v in ms.items()},
            "what": "device kernel time" if device.type == "cuda"
            else "CPU op time (rehearsal)"}


def lm_train_full(device, card: str, rehearse: bool) -> tuple:
    """(a) qwen3-1.7b ``make_full()`` (the smoke config, in bfloat16 with
    remat, in the rehearsal): bfloat16, remat on, chunks 1024, flash_bwd as
    the config has it, weights from ``torch.Generator`` seed 0;
    ``LM_STEPS`` steps of ``train_loop.run`` on ``TokenStream(LM_BATCH,
    LM_SEQ)`` with ``LM_MICROBATCHES`` microbatches, no checkpoint.  Every
    loss and gradient norm finite, the last loss below the first, every
    leaf's step-1 gradient nonzero (hooks on the leaves for step 1), no
    kernel launched.  Then a microbatch and an update profiled
    (``lm_step_split``).
    Returns (row, params, cfg)."""
    from repro_torch import configs, tree
    from repro_torch.data import pipeline as DP
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as TF
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig
    arch = configs.get("qwen3-1.7b")
    cfg = (dataclasses.replace(arch.make_smoke(), dtype="bfloat16",
                               remat=True) if rehearse else arch.make_full())
    seq = 128 if rehearse else LM_SEQ
    reckoned = lm_memory_reckoning(cfg, LM_BATCH // LM_MICROBATCHES)
    log("lm", json.dumps({"memory_reckoned_bytes": reckoned, "card": card}))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device, trainable=True)
    sync(device)
    init_s = time.perf_counter() - t
    flat = tree.flatten_with_paths(params)
    step1 = {k: [] for k, _ in flat}
    hooks = [x.register_hook(lambda g, k=k: step1[k].append(
        g.detach().abs().amax())) for k, x in flat]
    stamps = [time.perf_counter()]

    def on_metrics(m):
        stamps.append(time.perf_counter())
        if m["step"] == 1:
            for h in hooks:
                h.remove()

    zero_counts()
    params, opt_state, hist = TL.run(
        lambda p, b: TF.train_step_loss(p, cfg, b), params,
        DP.TokenStream(batch=LM_BATCH, seq_len=seq, vocab=cfg.vocab),
        OptimizerConfig(**LM_OPT),
        TL.TrainLoopConfig(total_steps=LM_STEPS, microbatches=LM_MICROBATCHES,
                           log_every=1, ckpt_dir=None),
        to_device=lambda b: to_device(b, device), on_metrics=on_metrics)
    sync(device)
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if any(c for c in counts.values()):
        fail(f"lm train (a): the training path launched kernels {counts}")
    if not all(np.isfinite(losses + norms)):
        fail(f"lm train (a): a loss or gradient norm is not finite: "
             f"{losses}, {norms}")
    if not losses[-1] < losses[0]:
        fail(f"lm train (a): step {LM_STEPS}'s loss {losses[-1]} is not "
             f"below step 1's {losses[0]}")
    zero = [k for k, v in step1.items()
            if len(v) != LM_MICROBATCHES or not float(torch.stack(v).max())]
    if zero:
        fail(f"lm train (a): no nonzero step-1 gradient for {zero}")
    ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    step_ms = median_after_first(ms)
    batch = to_device(next(DP.TokenStream(batch=LM_BATCH, seq_len=seq,
                                          vocab=cfg.vocab)), device)
    split = lm_step_split(device, lambda p, b: TF.train_step_loss(p, cfg, b),
                          OptimizerConfig(**LM_OPT), params, opt_state, batch)
    del opt_state
    # a step's device time: its microbatches' and one update's; the idle
    # share against the unprofiled steps' median
    opt_ms = split["ms"]["optimizer"]
    split["device_busy_ms_a_step"] = (
        LM_MICROBATCHES * (split["device_busy_ms"] - opt_ms) + opt_ms)
    split["device_idle_share_of_step"] = (
        1 - split["device_busy_ms_a_step"] / step_ms)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "flash_bwd": cfg.flash_bwd, "chunk": [cfg.chunk_q, cfg.chunk_k],
           "batch": LM_BATCH, "seq_len": seq,
           "microbatches": LM_MICROBATCHES, "init_s": init_s,
           "losses": losses, "grad_norms": norms,
           "step_ms": ms, "ms_per_step": step_ms,
           "tokens_per_s": LM_BATCH * seq / (step_ms / 1e3),
           "peak_memory_bytes": int(peak),
           "memory_reckoned_bytes": reckoned,
           "leaves_with_nonzero_step1_grad": len(step1),
           "launches": counts, "step_split": split}
    return row, params, cfg


def lm_flash_pair(device, params, cfg, rehearse: bool) -> dict:
    """(b) One ``value_and_grad`` of ``train_step_loss`` with ``flash_bwd``
    False and True, from (a)'s weights on one batch: the losses within
    ``LM_FLASH_LOSS_RTOL``, each leaf's gradient within
    ``LM_FLASH_GRAD_REL`` (L2, relative to the plain backward's); the peak
    memory each adds to what was held before it."""
    from repro_torch import tree
    from repro_torch.data import pipeline as DP
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as TF
    seq = 128 if rehearse else LM_SEQ
    batch = to_device(next(DP.TokenStream(batch=LM_BATCH, seq_len=seq,
                                          vocab=cfg.vocab, seed=1)), device)
    out = {}
    for fb in (False, True):
        c = dataclasses.replace(cfg, flash_bwd=fb)
        base = 0
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        sync(device)
        t = time.perf_counter()
        loss = TF.train_step_loss(params, c, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        sync(device)
        # the peak this value_and_grad adds to what was held before it (the
        # weights; for the second, the first one's gradients too)
        out[fb] = (float(loss.detach()), grads,
                   (time.perf_counter() - t) * 1e3,
                   torch.cuda.max_memory_allocated(device) - base
                   if device.type == "cuda" else 0)
    (l0, g0, ms0, m0), (l1, g1, ms1, m1) = out[False], out[True]
    loss_rel = abs(l1 - l0) / abs(l0)
    if not loss_rel <= LM_FLASH_LOSS_RTOL:
        fail(f"lm train (b): flash_bwd=True loss {l1} against False's {l0} "
             f"(relative {loss_rel})")
    rel = {}
    for (k, _), a, b in zip(tree.flatten_with_paths(params), g0, g1):
        a, b = a.float(), b.float()
        rel[k] = float((a - b).norm() / a.norm().clamp_min(1e-30))
        if not rel[k] <= LM_FLASH_GRAD_REL or not bool(
                torch.isfinite(b).all()):
            fail(f"lm train (b): {k}'s flash_bwd gradient is {rel[k]} from "
                 f"the plain backward's (tolerance {LM_FLASH_GRAD_REL})")
    return {"loss_plain_bwd": l0, "loss_flash_bwd": l1,
            "loss_rel_err": loss_rel, "grad_rel_err": rel,
            "grad_rel_tol": LM_FLASH_GRAD_REL,
            "ms_plain_bwd": ms0, "ms_flash_bwd": ms1,
            "peak_added_bytes_plain_bwd": int(m0),
            "peak_added_bytes_flash_bwd": int(m1)}


def lm_restart(device, rehearse: bool) -> dict:
    """(c) qwen3-1.7b at full width cut to ``LM_RESTART_LAYERS`` layers:
    ``LM_RESTART_STEPS`` steps uninterrupted, and a run that checkpoints
    every ``LM_CKPT_EVERY`` into a temporary directory, stops ("crashes")
    after ``LM_CKPT_EVERY`` steps and is rerun to the end from LATEST:
    every parameter leaf ``torch.equal`` to the uninterrupted run's, the
    losses equal.  Also: ``ops.attention`` on tensors that require grad
    raises under grad mode (a cut gradient is an error)."""
    import tempfile
    from repro_torch import configs, tree
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as TF
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig
    arch = configs.get("qwen3-1.7b")
    base = (dataclasses.replace(arch.make_smoke(), dtype="bfloat16",
                                remat=True) if rehearse else arch.make_full())
    cfg = dataclasses.replace(base, n_layers=LM_RESTART_LAYERS)
    seq = 128 if rehearse else LM_SEQ
    opt = OptimizerConfig(lr=3e-4, warmup_steps=1,
                          total_steps=LM_RESTART_STEPS)

    def run(total, ckpt_dir):
        params = TF.init_params(
            torch.Generator(device=device).manual_seed(0), cfg, device,
            trainable=True)
        t = time.perf_counter()
        params, _, hist = TL.run(
            lambda p, b: TF.train_step_loss(p, cfg, b), params,
            DP.TokenStream(batch=LM_BATCH, seq_len=seq, vocab=cfg.vocab),
            opt, TL.TrainLoopConfig(total_steps=total,
                                    microbatches=LM_MICROBATCHES,
                                    ckpt_every=LM_CKPT_EVERY,
                                    ckpt_dir=ckpt_dir, log_every=1),
            to_device=lambda b: to_device(b, device))
        sync(device)
        return params, [h["loss"] for h in hist], time.perf_counter() - t

    with tempfile.TemporaryDirectory() as d:
        p_full, l_full, _ = run(LM_RESTART_STEPS, None)
        _, l_a, s_a = run(LM_CKPT_EVERY, d)
        p_res, l_b, s_b = run(LM_RESTART_STEPS, d)
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
    if l_a + l_b != l_full:
        fail(f"lm train (c): the restarted run's losses {l_a + l_b} are not "
             f"the uninterrupted run's {l_full} bit for bit")
    for (k, a), b in zip(tree.flatten_with_paths(p_full), tree.leaves(p_res)):
        if not torch.equal(a, b):
            fail(f"lm train (c): parameter {k} after the restart differs "
                 f"from the uninterrupted run's")
    q = torch.zeros((1, 4, 64, 64), device=device, requires_grad=True)
    k = torch.zeros((1, 4, 64, 64), device=device)
    refused = False
    try:
        ops.attention(q, k, k, causal=True)
    except RuntimeError as e:
        refused = "forward-only" in str(e)
    if device.type == "cuda" and not refused:
        fail("lm train (c): ops.attention on a tensor that requires grad "
             "did not raise under grad mode")
    return {"n_layers": cfg.n_layers, "steps": LM_RESTART_STEPS,
            "ckpt_every": LM_CKPT_EVERY, "losses": l_full,
            "restart_bit_equal": True, "kept_ckpt_bytes": ckpt_bytes,
            "crashed_run_s": s_a, "resumed_run_s": s_b,
            "kernel_refuses_grad": refused}


def lm_serve_32b(device, rehearse: bool) -> tuple:
    """(d) ``ServeEngine`` on qwen3-32b at full width, depth cut to
    ``LM32_LAYERS`` (the smoke config in the rehearsal), random weights
    from seed 0: ``LM32_REQUESTS`` requests with prompts of 128-1024 tokens.
    Counts zeroed before, read after: exactly one attention launch per
    layer per prefill, all on the sm90 design (head dim 80: its tail
    panel).  Each prompt's
    prefill logits against the plain attention (``kernel.fallback``) within
    ``LOGITS_ATOL``.  Returns (row, counts)."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    from repro_torch.resilience import faults
    from repro_torch.serving import Request, ServeEngine
    arch = configs.get("qwen3-32b")
    cfg = (arch.make_smoke() if rehearse else dataclasses.replace(
        arch.make_full(), n_layers=LM32_LAYERS))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    rng = np.random.default_rng(2)
    lo, hi = (8, 64) if rehearse else LM32_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, LM32_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, L).astype(np.int32) for L in lens]
    eng = ServeEngine(params, cfg, batch=LM32_REQUESTS,
                      max_len=hi + LM32_NEW_TOKENS, device=device)
    reqs = [Request(prompt=p, max_new_tokens=LM32_NEW_TOKENS)
            for p in prompts]
    zero_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    sync(device)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    designs = attention_designs()
    if device.type == "cuda":
        want = {k: 0 for k in KERNELS}
        want["flash_attention"] = cfg.n_layers * len(reqs)
        if counts != want:
            fail(f"lm serve 32b (d): launches {counts}, expected {want}")
        if designs != {"sm90": want["flash_attention"], "fma": 0}:
            fail(f"lm serve 32b (d): attention launches by design {designs}"
                 f", expected all {want['flash_attention']} on sm90 (D 80)")
    for r in reqs:
        if not r.done or len(r.out_tokens) != LM32_NEW_TOKENS:
            fail(f"lm serve 32b (d): a request ended with "
                 f"{len(r.out_tokens)} tokens (done={r.done})")
    worst = 0.0
    with torch.inference_mode():
        for p in prompts:
            tokens = torch.from_numpy(p).to(device)[None]
            with faults.inject("kernel.fallback"):
                plain = TF.prefill(params, cfg, tokens)[0].float()
            kern = TF.prefill(params, cfg, tokens)[0].float()
            if not bool(torch.isfinite(kern).all()):
                fail("lm serve 32b (d): prefill logits are not finite")
            worst = max(worst, float((kern - plain).abs().max()))
    if worst > LOGITS_ATOL:
        fail(f"lm serve 32b (d): prefill logits differ by {worst} between "
             f"the kernel and the plain route (tolerance {LOGITS_ATOL})")
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "cut_from_layers": 64,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim,
           "params": sum(p.numel() for p in params.parameters()),
           "prompt_lens": [int(x) for x in lens], "wall_s": wall_s,
           "attention_designs": designs,
           "logits_max_abs_err_vs_plain": worst, "logits_tol": LOGITS_ATOL}
    del eng, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row, counts


def phase_lm(device, card: str, rehearse: bool) -> tuple:
    """Phase 5k: (a)-(c) LM training on the card (no kernel of the port on
    this path: the reference trains in jnp, and B5 is forward only), then
    (d) qwen3-32b serving with B5 at head dim 80.  Returns (row, counts of
    the training path, counts of the serving path)."""
    t0 = time.perf_counter()
    full, params, cfg = lm_train_full(device, card, rehearse)
    log("lm", json.dumps({"full_width": full, "card": card}))
    flash = lm_flash_pair(device, params, cfg, rehearse)
    log("lm", json.dumps({"flash_bwd": flash, "card": card}))
    del params
    counts_train = launch_counts()
    if any(counts_train.values()):
        fail(f"lm train: the training path launched kernels {counts_train}")
    restart = lm_restart(device, rehearse)
    log("lm", json.dumps({"restart": restart, "card": card}))
    serve, counts_serve = lm_serve_32b(device, rehearse)
    log("lm", json.dumps({"serve_qwen3_32b": serve, "card": card}))
    row = {"card": card, "full_width": full, "flash_bwd": flash,
           "restart": restart, "serve_qwen3_32b": serve,
           "seconds": round(time.perf_counter() - t0, 3)}
    log("lm", f"phase 5k: {row['seconds']} s")
    return row, counts_train, counts_serve


def phase_golden_lm(device) -> dict:
    """The card's smoke-config LM training against ``tests/
    torch_golden.json``'s ``lm_train`` section (made by the reference, over
    the batches it stores), within ``LM_GOLDEN_TOL``; each leaf's largest
    first gradient at the reference's element."""
    gm = golden_module()
    with open(gm.PATH) as f:
        want = json.load(f)["lm_train"]
    got = gm.port_lm_train(device, want)
    worst = {"loss_rel": 0.0, "grad_rel_to_absmax": 0.0, "after_abs": 0.0}
    for arch, w in want.items():
        g = got[arch]
        moved = [p for p in w["grad"]
                 if g["grad"][p]["index"] != w["grad"][p]["index"]]
        if moved:
            fail(f"golden lm_train: {arch}'s largest first gradient lies at "
                 f"another element on the card for {moved}")
        worst["loss_rel"] = max(
            worst["loss_rel"], *(abs(a - b) / abs(b) for a, b in zip(
                [g["loss"]] + g["losses"], [w["loss"]] + w["losses"])))
        for path, wg in w["grad"].items():
            worst["grad_rel_to_absmax"] = max(
                worst["grad_rel_to_absmax"], *(
                    abs(a - b) / wg["absmax"] for a, b in
                    zip(g["grad"][path]["values"], wg["values"])))
            worst["after_abs"] = max(worst["after_abs"], abs(
                g["after_steps"][path] - w["after_steps"][path]))
    tol = LM_GOLDEN_TOL
    if not (worst["loss_rel"] <= tol["loss_rtol"]
            and worst["grad_rel_to_absmax"] <= tol["grad_atol"]
            and worst["after_abs"] <= tol["after_atol"]):
        fail(f"golden lm_train: the card's smoke LM training is {worst} "
             f"from the reference's (tolerances {tol})")
    return worst


def phase_golden_models(device) -> dict:
    """The card's smoke ``nequip`` and ``dcn-v2`` against ``tests/
    torch_golden.json``'s ``models`` section (made by the reference, over
    the batches it stores): the forward, one leaf's whole gradient (nequip's
    through the forces: a double backward on the card) and three steps'
    losses, within ``MODELS_GOLDEN_TOL``."""
    gm = golden_module()
    with open(gm.PATH) as f:
        want = json.load(f)["models"]
    got = gm.port_models(device, want)
    worst = {"forward_rel": 0.0, "grad_rel": 0.0, "loss_rel": 0.0}
    for arch, w in want.items():
        g = got[arch]
        worst["forward_rel"] = max(worst["forward_rel"], float(
            np.abs(np.subtract(g["forward"], w["forward"])).max()
            / np.abs(w["forward"]).max()))
        worst["grad_rel"] = max(worst["grad_rel"], float(
            np.abs(np.subtract(g["grad"]["values"], w["grad"]["values"])).max()
            / w["grad"]["absmax"]))
        worst["loss_rel"] = max(worst["loss_rel"], float(
            np.max(np.abs(np.subtract(g["losses"], w["losses"]))
                   / np.abs(w["losses"]))))
    if not all(worst[k] <= MODELS_GOLDEN_TOL[k] for k in worst):
        fail(f"golden models: the card's smoke nequip / dcn-v2 are {worst} "
             f"from the reference's (tolerances {MODELS_GOLDEN_TOL})")
    return worst


# --------------------------------------------------------------------------
# phase 5l: dcn-v2 and nequip at full width (no kernel of the port)
# --------------------------------------------------------------------------

# (a) dcn-v2 make_full() on RECSYS_SHAPES["train_batch"], the launcher's
# optimizer at --steps 6
RECSYS_STEPS = 6
RECSYS_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=RECSYS_STEPS)
# (b) the restart: every width full, the tables cut to this many rows a
# field so that a checkpoint is 0.36 GB, not 5 GB
RECSYS_RESTART_ROWS = 65_536
RECSYS_RESTART_STEPS, RECSYS_CKPT_EVERY = 4, 2
# (c) serving: the examples held against the card host's CPU, and their
# logits' tolerance (float32 products in another order; a fraction of the
# largest logit); the retrieval's top-k
RECSYS_CPU_EXAMPLES = 512
RECSYS_CPU_REL = 1e-4
RETRIEVAL_TOP_K = 100
# (d) nequip make_full() on GNN_SHAPES["molecule"]; the E(3) check's
# tolerances are the reference's test's (tests/test_models_smoke.py)
NEQUIP_STEPS = 6
NEQUIP_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=NEQUIP_STEPS)
E3_TOL = dict(energy_rtol=1e-4, force_rtol=1e-3, force_atol=1e-5)
# the double backward's loss and gradients on the card against the card
# host's CPU (a fraction of each leaf's largest CPU gradient)
NEQUIP_CPU_REL = 1e-4
# the golden phase: the card's smoke nequip / dcn-v2 against the file's
# models section (float32 in another order; the CPU is within 1e-6)
MODELS_GOLDEN_TOL = dict(forward_rel=1e-4, grad_rel=1e-3, loss_rel=1e-4)


def step_split(loss_fn, params, stream, device, opt, step_ms: float) -> dict:
    """One more training step, outside ``train_loop.run``, by part: the
    host's batch (the stream's numpy and the copy to the card; host clock),
    then the forward and backward and the AdamW update under
    ``torch.profiler``: each part's wall ms (host clock to a sync, the
    profiler's own cost included) and the card's kernel time in it (the
    update's kernels are those under its ``record_function`` range; the
    forward's and backward's split into matrix products, named as GEMMs,
    and the rest); and the card's idle share of an unprofiled step of
    ``step_ms`` (``train_loop.run``'s median), 1 - kernel time / step_ms.
    On the CPU rehearsal the CPU time of each op stands in for the
    kernels'.  The parameters take the step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import tree
    from repro_torch.launch.train import to_device
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    state = init_opt_state(params)
    sync(device)
    t0 = time.perf_counter()
    batch = to_device(next(stream), device)
    sync(device)
    t1 = time.perf_counter()
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params),
                                    allow_unused=True, materialize_grads=True)
        sync(device)
        t2 = time.perf_counter()
        with record_function("step.adamw"):
            adamw_update(opt, params, tree.unflatten(params, grads), state)
        sync(device)
        t3 = time.perf_counter()
    ms = {"fwd_bwd_matmul": 0.0, "fwd_bwd_rest": 0.0, "adamw": 0.0}
    for e in prof.events():
        x = e
        while x is not None and x.name != "step.adamw":
            x = x.cpu_parent
        parts = ([(k.name, k.duration / 1e3) for k in e.kernels] if cuda
                 else [(e.name, e.self_cpu_time_total / 1e3)])
        for name, t in parts:
            key = ("adamw" if x is not None else "fwd_bwd_matmul"
                   if GEMM_KERNEL.search(name) else "fwd_bwd_rest")
            ms[key] += t
    return {"batch_host_ms": 1e3 * (t1 - t0),
            "fwd_bwd_wall_ms": 1e3 * (t2 - t1),
            "adamw_wall_ms": 1e3 * (t3 - t2),
            "busy_ms": ms, "busy_total_ms": sum(ms.values()),
            "idle_share_of_step": 1 - sum(ms.values()) / step_ms,
            "what": "device kernel time" if cuda
            else "CPU op time (rehearsal)"}


def peak_shares(flops: float, ms: float) -> dict:
    """Achieved FLOP/s of ``flops`` in ``ms`` and its share of the card's
    float32 and bf16 peaks (``launch.mesh``)."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_F32
    rate = flops / (ms * 1e-3)
    return {"model_flops": flops, "achieved_flops_per_s": rate,
            "share_of_f32_peak": rate / PEAK_FLOPS_F32,
            "share_of_bf16_peak": rate / PEAK_FLOPS_BF16}


def recsys_arch(rehearse: bool, rows=None):
    """``dcn-v2``'s ArchDef, its full config's tables cut to ``rows`` a
    field (the rehearsal: 1000 rows, a narrower tower)."""
    from repro_torch import configs
    arch = configs.get("dcn-v2")
    cfg = arch.make_full()
    if rehearse:
        cfg = dataclasses.replace(cfg, mlp_dims=(64, 64, 32))
        rows = rows or 1000
    if rows:
        cfg = dataclasses.replace(cfg, vocab_sizes=(rows,) * cfg.n_sparse)
    return dataclasses.replace(arch, make_full=lambda: cfg), cfg


def models_recsys_train(device, rehearse: bool) -> tuple:
    """(a) ``dcn-v2`` at full width (26 tables of 1,000,000 x 16, d_x0 429,
    3 full-rank cross layers, MLP 1024-1024-512) through the launcher's
    ``build_recsys``: ``RECSYS_STEPS`` AdamW steps of ``train_loop.run``
    on ``RecsysStream`` batches of ``RECSYS_SHAPES["train_batch"]``
    examples.  Returns (row, params, cfg)."""
    from repro_torch import tree
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.launch.analysis import recsys_model_flops
    from repro_torch.launch.train import build_recsys
    from repro_torch.models import recsys as RS
    from repro_torch.training.optimizer import OptimizerConfig
    arch, cfg = recsys_arch(rehearse)
    B = 1024 if rehearse else RECSYS_SHAPES["train_batch"]["batch"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params, stream, loss = build_recsys(arch, False, B, device)
    sync(device)
    init_s = time.perf_counter() - t
    n = sum(x.numel() for x in tree.leaves(params))
    if n != RS.n_params(cfg):
        fail(f"dcn-v2 (a): {n} parameters, n_params says {RS.n_params(cfg)}")
    opt = OptimizerConfig(**RECSYS_OPT)
    params, losses, ms = train_steps(loss, params, stream, device,
                                     RECSYS_STEPS, opt)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    split = step_split(loss, params, stream, device, opt,
                       median_after_first(ms))
    if not all(np.isfinite(losses)):
        fail(f"dcn-v2 (a): a loss is not finite: {losses}")
    step_ms = median_after_first(ms)
    row = {"params": n, "tables": [cfg.n_sparse, cfg.vocabs[0],
                                   cfg.embed_dim],
           "d_x0": cfg.d_x0, "cross_layers": cfg.n_cross_layers,
           "mlp_dims": list(cfg.mlp_dims), "batch": B,
           "init_s": init_s, "losses": losses, "step_ms": ms,
           "ms_per_step": step_ms, "examples_per_s": B / (step_ms * 1e-3),
           "peak_memory_bytes": int(peak), "step_split": split,
           **peak_shares(recsys_model_flops(cfg, "train", B), step_ms)}
    return row, params, cfg


def models_recsys_restart(device, rehearse: bool) -> dict:
    """(b) ``dcn-v2`` at full width but for its tables, cut to
    ``RECSYS_RESTART_ROWS`` rows a field: ``RECSYS_RESTART_STEPS`` steps
    uninterrupted, and a run that checkpoints every ``RECSYS_CKPT_EVERY``
    into a temporary directory, stops after ``RECSYS_CKPT_EVERY`` steps and
    is rerun to the end from LATEST: every parameter leaf and every loss
    bit-equal to the uninterrupted run's (the tables' gradients are the
    sorted scatter, so repeated ids add in one order)."""
    import tempfile
    from repro_torch import tree
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.launch.train import build_recsys
    from repro_torch.training.optimizer import OptimizerConfig
    arch, cfg = recsys_arch(rehearse, RECSYS_RESTART_ROWS)
    B = 1024 if rehearse else RECSYS_SHAPES["train_batch"]["batch"]
    opt = OptimizerConfig(lr=3e-4, warmup_steps=1,
                          total_steps=RECSYS_RESTART_STEPS)

    def run(total, ckpt_dir):
        params, stream, loss = build_recsys(arch, False, B, device)
        t = time.perf_counter()
        params, losses, _ = train_steps(loss, params, stream, device, total,
                                        opt, ckpt_dir, RECSYS_CKPT_EVERY)
        return params, losses, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as d:
        p_full, l_full, _ = run(RECSYS_RESTART_STEPS, None)
        _, l_a, s_a = run(RECSYS_CKPT_EVERY, d)
        p_res, l_b, s_b = run(RECSYS_RESTART_STEPS, d)
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
    if l_a + l_b != l_full:
        fail(f"dcn-v2 (b): the restarted run's losses {l_a + l_b} are not "
             f"the uninterrupted run's {l_full} bit for bit")
    for (k, a), b in zip(tree.flatten_with_paths(p_full), tree.leaves(p_res)):
        if not torch.equal(a, b):
            fail(f"dcn-v2 (b): parameter {k} after the restart differs from "
                 f"the uninterrupted run's")
    return {"cut": {"table_rows": cfg.vocabs[0], "from": 1_000_000,
                    "why": "a checkpoint of the full tables is 5 GB"},
            "params": sum(x.numel() for x in tree.leaves(p_full)),
            "steps": RECSYS_RESTART_STEPS, "ckpt_every": RECSYS_CKPT_EVERY,
            "losses": l_full, "restart_bit_equal": True,
            "kept_ckpt_bytes": ckpt_bytes, "crashed_run_s": s_a,
            "resumed_run_s": s_b}


def models_recsys_serve(device, params, cfg, rehearse: bool) -> dict:
    """(c) ``predict`` at ``serve_p99`` and ``serve_bulk``; ``make_candidate
    _tower`` over ``retrieval_cand``'s 1,000,000 candidates and
    ``retrieval_scores`` of one query against them (top ``RETRIEVAL_TOP_K``,
    held to a sort of the scores on the host); ms a call (``time_ms``);
    ``RECSYS_CPU_EXAMPLES`` examples' logits against the same parameters
    and module on the card host's CPU."""
    from repro_torch import tree
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.data import pipeline as DP
    from repro_torch.launch.train import to_device
    from repro_torch.models import recsys as RS

    def stream(batch, seed):
        return next(DP.RecsysStream(batch=batch, n_dense=cfg.n_dense,
                                    n_sparse=cfg.n_sparse, vocabs=cfg.vocabs,
                                    max_hots=cfg.max_hots, seed=seed))
    shapes = {k: RECSYS_SHAPES[k]["batch"] for k in ("serve_p99",
                                                     "serve_bulk")}
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    if rehearse:
        shapes, n_cand = {"serve_p99": 512, "serve_bulk": 4096}, 8192
    out = {"card": {}}
    bulk = to_device(stream(shapes["serve_bulk"], 1), device)
    with torch.no_grad():
        for name, B in shapes.items():
            b = {k: v[:B] for k, v in bulk.items()}
            ms = time_ms(lambda: RS.predict(params, cfg, b), device, 1, 3)
            out["card"][name] = {"batch": B, "ms": ms,
                                 "examples_per_s": B / (ms * 1e-3)}
        cand_in = to_device(stream(n_cand, 2), device)
        cand = None

        def tower():
            nonlocal cand
            cand = RS.make_candidate_tower(params, cfg, cand_in["dense"],
                                           cand_in["sparse"])
        tower_ms = time_ms(tower, device, 1, 3)
        q = to_device(stream(1, 3), device)
        res = None

        def score():
            nonlocal res
            res = RS.retrieval_scores(params, cfg, q["dense"], q["sparse"],
                                      cand, top_k=RETRIEVAL_TOP_K)
        score_ms = time_ms(score, device, 1, 3)
        scores, top_v, top_i = (x.cpu().numpy() for x in res)
        logits = RS.dcnv2_forward(params, cfg,
                                  bulk["dense"][:RECSYS_CPU_EXAMPLES],
                                  bulk["sparse"][:RECSYS_CPU_EXAMPLES]).cpu()
        host = tree.tree_map(lambda t: t.detach().cpu(), params)
        cpu_b = {k: v[:RECSYS_CPU_EXAMPLES].cpu() for k, v in bulk.items()}
        logits_cpu = RS.dcnv2_forward(host, cfg, cpu_b["dense"],
                                      cpu_b["sparse"])
    want = np.sort(scores)[::-1][:RETRIEVAL_TOP_K]
    if not (np.array_equal(top_v, want) and np.array_equal(scores[top_i],
                                                            top_v)
            and len(set(top_i.tolist())) == RETRIEVAL_TOP_K):
        fail("dcn-v2 (c): the top-k is not the top of a host sort of the "
             "scores")
    if cand.shape != (n_cand, cfg.mlp_dims[-1]) or not torch.isfinite(
            cand).all():
        fail(f"dcn-v2 (c): candidate tower {tuple(cand.shape)} or not finite")
    rel = float((logits - logits_cpu).abs().max() / logits_cpu.abs().max())
    if not rel <= RECSYS_CPU_REL:
        fail(f"dcn-v2 (c): {RECSYS_CPU_EXAMPLES} examples' logits on the card "
             f"are {rel} (of the largest) from the CPU's, over "
             f"{RECSYS_CPU_REL}")
    out["card"]["retrieval_cand"] = {
        "n_candidates": n_cand, "candidate_tower_ms": tower_ms,
        "retrieval_scores_ms": score_ms, "top_k": RETRIEVAL_TOP_K,
        "top_k_equals_host_sort": True}
    out["cpu_examples"] = RECSYS_CPU_EXAMPLES
    out["cpu_logits_rel_err"] = rel
    return out


def models_nequip(device, rehearse: bool) -> dict:
    """(d) ``nequip`` at full width (5 layers, 32 channels, l_max 2, 8
    radial functions, 15 paths) on ``GNN_SHAPES["molecule"]`` (128
    molecules of 30 atoms and 64 edges: 3,841 nodes with the sink, 8,192
    edges): the E(3) check under a rotation and a translation within the
    reference's test tolerances (``E3_TOL``); one ``energy_loss`` with a
    ``forces`` label and its gradient (a double backward) on the card
    against the card host's CPU (``NEQUIP_CPU_REL``); ``NEQUIP_STEPS``
    AdamW steps of ``energy_loss`` (as the launcher trains); and
    ``gnn.segment_sum`` with every id in range bit-equal to the plain
    sorted scatter into n rows."""
    from repro_torch import configs, tree
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data import pipeline as DP
    from repro_torch.launch.analysis import gnn_model_flops
    from repro_torch.launch.train import to_device
    from repro_torch.models import equivariant as EQ
    from repro_torch.models import gnn as GNN
    from repro_torch.training.optimizer import OptimizerConfig
    cfg = configs.get("nequip").make_full()
    shp = GNN_SHAPES["molecule"]
    mol = dict(n_nodes=shp["n_nodes"], n_edges=shp["n_edges"],
               batch=8 if rehearse else shp["batch"], n_species=16, d_feat=0)
    p_cpu = EQ.nequip_init(torch.Generator().manual_seed(0), cfg, "cpu")
    host = tree.tree_map(lambda t: t.detach().numpy(), p_cpu)
    params = EQ.params_from_reference(host, device)
    b = next(DP.MoleculeStream(**mol))
    n = b["species"].shape[0]
    bt = to_device(b, device)
    # the E(3) check: the reference test's rotation, a translation
    a, c, d = 0.3, 1.1, -0.7
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Ry = np.array([[np.cos(c), 0, np.sin(c)], [0, 1, 0],
                   [-np.sin(c), 0, np.cos(c)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(d), -np.sin(d)],
                   [0, np.sin(d), np.cos(d)]])
    R = (Rz @ Ry @ Rx).astype(np.float32)
    pos2 = (b["positions"] @ R.T + np.float32([1.0, -2.0, 0.5])).astype(
        np.float32)
    with torch.no_grad():
        e1, f1 = EQ.energy_and_forces(params, cfg, bt["species"],
                                      bt["positions"], bt["src"], bt["dst"],
                                      n)
        e2, f2 = EQ.energy_and_forces(params, cfg, bt["species"],
                                      dev(pos2, device), bt["src"], bt["dst"],
                                      n)
    e1, e2 = float(e1), float(e2)
    f1r, f2 = f1.cpu().numpy() @ R.T, f2.cpu().numpy()
    e_rel = abs(e1 - e2) / abs(e2)
    f_err = np.abs(f1r - f2)
    f_ratio = float((f_err / (E3_TOL["force_atol"]
                              + E3_TOL["force_rtol"] * np.abs(f2))).max())
    if not (e_rel <= E3_TOL["energy_rtol"] and f_ratio <= 1.0
            and np.isfinite(f2).all()):
        fail(f"nequip (d): the E(3) check failed: energy relative {e_rel}, "
             f"forces at {f_ratio} of their tolerance ({E3_TOL})")
    # the double backward, card against the card host's CPU
    rng = np.random.default_rng(3)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    lb = {k: b[k] for k in ("species", "positions", "src", "dst",
                            "graph_id", "energy")}
    lb["forces"] = rng.standard_normal((n, 3)).astype(np.float32)
    lb["node_mask"] = mask
    def double_backward(where):
        dv = torch.device("cpu") if where == "cpu" else device
        p = p_cpu if where == "cpu" else params
        t = time.perf_counter()
        loss = EQ.energy_loss(p, cfg, to_device(lb, dv))
        g = torch.autograd.grad(loss, tree.leaves(p), allow_unused=True,
                                materialize_grads=True)
        sync(dv)
        return (float(loss.detach()), [x.cpu() for x in g],
                1e3 * (time.perf_counter() - t))

    def worst(got, want):
        """(largest error of a leaf over its largest CPU gradient, the
        leaf), over the leaves the loss reaches."""
        return max((float((a - b).abs().max() / b.abs().max()), k)
                   for k, a, b in zip(tree.flatten_with_paths(p_cpu), got,
                                      want) if b.abs().max() > 0)

    grads = {w: double_backward(w) for w in ("cpu", "card")}
    loss_rel = abs(grads["card"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
    grad_rel, grad_leaf = worst(grads["card"][1], grads["cpu"][1])
    if not (loss_rel <= NEQUIP_CPU_REL and grad_rel <= NEQUIP_CPU_REL):
        # which side moved: each computed again, its bits compared
        again = {w: double_backward(w) for w in grads}
        same = {w: again[w][0] == grads[w][0] and all(
            torch.equal(a, b) for a, b in zip(again[w][1], grads[w][1]))
            for w in grads}
        fail(f"nequip (d): the double backward on the card is {loss_rel} "
             f"(loss: card {grads['card'][0]}, CPU {grads['cpu'][0]}) / "
             f"{grad_rel} (gradients, of a leaf's largest, at {grad_leaf[0]}) "
             f"from the CPU's, over {NEQUIP_CPU_REL}; computed again, each "
             f"side repeats its bits: {same}")
    # training steps, as the launcher's energy_loss (no forces)
    stream = DP.MoleculeStream(**mol)
    opt = OptimizerConfig(**NEQUIP_OPT)

    def loss_fn(p, bb):
        return EQ.energy_loss(p, cfg, bb)
    params, losses, ms = train_steps(loss_fn, params, stream, device,
                                     NEQUIP_STEPS, opt)
    split = step_split(loss_fn, params, stream, device, opt,
                       median_after_first(ms))
    if not all(np.isfinite(losses)):
        fail(f"nequip (d): a loss is not finite: {losses}")
    step_ms = median_after_first(ms)
    E = int(b["src"].shape[0])
    # the segment sum with every id in range: the sorted scatter's bits
    x = torch.randn((E, cfg.channels, 5), generator=torch.Generator(
        device=device).manual_seed(1), device=device)
    ids = bt["dst"]
    plain = x.new_zeros((n,) + tuple(x.shape[1:]))
    if device.type == "cuda":
        plain.index_put_((ids.long(),), x, accumulate=True)
    else:
        plain.index_add_(0, ids, x)
    if not torch.equal(GNN.segment_sum(x, ids, n), plain):
        fail("nequip (d): segment_sum with every id in range is not the "
             "plain sorted scatter bit for bit")
    return {"layers": cfg.n_layers, "channels": cfg.channels,
            "l_max": cfg.l_max, "n_rbf": cfg.n_rbf, "paths": len(cfg.paths),
            "molecules": mol["batch"], "n_nodes": n, "n_edges": E,
            "e3": {"energy": e1, "energy_rel_err": e_rel,
                   "force_max_abs_err": float(f_err.max()),
                   "force_max": float(np.abs(f2).max()),
                   "force_share_of_tolerance": f_ratio},
            "double_backward": {"loss_card": grads["card"][0],
                                "loss_cpu": grads["cpu"][0],
                                "loss_rel_err": loss_rel,
                                "grad_rel_err": grad_rel,
                                "grad_worst_leaf": grad_leaf[0],
                                "card_ms_first_call": grads["card"][2]},
            "losses": losses, "step_ms": ms, "ms_per_step": step_ms,
            "step_split": split, "segment_sum_bit_equal": True,
            **peak_shares(gnn_model_flops("nequip", cfg, n, E), step_ms)}


def phase_models(device, card: str, rehearse: bool) -> tuple:
    """Phase 5l: (a)-(c) ``dcn-v2`` and (d) ``nequip`` at full width on the
    card.  No kernel of the port lies on this path (the reference computes
    both models in jnp): the launch counts are zeroed before and read
    after, and must be all 0.  Returns (row, counts)."""
    t0 = time.perf_counter()
    zero_counts()
    train, params, cfg = models_recsys_train(device, rehearse)
    log("models", json.dumps({"dcn_v2_train": train, "card": card}))
    serve = models_recsys_serve(device, params, cfg, rehearse)
    log("models", json.dumps({"dcn_v2_serve": serve, "card": card}))
    del params
    restart = models_recsys_restart(device, rehearse)
    log("models", json.dumps({"dcn_v2_restart": restart, "card": card}))
    nequip = models_nequip(device, rehearse)
    log("models", json.dumps({"nequip": nequip, "card": card}))
    counts = launch_counts()
    if any(counts.values()):
        fail(f"models: the dcn-v2 / nequip path launched kernels {counts}")
    row = {"card": card, "dcn_v2_train": train, "dcn_v2_serve": serve,
           "dcn_v2_restart": restart, "nequip": nequip, "launches": counts,
           "seconds": time.perf_counter() - t0}
    log("models", f"phase 5l: {row['seconds']} s, launches of the port's "
                  f"kernels {counts}")
    return row, counts


# --------------------------------------------------------------------------
# phase 5m: MoE and MLA — qwen2-moe-a2.7b, phi3.5-moe and minicpm3-4b served
# at full width (B5 on sm90 at D 128 and at D 96), two trained at depth 2
# --------------------------------------------------------------------------

MM_REQUESTS, MM_NEW_TOKENS = 4, 8
MM_PROMPT_LENS = (128, 1024)          # drawn uniformly, both ends included
# (arch, layers kept or None for all): phi3.5-moe-42b-a6.6b's 41.74e9
# parameters are 83.5 GB in bfloat16, more than the card holds; at full
# width its depth is cut from 32 to 8 layers (10.6e9 parameters, 21 GB)
MM_SERVE = (("qwen2-moe-a2.7b", None), ("minicpm3-4b", None),
            ("phi3.5-moe-42b-a6.6b", 8))
# (b) one MoE layer at full width on MM_MOE_TOKENS tokens, float32 (no
# TF32), the card against the card host's CPU: the routing equal; a choice
# that differs must be a near-tie of the router's float32 product (its two
# probabilities within MM_TIE); the output within MM_MOE_OUT_REL of its
# largest magnitude (float32 products of 2048-6400 terms in another order,
# three in a row: about 1e-6 expected), the aux loss within MM_MOE_AUX_RTOL
MM_MOE_TOKENS = 512
MM_TIE = 1e-6
MM_MOE_OUT_REL = 1e-4
MM_MOE_AUX_RTOL = 1e-5
# (c) training at full width, depth cut to 2 layers, train_4k's 4096 tokens
# with the batch cut as 5k cuts it (LM_BATCH x LM_SEQ, LM_MICROBATCHES)
MM_TRAIN = ("qwen2-moe-a2.7b", "minicpm3-4b")
MM_TRAIN_LAYERS, MM_TRAIN_STEPS = 2, 3
MM_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=MM_TRAIN_STEPS)
MM_BUDGET_S = 60.0                    # the phase's share of the time limit


def allocated_params(cfg) -> int:
    """Parameters ``init_params`` allocates for ``cfg``: ``n_params()``
    with the padded expert count (qwen2-moe allocates 64 experts for its
    60), plus the norms it leaves out (qk-norm's, MLA's ``q_norm`` and
    ``kv_norm``)."""
    n_cfg = cfg
    if cfg.moe:
        n_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=cfg.moe.e_pad))
    n = n_cfg.n_params()
    if cfg.qk_norm:
        n += cfg.n_layers * 2 * cfg.head_dim
    if cfg.attn_type == "mla":
        n += cfg.n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    return n


def mm_config(name: str, layers, rehearse: bool):
    """The config a 5m sub-phase runs: ``make_full()`` (depth cut to
    ``layers`` where given); in the rehearsal the smoke config in
    bfloat16."""
    from repro_torch import configs
    arch = configs.get(name)
    if rehearse:
        return dataclasses.replace(arch.make_smoke(), dtype="bfloat16")
    cfg = arch.make_full()
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def mm_attention_on_path(params, cfg, prompt, device, cmp: Cmp) -> dict:
    """One kernel-route prefill of ``prompt`` with every layer's attention
    watched (``layers.prefill_attention``, through which GQA and MLA
    reach the kernel): each layer's output held against
    ``ref.flash_attention_ref`` on the same q, k and v within ``FA_TOL``
    and, row by row, ``ROW_TOL``.  Returns the worst errors."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    orig, errs = L.prefill_attention, []

    def watched(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, causal=kw["causal"])
        label = (f"5m {cfg.name} layer {len(errs)} Hq{q.shape[1]} "
                 f"Hkv{k.shape[1]} L{q.shape[2]} D{q.shape[3]}")
        cmp.close("flash_attention", label, out, want, *FA_TOL[q.dtype])
        cmp.rows("flash_attention", label, out, want, ROW_TOL[q.dtype])
        errs.append(float((out.float() - want.float()).abs().max()))
        return out

    L.prefill_attention = watched
    try:
        with torch.inference_mode():
            TF.prefill(params, cfg, torch.from_numpy(prompt).to(device)[None])
    finally:
        L.prefill_attention = orig
    if len(errs) != cfg.n_layers:
        fail(f"5m {cfg.name}: {len(errs)} watched attention calls in a "
             f"prefill of {cfg.n_layers} layers")
    return {"layers_checked": len(errs), "max_abs_err": max(errs),
            "head_dim": (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
                         if cfg.attn_type == "mla" else cfg.head_dim)}


def mm_routes_and_logits(params, cfg, prompts, device) -> dict:
    """Each prompt's prefill through the kernel route and the plain route
    (``kernel.fallback``): the largest logits difference, and for MoE the
    share of (layer, token) routing choices (a token's top-k in order)
    that the two routes share (watched at ``moe.moe_route``)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.resilience import faults
    orig, seen = MOE.moe_route, []

    def watched(*a):
        res = orig(*a)
        seen.append(res[2])
        return res

    worst, same, total = 0.0, 0, 0
    MOE.moe_route = watched
    try:
        with torch.inference_mode():
            for p in prompts:
                tokens = torch.from_numpy(p).to(device)[None]
                seen.clear()
                before = launch_counts()
                with faults.inject("kernel.fallback"):
                    plain = TF.prefill(params, cfg, tokens)[0].float()
                if launch_counts() != before:
                    fail(f"5m {cfg.name}: the plain route launched a kernel")
                plain_routes = list(seen)
                seen.clear()
                kern = TF.prefill(params, cfg, tokens)[0].float()
                if kern.shape != (1, cfg.vocab) or not bool(
                        torch.isfinite(kern).all()):
                    fail(f"5m {cfg.name}: prefill logits "
                         f"{tuple(kern.shape)} are not (1, {cfg.vocab}) "
                         f"finite values")
                worst = max(worst, float((kern - plain).abs().max()))
                for a, b in zip(seen, plain_routes, strict=True):
                    same += int((a == b).all(-1).sum())
                    total += a.shape[0]
    finally:
        MOE.moe_route = orig
    out = {"logits_max_abs_err_vs_plain": worst}
    if cfg.moe:
        out["routing_share_equal_vs_plain"] = same / total
    return out


def mm_moe_layer_vs_cpu(params, cfg, device, rehearse: bool) -> dict:
    """(b) Layer 0's MoE of the served weights, in float32, on
    ``MM_MOE_TOKENS`` random tokens: ``moe_route`` / ``moe_apply`` on the
    card against the same calls on the card host's CPU."""
    from repro_torch.models import moe as MOE
    ffn = params.layer_views()[0]["ffn"]

    def f32(t, dev):
        if isinstance(t, dict):
            return {k: f32(v, dev) for k, v in t.items()}
        return t.detach().float().to(dev)

    T = 64 if rehearse else MM_MOE_TOKENS
    x = torch.randn((T, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    res = {}
    for dev in (device, torch.device("cpu")):
        p = f32(ffn, dev)
        with torch.inference_mode():
            probs, _, eidx, pos, keep, cap = MOE.moe_route(p, cfg.moe,
                                                           x.to(dev))
            out, aux = MOE.moe_apply(p, cfg.moe, x.to(dev))
        res[dev.type] = [t.cpu() for t in (probs, eidx, pos, keep, out)] + [
            float(aux)]
        del p
    (pr_d, e_d, pos_d, k_d, o_d, a_d) = res[device.type]
    (pr_c, e_c, pos_c, k_c, o_c, a_c) = res["cpu"]
    rows = (e_d == e_c).all(-1) & (pos_d == pos_c).all(-1) & (
        k_d == k_c).all(-1)
    ties = []
    for t in torch.nonzero(~(e_d == e_c).all(-1))[:, 0].tolist():
        j = int(torch.nonzero(e_d[t] != e_c[t])[0, 0])
        a, b = int(e_d[t, j]), int(e_c[t, j])
        gap = abs(float(pr_c[t, a]) - float(pr_c[t, b]))
        ties.append({"token": t, "choice": j, "experts": [a, b],
                     "probs_cpu": [float(pr_c[t, a]), float(pr_c[t, b])],
                     "probs_card": [float(pr_d[t, a]), float(pr_d[t, b])],
                     "gap": gap})
        if not gap <= MM_TIE:
            fail(f"5m {cfg.name}: the card routes token {t}'s choice {j} "
                 f"to expert {a}, the CPU to {b}, probabilities "
                 f"{ties[-1]['probs_cpu']} (not a near-tie within {MM_TIE})")
    if not ties and not (bool((pos_d == pos_c).all())
                         and bool((k_d == k_c).all())):
        fail(f"5m {cfg.name}: the card's pos / keep differ from the CPU's "
             f"with equal expert choices")
    scale = float(o_c.abs().max())
    err = float((o_d[rows] - o_c[rows]).abs().max()) if bool(rows.any()) \
        else 0.0
    if not err <= MM_MOE_OUT_REL * scale:
        fail(f"5m {cfg.name}: the MoE layer's output on the card is {err} "
             f"from the CPU's (tolerance {MM_MOE_OUT_REL} x {scale})")
    aux_rel = abs(a_d - a_c) / abs(a_c)
    first_equal = bool((e_d[:, 0] == e_c[:, 0]).all())
    if first_equal and not aux_rel <= MM_MOE_AUX_RTOL:
        fail(f"5m {cfg.name}: the MoE aux loss on the card {a_d} against "
             f"the CPU's {a_c} (relative {aux_rel})")
    return {"tokens": T, "cap": MOE.capacity(cfg.moe, T),
            "routing_equal": not ties, "near_ties": ties,
            "kept_pairs": int(k_c.sum()), "pairs": int(k_c.numel()),
            "out_max_abs_err": err, "out_absmax": scale,
            "out_rel_tol": MM_MOE_OUT_REL, "aux_card": a_d, "aux_cpu": a_c,
            "aux_rel_err": aux_rel}


def mm_serve(device, name: str, layers, cmp: Cmp, rehearse: bool) -> tuple:
    """(a) + (b) for one config: ``ServeEngine``, ``MM_REQUESTS`` requests
    (prompts of 128-1024 tokens, ``default_rng(2)``), ``MM_NEW_TOKENS``
    new tokens each; counts zeroed before, read after: exactly one
    attention launch per layer per prefill, all on ``sm90`` (MoE, D 128;
    MLA, D 96: the tail panel).  Then the kernel held on its path
    (``mm_attention_on_path``), the kernel route against the plain one
    (``mm_routes_and_logits``: for MLA the logits within ``LOGITS_ATOL``),
    and for MoE layer 0's MoE against the CPU; a decode step with 4 live
    slots and the longest prefill timed and traced (``device_time``: the
    card's busy and idle shares, the largest kernels).  Returns (row,
    counts, designs)."""
    from repro_torch.models import transformer as TF
    from repro_torch.serving import Request, ServeEngine
    cfg = mm_config(name, layers, rehearse)
    full_layers = mm_config(name, None, rehearse).n_layers
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    sync(device)
    init_s = time.perf_counter() - t
    n_alloc = sum(p.numel() for p in params.parameters())
    if n_alloc != allocated_params(cfg):
        fail(f"5m {cfg.name}: {n_alloc} parameters allocated, "
             f"{allocated_params(cfg)} reckoned")
    rng = np.random.default_rng(2)
    lo, hi = (8, 64) if rehearse else MM_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, MM_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, L).astype(np.int32) for L in lens]
    eng = ServeEngine(params, cfg, batch=MM_REQUESTS,
                      max_len=hi + MM_NEW_TOKENS, device=device)
    # warm-up (this config's shapes of the library calls): not counted
    eng.run([Request(prompt=prompts[0][:16], max_new_tokens=2)])
    ttft, steps = [], []
    submit, step_all = eng.submit, eng.step_all

    def timed_submit(req):
        sync(device)
        t0 = time.perf_counter()
        ok = submit(req)
        sync(device)
        if ok:
            ttft.append((time.perf_counter() - t0) * 1e3)
        return ok

    def timed_step():
        sync(device)
        t0 = time.perf_counter()
        n = step_all()
        sync(device)
        steps.append((time.perf_counter() - t0) * 1e3)
        return n

    eng.submit, eng.step_all = timed_submit, timed_step
    reqs = [Request(prompt=p, max_new_tokens=MM_NEW_TOKENS) for p in prompts]
    # counts to 0 just before this config's serving path is driven ...
    zero_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    sync(device)
    wall_s = time.perf_counter() - t0
    # ... and read just after
    counts, designs = launch_counts(), attention_designs()
    n_fa = cfg.n_layers * len(reqs)
    route = "sm90"          # a literal: D 128 (MoE) and D 96 (MLA) alike
    if device.type == "cuda":
        want = dict({k: 0 for k in KERNELS}, flash_attention=n_fa)
        if counts != want:
            fail(f"5m {cfg.name}: launches {counts}, expected {want}")
        if designs != dict({"sm90": 0, "fma": 0}, **{route: n_fa}):
            fail(f"5m {cfg.name}: attention launches by design {designs}, "
                 f"expected all {n_fa} on {route}")
    for r in reqs:
        if not r.done or len(r.out_tokens) != MM_NEW_TOKENS or not all(
                0 <= x < cfg.vocab for x in r.out_tokens):
            fail(f"5m {cfg.name}: a request ended with {len(r.out_tokens)} "
                 f"tokens (done={r.done}), or with a token outside the "
                 f"vocabulary")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # where the time goes: a decode step with every slot live, and the
    # longest prompt's prefill, each timed, then traced (as 5d's)
    for p in prompts:
        submit(Request(prompt=p, max_new_tokens=MM_NEW_TOKENS))
    step_all()
    longest = torch.from_numpy(prompts[int(np.argmax(lens))]).to(device)[None]
    with torch.inference_mode():
        breakdown = {"decode_step_4_live": device_time(step_all, device),
                     f"prefill_{int(lens.max())}": device_time(
                         lambda: TF.prefill(params, cfg, longest), device)}
    on_path = mm_attention_on_path(params, cfg, prompts[0], device, cmp)
    vs_plain = mm_routes_and_logits(
        params, cfg, prompts if cfg.attn_type == "mla" else prompts[:1],
        device)
    if cfg.attn_type == "mla" and not (
            vs_plain["logits_max_abs_err_vs_plain"] <= LOGITS_ATOL):
        fail(f"5m {cfg.name}: prefill logits differ by "
             f"{vs_plain['logits_max_abs_err_vs_plain']} between the kernel "
             f"and the plain route (tolerance {LOGITS_ATOL})")
    row = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "cut_from_layers": full_layers if layers else None,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "attention_head_dim": on_path["head_dim"],
           "params": n_alloc, "params_n_params": cfg.n_params(),
           "init_s": init_s, "prompt_lens": [int(x) for x in lens],
           "ttft_ms": ttft, "ttft_ms_p50": statistics.median(ttft),
           "decode_ms_per_step": steps,
           "decode_ms_per_step_p50": statistics.median(steps),
           "wall_s": wall_s, "peak_memory_bytes": int(peak),
           "attention_designs": designs, "attention_on_path": on_path,
           "vs_plain_route": vs_plain, "breakdown": breakdown}
    if cfg.moe:
        row["moe_layer_vs_cpu"] = mm_moe_layer_vs_cpu(params, cfg, device,
                                                      rehearse)
    # the timed methods close over the engine (a cycle): collect it, so
    # the next config's peak does not hold this one's weights
    del eng, params, submit, step_all
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row, counts, designs


def mm_train(device, name: str, rehearse: bool, repeat: bool) -> dict:
    """(c) ``name`` at full width, depth cut to ``MM_TRAIN_LAYERS``,
    through ``launch.train.build_lm``'s pieces and ``train_loop.run``:
    ``MM_TRAIN_STEPS`` steps of ``LM_BATCH`` x ``LM_SEQ`` tokens in
    ``LM_MICROBATCHES`` microbatches, weights from seed 0.  The peak
    reckoned before the run (``lm_memory_reckoning`` of the allocated
    count); losses finite; with ``repeat`` a second run from the same seed
    must give the same bits in the losses and every parameter."""
    from repro_torch import tree
    from repro_torch.data import pipeline as DP
    from repro_torch.launch.analysis import lm_model_flops
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as TF
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import OptimizerConfig
    cfg = mm_config(name, MM_TRAIN_LAYERS, rehearse)
    if rehearse:
        cfg = dataclasses.replace(cfg, remat=True)
    seq = 128 if rehearse else LM_SEQ
    reckoned = lm_memory_reckoning(cfg, LM_BATCH // LM_MICROBATCHES)

    def run():
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        params = TF.init_params(
            torch.Generator(device=device).manual_seed(0), cfg, device,
            trainable=True)
        stamps = [time.perf_counter()]
        params, _, hist = TL.run(
            lambda p, b: TF.train_step_loss(p, cfg, b), params,
            DP.TokenStream(batch=LM_BATCH, seq_len=seq, vocab=cfg.vocab),
            OptimizerConfig(**MM_TRAIN_OPT),
            TL.TrainLoopConfig(total_steps=MM_TRAIN_STEPS,
                               microbatches=LM_MICROBATCHES, log_every=1,
                               ckpt_dir=None),
            to_device=lambda b: to_device(b, device),
            on_metrics=lambda m: stamps.append(time.perf_counter()))
        sync(device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        return params, [h["loss"] for h in hist], ms, peak

    params, losses, ms, peak = run()
    if not all(np.isfinite(losses)):
        fail(f"5m train {cfg.name}: a loss is not finite: {losses}")
    step_ms = median_after_first(ms)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": LM_BATCH, "seq_len": seq, "microbatches": LM_MICROBATCHES,
           "steps": MM_TRAIN_STEPS, "losses": losses, "step_ms": ms,
           "ms_per_step": step_ms,
           "tokens_per_s": LM_BATCH * seq / (step_ms / 1e3),
           "peak_memory_bytes": int(peak), "memory_reckoned_bytes": reckoned,
           **peak_shares(lm_model_flops(cfg, "train", LM_BATCH, seq),
                         step_ms)}
    if repeat:
        again, losses2, ms2, _ = run()
        if losses2 != losses:
            fail(f"5m train {cfg.name}: the second run's losses {losses2} "
                 f"are not the first's {losses} bit for bit")
        for (k, a), b in zip(tree.flatten_with_paths(params),
                             tree.leaves(again)):
            if not torch.equal(a, b):
                fail(f"5m train {cfg.name}: parameter {k} after the second "
                     f"run differs from the first's")
        row.update(repeat_bit_equal=True, repeat_step_ms=ms2)
    del params
    return row


def phase_moe_mla(device, card: str, cmp: Cmp, rehearse: bool) -> tuple:
    """Phase 5m: (a) + (b) the three MoE / MLA configs served at full width
    (``mm_serve``, each freed before the next), (c) two of them trained at
    depth 2 (``mm_train``; no kernel of the port on that path: counts
    zeroed before, read after, all 0).  The phase's seconds against
    ``MM_BUDGET_S``.  Returns (row, serving counts summed over the
    configs, their launches per attention design, training counts)."""
    t0 = time.perf_counter()
    serve, counts_serve = {}, dict.fromkeys(KERNELS, 0)
    designs = {"sm90": 0, "fma": 0}
    for name, layers in MM_SERVE:
        row, counts, des = mm_serve(device, name, layers, cmp, rehearse)
        log("moe_mla", json.dumps({"serve": row, "card": card}))
        serve[name] = row
        counts_serve = {k: counts_serve[k] + counts[k] for k in KERNELS}
        designs = {k: designs[k] + des[k] for k in designs}
    zero_counts()
    train = {name: mm_train(device, name, rehearse,
                            repeat=name == "qwen2-moe-a2.7b")
             for name in MM_TRAIN}
    counts_train = launch_counts()
    if any(counts_train.values()):
        fail(f"5m: the training path launched kernels {counts_train}")
    for name, r in train.items():
        log("moe_mla", json.dumps({"train": r, "card": card}))
    seconds = time.perf_counter() - t0
    row = {"card": card, "serve": serve, "train": train,
           "launches_serve": counts_serve, "attention_designs": designs,
           "launches_train": counts_train, "seconds": seconds,
           "budget_s": MM_BUDGET_S}
    log("moe_mla", f"phase 5m: {seconds} s (budget {MM_BUDGET_S} s: "
                   f"{'within' if seconds <= MM_BUDGET_S else 'PAST'} it)")
    return row, counts_serve, designs, counts_train


# --------------------------------------------------------------------------
# phase 5n: sharded LM serving on a model mesh, the shards sharing the card
# --------------------------------------------------------------------------

SH_KNOBS = dict(decode_write_then_attend=True, decode_seq_axis="model")
SH_DENSE = ("qwen3-32b", 8, (1, 4))        # arch, layers (of 64), mesh
SH_PREFILL_LEN = 4096                      # prefill_32k cut to 1 x 4096
SH_DECODE_STEPS = 8
SH_MOE = ("phi3.5-moe-42b-a6.6b", 8, (2, 2))
SH_MOE_PREFILL = (2, 2048)                 # prefill_32k cut to 2 x 2048
SH_MOE_DECODE = (4, 32_768)                # decode_32k cut to batch 4
SH_MOE_LAYER_TOKENS = 512
SH_MOE_OUT_TOL = 1e-5                      # float32, against |out| max
# B5 launches a sharded prefill makes: 8 layers x 4 shards, all on sm90
SH_PREFILL_LAUNCHES = 32


def timed_call(fn, device):
    """(fn(), its wall ms), bracketed by synchronize()."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t) * 1e3


def peak_reset(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device):
    return (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)


def sh_config(name: str, layers: int, rehearse: bool, moe_ep: bool):
    """(config, cell overrides) of a 5n config: full width, depth cut to
    ``layers``; in the rehearsal the smoke config in bfloat16 (2 layers)."""
    from repro_torch import configs
    arch = configs.get(name)
    base = arch.make_smoke() if rehearse else arch.make_full()
    over = dict(SH_KNOBS, n_layers=2 if rehearse else layers)
    if rehearse:
        over["dtype"] = "bfloat16"
    cfg = dataclasses.replace(base, **over)
    if moe_ep:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axes=("model", "data")))
        over["moe_ep"] = True
    return cfg, over


def sh_sharded_counts(what: str, counts: dict, designs: dict, launch: bool):
    """The sharded prefill's launches: exactly ``SH_PREFILL_LAUNCHES`` B5
    launches, all on sm90, nothing else (fixed here, not read from the
    code under test)."""
    if not launch:
        return
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = SH_PREFILL_LAUNCHES
    if counts != want:
        fail(f"5n {what}: launches {counts}, expected {want}")
    if designs != {"sm90": SH_PREFILL_LAUNCHES, "fma": 0}:
        fail(f"5n {what}: B5 launches by design {designs}, expected all "
             f"{SH_PREFILL_LAUNCHES} on sm90")


def sh_random_cache(cfg, B: int, S: int, device, seed: int) -> dict:
    from repro_torch.models import transformer as TF
    cache = TF.make_empty_cache(cfg, B, S, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for t in cache.values():
        for i in range(t.shape[0]):
            t[i].normal_(generator=gen)
    return cache


def sh_decode(step, tokens, lengths, device) -> tuple:
    """Steps of ``step(token, length)``: (each step's float32 logits, each
    step's wall ms, each step's collectives and gathered bytes)."""
    from repro_torch import obs
    from repro_torch.core import mesh as M
    logits, ms, coll = [], [], []
    for tok, ln in zip(tokens, lengths):
        obs.metrics.reset()
        with torch.no_grad():
            (lg, _), t = timed_call(lambda: step(tok, ln), device)
        logits.append(lg.float())
        ms.append(t)
        coll.append((M.collectives(), M.gathered_bytes()))
    return logits, ms, coll


def sh_dense(device, card: str, rehearse: bool) -> tuple:
    """(a) qwen3-32b at full width, 8 of 64 layers, on a (data 1, model 4)
    mesh whose shards share the card: 16 / 2 heads a shard at D 80.  A
    prefill cell of 1 x 4096 tokens against the unsharded prefill on the
    same weights; the long_500k decode cell (B 1, S 524,288; write then
    attend, the cache sequence-sharded over model) for 8 steps from a
    seeded random cache filled to S - 8, against the unsharded decode on
    the same cache.  Logits within LOGITS_ATOL at every step.  Returns
    (row, the sharded prefill's counts, its designs)."""
    from repro_torch import obs
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells, sharding as SH
    from repro_torch.models import transformer as TF
    name, layers, shape = SH_DENSE
    cfg, over = sh_config(name, layers, rehearse, moe_ep=False)
    launch = device.type == "cuda"
    mesh = M.make_mesh(shape, ("data", "model"), device=device)
    peak_reset(device)
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    rng = np.random.default_rng(11)
    Lp = 64 if rehearse else SH_PREFILL_LEN
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (1, Lp)).astype(
        np.int32)).to(device)
    with torch.no_grad():
        _, cold_u = timed_call(lambda: TF.prefill(params, cfg, tokens),
                               device)
        (lu, _), ttft_u = timed_call(lambda: TF.prefill(params, cfg, tokens),
                                     device)
    peak_u = peak_gb(device)
    cell = cells.build_cell(name, "prefill_32k", mesh, over, batch=1,
                            seq_len=Lp, smoke=rehearse, params=params,
                            inputs={"tokens": tokens})
    placed = cell.args[0]
    peak_reset(device)
    _, cold_s = timed_call(cell.run, device)     # the first call: warm-up
    zero_counts()
    obs.metrics.reset()
    (ls, caches), ttft_s = timed_call(cell.run, device)
    counts, designs = launch_counts(), attention_designs()
    pre_coll = (M.collectives(), M.gathered_bytes())
    peak_s = peak_gb(device)
    sh_sharded_counts(f"{name} prefill", counts, designs, launch)
    err = float((ls.float() - lu.float()).abs().max())
    if not (err <= LOGITS_ATOL and bool(torch.isfinite(ls).all())):
        fail(f"5n {name}: sharded prefill logits {err} from the unsharded "
             f"(tolerance {LOGITS_ATOL})")
    del caches, lu, ls
    split = {"unsharded": profile_split(torch.no_grad()(
        lambda: TF.prefill(params, cfg, tokens)), device)[1],
        "sharded": profile_split(cell.run, device)[1]}
    # decode: the cache placed (a copy) before the unsharded route writes
    # into its own in place
    S = 256 if rehearse else configs_shape("long_500k")["seq_len"]
    steps = SH_DECODE_STEPS
    cache = sh_random_cache(cfg, 1, S, device, seed=1)
    dcell = cells.build_cell(
        name, "long_500k", mesh, over, smoke=rehearse,
        seq_len=S if rehearse else None, params=placed,
        inputs={"cache": cache})
    toks = [torch.from_numpy(rng.integers(1, cfg.vocab, (1,)).astype(
        np.int32)).to(device) for _ in range(steps)]
    lens = [torch.full((1,), S - steps + t, dtype=torch.int32,
                       device=device) for t in range(steps)]
    peak_reset(device)
    u_lg, u_ms, _ = sh_decode(
        lambda t, n: TF.decode_step(params, cfg, t, cache, n), toks, lens,
        device)
    peak_u_dec = peak_gb(device)
    del cache
    peak_reset(device)
    zero_counts()
    s_lg, s_ms, s_coll = sh_decode(
        lambda t, n: dcell.step(dcell.args[0], t, dcell.args[2], n), toks,
        lens, device)
    dec_counts = launch_counts()
    if any(dec_counts.values()):
        fail(f"5n {name}: the sharded decode launched {dec_counts} (its "
             f"attention is plain torch, as the reference's)")
    peak_s_dec = peak_gb(device)
    errs = [float((a - b).abs().max()) for a, b in zip(s_lg, u_lg)]
    if not max(errs) <= LOGITS_ATOL:
        fail(f"5n {name}: sharded decode logits {errs} from the unsharded "
             f"(tolerance {LOGITS_ATOL})")
    row = {"arch": name, "n_layers": cfg.n_layers, "cut_from_layers": 64,
           "mesh": dict(zip(("data", "model"), shape)),
           "heads_per_shard": [cfg.n_heads // shape[1],
                               cfg.n_kv_heads // shape[1]],
           "head_dim": cfg.head_dim, "prefill_tokens": [1, Lp],
           "prefill_notes": cell.static_notes,
           "ttft_ms": {"unsharded": ttft_u, "sharded": ttft_s},
           "first_call_ms": {"unsharded": cold_u, "sharded": cold_s},
           "prefill_peak_gb": {"unsharded": peak_u, "sharded": peak_s},
           "prefill_logits_max_abs_err": err, "logits_tol": LOGITS_ATOL,
           "prefill_collectives": pre_coll[0],
           "prefill_gathered_bytes": pre_coll[1],
           "prefill_launches": counts, "attention_designs": designs,
           "prefill_profile": split,
           "decode_cache": {"B": 1, "S": S, "filled_to": S - steps},
           "decode_notes": dcell.static_notes,
           "decode_ms": {"unsharded": u_ms, "sharded": s_ms,
                         "unsharded_p50": statistics.median(u_ms),
                         "sharded_p50": statistics.median(s_ms)},
           "decode_peak_gb": {"unsharded": peak_u_dec, "sharded": peak_s_dec},
           "decode_logits_max_abs_err": errs,
           "decode_collectives_per_step": s_coll[-1][0],
           "decode_gathered_bytes_per_step": s_coll[-1][1],
           "param_bytes_per_shard": placed.bytes_per_shard(),
           "cache_bytes_per_shard": dcell.args[2].bytes_per_shard(),
           "param_bytes_unsharded": sum(
               p.numel() * p.element_size() for p in params.parameters()),
           "card": card}
    del params, placed, cell, dcell
    peak_reset(device)
    return row, counts, designs


def configs_shape(shape: str) -> dict:
    from repro_torch import configs
    return configs.LM_SHAPES[shape]


def sh_moe_layer(params, cfg, device, rehearse: bool) -> dict:
    """(b) Layer 0's MoE of the served weights in float32 on
    ``SH_MOE_LAYER_TOKENS`` random tokens: ``moe_apply_sharded`` on the
    (2, 2) mesh, the tokens split over data, against the unsharded
    ``moe_apply`` on the card: routing and drops equal as integers (a
    near-tie within MM_TIE excepted and listed), the output within
    SH_MOE_OUT_TOL of the largest |output|."""
    from repro_torch.core import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.models import spmd
    ffn = params.layer_views()[0]["ffn"]
    p32 = {k: ffn[k].detach().float() for k in ffn.keys()
           if isinstance(ffn[k], torch.Tensor)}
    T = 64 if rehearse else SH_MOE_LAYER_TOKENS
    x = torch.randn((T, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).to(device)
    mesh = M.make_mesh(SH_MOE[2], ("data", "model"), device=device)
    D = mesh.shape["data"]
    with torch.no_grad():
        _, _, eidx, pos, keep, cap = MOE.moe_route(p32, cfg.moe, x)
        out_u, _ = MOE.moe_apply(p32, cfg.moe, x)
        placed = SH.place({"layers": {"ffn": {k: v[None] for k, v in
                                              p32.items()}}},
                          mesh, SH.lm_param_spec_tp)
        xs = [x[mesh.group_index(p, "data") * (T // D):][:T // D]
              for p in range(mesh.size)]
        outs, routes = spmd.moe_apply_sharded(placed, cfg.moe, 0, xs,
                                              ("data",))
    rows = [mesh.groups("data")[0]]
    e_s = torch.cat([routes[p][0] for p in rows[0]])
    pos_s = torch.cat([routes[p][1] for p in rows[0]])
    keep_s = torch.cat([routes[p][2] for p in rows[0]])
    out_s = torch.cat([outs[p] for p in rows[0]])
    same = (e_s == eidx).all(-1) & (pos_s == pos).all(-1) & (
        keep_s == keep).all(-1)
    if not bool(same.all()):
        fail(f"5n {cfg.name}: the sharded MoE layer routes "
             f"{int((~same).sum())} of {T} tokens unlike the unsharded")
    scale = float(out_u.abs().max())
    err = float((out_s - out_u).abs().max())
    if not err <= SH_MOE_OUT_TOL * scale:
        fail(f"5n {cfg.name}: the sharded MoE layer's output is {err} from "
             f"the unsharded (tolerance {SH_MOE_OUT_TOL} x {scale})")
    del placed, p32
    return {"tokens": T, "cap": cap, "routing_equal": True,
            "kept_pairs": int(keep.sum()), "pairs": int(keep.numel()),
            "out_max_abs_err": err, "out_absmax": scale,
            "out_tol": SH_MOE_OUT_TOL}


def share(a: list, b: list) -> float:
    """The share of (token, choice) expert picks two routes share, layer by
    layer in running order."""
    if len(a) != len(b):
        fail(f"5n: {len(a)} MoE layers routed against {len(b)}")
    return (sum(int((x == y).sum()) for x, y in zip(a, b))
            / max(sum(y.numel() for y in b), 1))


def sh_moe(device, card: str, rehearse: bool) -> tuple:
    """(b) phi3.5-moe at full width, 8 of 32 layers, on a (data 2, model 2)
    mesh with ``moe_ep`` (8 experts a model shard, the dispatch buffer's
    capacity over data): layer 0's MoE sharded against unsharded
    (``sh_moe_layer``); a prefill cell of 2 x 2048 tokens and a decode cell
    of B 4 against a cache of 32,768 slots (8 steps), each against the
    unsharded route on the same weights — the unsharded route first, then
    the weights placed and the unsharded ones dropped, so the two are not
    held at once.  Logits differences and the share of shared MoE routing
    choices (the routes are bf16 in another order: near-tied top-k may
    flip) printed.  Returns (row, the sharded prefill's counts, its
    designs)."""
    from repro_torch import obs
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells, sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.models import spmd
    from repro_torch.models import transformer as TF
    name, layers, shape = SH_MOE
    cfg, over = sh_config(name, layers, rehearse, moe_ep=True)
    launch = device.type == "cuda"
    mesh = M.make_mesh(shape, ("data", "model"), device=device)
    peak_reset(device)
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    n_params = sum(p.numel() * p.element_size() for p in params.parameters())
    layer = sh_moe_layer(params, cfg, device, rehearse)
    log("sharded", json.dumps({"moe_layer_0": layer, "card": card}))
    rng = np.random.default_rng(12)
    B, Lp = (2, 32) if rehearse else SH_MOE_PREFILL
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, Lp)).astype(
        np.int32)).to(device)
    Bd, S = (4, 256) if rehearse else SH_MOE_DECODE
    steps = SH_DECODE_STEPS
    cache = sh_random_cache(cfg, Bd, S, device, seed=2)
    pc = SH.place(cache, mesh, SH.lm_cache_spec(mesh, "gqa", Bd,
                                                cfg.n_kv_heads))
    toks = [torch.from_numpy(rng.integers(1, cfg.vocab, (Bd,)).astype(
        np.int32)).to(device) for _ in range(steps)]
    start = rng.integers(S // 2, S - steps, Bd)
    lens = [torch.from_numpy((start + t).astype(np.int32)).to(device)
            for t in range(steps)]
    # both routes' expert picks, watched layer by layer under seen[at[0]]
    seen, at = {}, [None]
    route = MOE.moe_route

    def watch(p, c, x):
        r = route(p, c, x)
        seen.setdefault(at[0], []).append(r[2])
        return r

    peak_reset(device)
    with torch.no_grad():
        _, cold_u = timed_call(lambda: TF.prefill(params, cfg, tokens),
                               device)
    MOE.moe_route = watch
    try:
        at[0] = "unsharded_prefill"
        with torch.no_grad():
            (lu, _), ttft_u = timed_call(
                lambda: TF.prefill(params, cfg, tokens), device)
        peak_u = peak_gb(device)
        at[0] = "unsharded_decode"
        u_lg, u_ms, _ = sh_decode(
            lambda t, n: TF.decode_step(params, cfg, t, cache, n), toks,
            lens, device)
    finally:
        MOE.moe_route = route
    peak_u_dec = peak_gb(device)
    del cache
    placed = SH.place(params, mesh, SH.lm_param_spec_tp)
    del params
    peak_reset(device)
    cell = cells.build_cell(name, "prefill_32k", mesh, over, batch=B,
                            seq_len=Lp, smoke=rehearse, params=placed,
                            inputs={"tokens": tokens})
    apply = spmd._moe           # what the sharded route's MoE layers call
    data_row = mesh.groups("data")[0]

    def watch_sharded(*a, **kw):
        outs, routes = apply(*a, **kw)
        seen.setdefault(at[0], []).append(
            torch.cat([routes[p][0] for p in data_row]))
        return outs, routes

    _, cold_s = timed_call(cell.run, device)     # the first call: warm-up
    zero_counts()
    obs.metrics.reset()
    spmd._moe = watch_sharded
    try:
        at[0] = "sharded_prefill"
        (ls, _), ttft_s = timed_call(cell.run, device)
    finally:
        spmd._moe = apply
    counts, designs = launch_counts(), attention_designs()
    pre_coll = (M.collectives(), M.gathered_bytes())
    peak_s = peak_gb(device)
    sh_sharded_counts(f"{name} prefill", counts, designs, launch)
    if not bool(torch.isfinite(ls).all()):
        fail(f"5n {name}: sharded prefill logits are not finite")
    err = float((ls.float() - lu.float()).abs().max())
    split = {"sharded": profile_split(cell.run, device)[1]}
    dcell = cells.build_cell(name, "decode_32k", mesh, over, batch=Bd,
                             seq_len=S if rehearse else None, smoke=rehearse,
                             params=placed, inputs={"cache": pc})
    peak_reset(device)
    zero_counts()
    spmd._moe = watch_sharded
    try:
        at[0] = "sharded_decode"
        s_lg, s_ms, s_coll = sh_decode(
            lambda t, n: dcell.step(placed, t, pc, n), toks, lens, device)
    finally:
        spmd._moe = apply
    dec_counts = launch_counts()
    if any(dec_counts.values()):
        fail(f"5n {name}: the sharded decode launched {dec_counts}")
    if not all(bool(torch.isfinite(lg).all()) for lg in s_lg):
        fail(f"5n {name}: sharded decode logits are not finite")
    peak_s_dec = peak_gb(device)
    errs = [float((a - b).abs().max()) for a, b in zip(s_lg, u_lg)]
    row = {"arch": name, "n_layers": cfg.n_layers, "cut_from_layers": 32,
           "mesh": dict(zip(("data", "model"), shape)),
           "experts_per_model_shard": cfg.moe.e_pad // shape[1],
           "ep_axes": list(cfg.moe.ep_axes), "prefill_tokens": [B, Lp],
           "prefill_notes": cell.static_notes,
           "ttft_ms": {"unsharded": ttft_u, "sharded": ttft_s},
           "prefill_peak_gb": {"unsharded": peak_u, "sharded": peak_s},
           "first_call_ms": {"unsharded": cold_u, "sharded": cold_s},
           "prefill_logits_max_abs_err": err,
           "prefill_routing_share_equal": share(seen["sharded_prefill"],
                                                seen["unsharded_prefill"]),
           "decode_routing_share_equal": share(seen["sharded_decode"],
                                               seen["unsharded_decode"]),
           "prefill_collectives": pre_coll[0],
           "prefill_gathered_bytes": pre_coll[1],
           "prefill_launches": counts, "attention_designs": designs,
           "prefill_profile": split,
           "decode_cache": {"B": Bd, "S": S},
           "decode_notes": dcell.static_notes,
           "decode_ms": {"unsharded": u_ms, "sharded": s_ms,
                         "unsharded_p50": statistics.median(u_ms),
                         "sharded_p50": statistics.median(s_ms)},
           "decode_peak_gb": {"unsharded": peak_u_dec, "sharded": peak_s_dec},
           "decode_logits_max_abs_err": errs,
           "decode_collectives_per_step": s_coll[-1][0],
           "decode_gathered_bytes_per_step": s_coll[-1][1],
           "param_bytes_per_shard": placed.bytes_per_shard(),
           "cache_bytes_per_shard": pc.bytes_per_shard(),
           "param_bytes_unsharded": n_params, "moe_layer_0": layer,
           "card": card}
    del placed, pc, cell, dcell
    peak_reset(device)
    return row, counts, designs


def phase_lm_sharded(device, card: str, rehearse: bool) -> tuple:
    """Phase 5n: the LM served on a model mesh (``launch.cells``), the
    shards sharing the one card: (a) ``sh_dense``, (b) ``sh_moe``.
    Returns (row, the two sharded prefills' counts summed, their B5
    launches by design)."""
    t0 = time.perf_counter()
    dense, c_a, d_a = sh_dense(device, card, rehearse)
    log("sharded", json.dumps({"dense": dense}))
    moe, c_b, d_b = sh_moe(device, card, rehearse)
    log("sharded", json.dumps({"moe": moe}))
    counts = {k: c_a[k] + c_b[k] for k in KERNELS}
    designs = {k: d_a[k] + d_b[k] for k in d_a}
    row = {"card": card, "dense": dense, "moe": moe, "launches": counts,
           "attention_designs": designs,
           "seconds": time.perf_counter() - t0}
    log("sharded", f"phase 5n: {row['seconds']:.1f} s")
    return row, counts, designs


# --------------------------------------------------------------------------
# phase 5o: LM training on the model mesh, the shards sharing the card
# --------------------------------------------------------------------------

TM_MESH = (2, 2)                           # (data, model)
TM_DENSE = "qwen3-1.7b"                    # full width, all 28 layers
TM_DENSE_KNOBS = dict(fsdp_inner=True, act_shard=True)
# train_4k cut to 4 x 4096 in 2 microbatches: one 4096-token row a data
# row a microbatch, the tokens of 5k (a)'s 2 x 4096 microbatch
TM_BATCH, TM_SEQ, TM_MICRO, TM_STEPS = 4, 4096, 2, 2
# the unsharded route takes the same batch in 4 one-row microbatches, 5k
# (a)'s shape (58.03 GB peak): every row has the same 4096 labels, so the
# mean loss and its gradient are those of 2 microbatches of 2 rows
TM_UNSHARDED_MICRO = 4
TM_LOSS_ATOL, TM_GNORM_REL = 0.05, 0.05    # step 1, bfloat16
TM_MOE = ("qwen2-moe-a2.7b", 2)            # full width, depth cut (5m c)
TM_MOE_TOKENS = (2, 2048)
TM_MOE_LOSS_ATOL, TM_MOE_GNORM_REL = 0.1, 0.10
TM_F32 = ("qwen3-1.7b", 2)                 # full width, depth cut, float32
TM_F32_TOKENS = (4, 1024)
TM_F32_TOL = dict(loss_rel=1e-4, gnorm_rel=1e-3, moment_rel=1e-3,
                  update_rel=1e-2)
TM_ALL_KNOBS = dict(fsdp_inner=True, act_shard=True, remat=True)
TM_BUDGET_S = 120.0                        # the phase's share of the limit


def tm_setup(name: str, layers, over: dict, tokens: tuple, device,
             rehearse: bool, seed: int) -> tuple:
    """(config, cell overrides, weights, batch) of a 5o run: ``name`` at
    full width, depth cut to ``layers`` (None: all), the knobs ``over``;
    random weights from ``torch.Generator`` seed 0 (trainable, for the
    unsharded route), tokens and labels drawn from ``seed``.  In the
    rehearsal the smoke config, 2 layers, 32 tokens a row."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    arch = configs.get(name)
    base = arch.make_smoke() if rehearse else arch.make_full()
    over = dict(over)
    if rehearse:
        over.setdefault("dtype", "bfloat16")
        over.update(n_layers=2, remat=True)
    elif layers is not None:
        over["n_layers"] = layers
    cfg = dataclasses.replace(base, **{k: v for k, v in over.items()
                                      if k not in ("moe_ep", "microbatches")})
    if over.get("moe_ep"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axes=("model", "data")))
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device, trainable=True)
    B, L = (tokens[0], 32) if rehearse else tokens
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, (B, L)).astype(
        np.int32)).to(device) for k in ("tokens", "labels")}
    return cfg, over, params, batch


def tm_unsharded(cfg, params, batch, micro: int, device) -> tuple:
    """One step of the unsharded route (``train_loop.make_train_step``,
    the cell's ``OPT``) on ``params`` (trained in place): (metrics as
    floats, the new moments by path, wall ms, peak GB)."""
    from repro_torch import tree
    from repro_torch.launch import cells
    from repro_torch.models import transformer as TF
    from repro_torch.training import optimizer as OP
    from repro_torch.training import train_loop as TL
    step = TL.make_train_step(lambda p, b: TF.train_step_loss(p, cfg, b),
                              cells.OPT, micro)
    peak_reset(device)
    (_, st, m), ms = timed_call(
        lambda: step(params, OP.init_opt_state(params), batch), device)
    moments = {k: dict(tree.flatten_with_paths(st[k])) for k in ("mu", "nu")}
    return {k: float(v) for k, v in m.items()}, moments, ms, peak_gb(device)


def profile_split(fn, device) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` (in the caller's grad
    mode): ``(fn's output, {wall ms (the call, not the profiler's
    teardown), the device's busy ms and idle share, its kernel time split
    into attention (B5's ``flash_fwd`` kernels), matrix products
    (GEMM-named kernels), copies (on one card the collectives: stacks, cats
    and copies) and the rest, the six longest kernels})``.  On the card
    only device activity is traced and its raw events are summed: a
    sharded train step makes about 10^5 host ops and as many kernels, whose
    event tree ``key_averages`` takes over a minute to build.  The span
    from the first kernel's start to the last one's end is held against
    CUDA events recorded around the call (``span_ratio``): a trace whose
    clock is off by more than 10 % (seen once: kernel times at 0.47 of
    their length) is marked ``timestamps_ok`` false, its times not a
    measurement.  In the rehearsal the CPU ops' self time stands in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    sync(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        if cuda:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
        out = fn()
        if cuda:
            marks[1].record()
        sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    rows, check = {}, {}
    if cuda:
        first, last = float("inf"), float("-inf")
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                r = rows.setdefault(e.name(), [0.0, 0])
                r[0] += e.duration_ns() / 1e6
                r[1] += 1
                first, last = min(first, e.start_ns()), max(last, e.end_ns())
        event_ms = marks[0].elapsed_time(marks[1])
        span = (last - first) / 1e6 if rows else None
        ratio = span / event_ms if span is not None and event_ms else None
        check = {"kernel_span_ms": span, "cuda_event_ms": event_ms,
                 "span_ratio": ratio,
                 "timestamps_ok": ratio is not None and abs(1 - ratio) <= 0.1}
        if not check["timestamps_ok"]:
            log("profile", f"the trace's kernel span is {ratio} of the CUDA "
                f"events' {event_ms} ms: its times are not a measurement")
    else:
        rows = {e.key: [e.self_cpu_time_total / 1e3, e.count]
                for e in prof.key_averages()
                if e.device_type == DeviceType.CPU}
    ms = dict.fromkeys(("attention", "matmul", "copy", "rest"), 0.0)
    for name, (t, _) in rows.items():
        key = ("attention" if "flash_fwd" in name
               else "matmul" if GEMM_KERNEL.search(name)
               else "copy" if re.search(r"copy|memcpy|cat|stack", name,
                                        re.IGNORECASE)
               else "rest")
        ms[key] += t
    busy = sum(ms.values())
    return out, {"wall_ms": wall, "device_busy_ms": busy,
                 "idle_share": 1 - busy / wall if wall else None, "ms": ms,
                 "top": sorted(([n[:80], t, c] for n, (t, c)
                                in rows.items()), key=lambda r: -r[1])[:6],
                 "post_processing_s": time.perf_counter() - t1, **check,
                 "what": "device kernel time" if cuda
                 else "CPU op time (rehearsal)"}


def tm_check(what: str, sharded: dict, unsharded: dict, loss_atol=None,
             loss_rel=None, gnorm_rel=None) -> dict:
    """Step 1's loss and gradient norm, sharded against unsharded."""
    dl = abs(sharded["loss"] - unsharded["loss"])
    dg = abs(sharded["grad_norm"] - unsharded["grad_norm"]) / abs(
        unsharded["grad_norm"])
    if not all(np.isfinite([sharded["loss"], sharded["grad_norm"]])):
        fail(f"{what}: a loss or gradient norm is not finite: {sharded}")
    if loss_atol is not None and not dl <= loss_atol:
        fail(f"{what}: loss {sharded['loss']} against the unsharded "
             f"{unsharded['loss']}: {dl} > {loss_atol}")
    if loss_rel is not None and not dl <= loss_rel * abs(unsharded["loss"]):
        fail(f"{what}: loss {sharded['loss']} against the unsharded "
             f"{unsharded['loss']}: relative {dl / abs(unsharded['loss'])} "
             f"> {loss_rel}")
    if not dg <= gnorm_rel:
        fail(f"{what}: grad_norm {sharded['grad_norm']} against the "
             f"unsharded {unsharded['grad_norm']}: relative {dg} > "
             f"{gnorm_rel}")
    if sharded["lr"] != unsharded["lr"]:
        fail(f"{what}: lr {sharded['lr']} against {unsharded['lr']}")
    return {"loss_abs_diff": dl, "grad_norm_rel_diff": dg}


def tm_metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def tm_dense(device, card: str, rehearse: bool) -> dict:
    """(a) qwen3-1.7b at full width, all 28 layers, bfloat16, on (data 2,
    model 2) with fsdp_inner and act_shard (remat as the config has it):
    the train_4k cell cut to 4 x 4096 in 2 microbatches, two steps (the
    second profiled, ``profile_split``), then the unsharded route on the
    same weights and batch, after the cell is freed.  Step 1 within
    TM_LOSS_ATOL / TM_GNORM_REL; ms a step, peak GB, per-shard bytes,
    collectives and gathered bytes a step (remat's recompute included)."""
    from repro_torch import obs
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    over = dict(TM_DENSE_KNOBS, microbatches=TM_MICRO)
    mesh = M.make_mesh(TM_MESH, ("data", "model"), device=device)
    peak_reset(device)
    cfg, over, params, batch = tm_setup(TM_DENSE, None, over,
                                        (TM_BATCH, TM_SEQ), device, rehearse,
                                        seed=20)
    n_params = allocated_params(cfg)
    reckoned = {"params": n_params, "bf16_storage_gb": 2 * n_params / 1e9,
                "f32_moments_gb": 8 * n_params / 1e9,
                "f32_accumulators_gb": 4 * n_params / 1e9,
                "bf16_unsharded_copy_held_gb": 2 * n_params / 1e9}
    log("mesh_train", json.dumps({"dense_reckoned": reckoned}))
    cell = cells.build_cell(TM_DENSE, "train_4k", mesh, over,
                            batch=TM_BATCH, seq_len=batch["tokens"].shape[1],
                            smoke=rehearse, params=params, inputs=batch)
    placed = cell.args[0]
    w_bytes = placed.bytes_per_shard()
    steps, ms, coll = [], [], []
    for i in range(TM_STEPS):
        obs.metrics.reset()
        if i == TM_STEPS - 1:
            out, prof = profile_split(cell.run, device)
            t = prof["wall_ms"]
        else:
            out, t = timed_call(cell.run, device)
        steps.append(tm_metrics(out[2]))
        ms.append(t)
        coll.append((M.collectives(), M.gathered_bytes()))
    m_bytes = [a + b for a, b in zip(cell.args[1]["mu"].bytes_per_shard(),
                                     cell.args[1]["nu"].bytes_per_shard())]
    peak_s = peak_gb(device)
    del cell, placed, out
    un, _, un_ms, peak_u = tm_unsharded(cfg, params, batch,
                                        TM_UNSHARDED_MICRO, device)
    del params, batch
    diff = tm_check("5o dense", steps[0], un, loss_atol=TM_LOSS_ATOL,
                    gnorm_rel=TM_GNORM_REL)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "mesh": dict(zip(("data", "model"), TM_MESH)),
            "knobs": {k: getattr(cfg, k) for k in
                      ("fsdp_inner", "act_shard", "remat", "flash_bwd")},
            "batch": [TM_BATCH, TM_SEQ], "microbatches": TM_MICRO,
            "unsharded_microbatches": TM_UNSHARDED_MICRO,
            "steps": steps, "unsharded_step_1": un, "step_1_diff": diff,
            "step_ms": ms, "step_2_profiled": True,
            "unsharded_step_ms": un_ms,
            "tokens_per_s_step_1": TM_BATCH * TM_SEQ / (ms[0] / 1e3),
            "peak_gb": {"sharded": peak_s, "unsharded": peak_u},
            "weight_bytes_per_shard": w_bytes,
            "moment_bytes_per_shard": m_bytes,
            "collectives_per_step": [c[0] for c in coll],
            "gathered_bytes_per_step": [c[1] for c in coll],
            "step_2_profile": prof, "memory_reckoned": reckoned,
            "card": card}


def tm_moe(device, card: str, rehearse: bool) -> dict:
    """(b) qwen2-moe-a2.7b at full width, depth cut to 2, on (2, 2) with
    moe_ep (the whole tree moved to the compute layout at step start): one
    step of 2 x 2048 tokens against the unsharded route, within
    TM_MOE_LOSS_ATOL / TM_MOE_GNORM_REL (bfloat16 routing in another
    order: a near-tied top-k may flip)."""
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    name, layers = TM_MOE
    mesh = M.make_mesh(TM_MESH, ("data", "model"), device=device)
    peak_reset(device)
    cfg, over, params, batch = tm_setup(name, layers, {"moe_ep": True},
                                        TM_MOE_TOKENS, device, rehearse,
                                        seed=21)
    cell = cells.build_cell(name, "train_4k", mesh, over,
                            batch=batch["tokens"].shape[0],
                            seq_len=batch["tokens"].shape[1], smoke=rehearse,
                            params=params, inputs=batch)
    out, ms = timed_call(cell.run, device)
    sharded = tm_metrics(out[2])
    peak_s = peak_gb(device)
    del cell, out
    un, _, un_ms, peak_u = tm_unsharded(cfg, params, batch, 1, device)
    del params, batch
    diff = tm_check("5o moe", sharded, un, loss_atol=TM_MOE_LOSS_ATOL,
                    gnorm_rel=TM_MOE_GNORM_REL)
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "ep_axes": list(cfg.moe.ep_axes), "tokens": list(TM_MOE_TOKENS),
            "sharded": sharded, "unsharded": un, "diff": diff,
            "step_ms": {"sharded": ms, "unsharded": un_ms},
            "peak_gb": {"sharded": peak_s, "unsharded": peak_u},
            "card": card}


def tm_f32(device, card: str, rehearse: bool) -> dict:
    """(c) qwen3-1.7b at full width, depth cut to 2, float32, on (2, 2)
    with fsdp_inner, act_shard, remat and 2 microbatches: one step against
    the unsharded route on the card, loss and gradient norm within
    TM_F32_TOL, every moment leaf within ``moment_rel`` of its largest
    magnitude, and every parameter leaf's update (the new stored blocks
    against the unsharded route's new leaf, over the norm of that route's
    change) within ``update_rel``."""
    from repro_torch import tree
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    name, layers = TM_F32
    mesh = M.make_mesh(TM_MESH, ("data", "model"), device=device)
    peak_reset(device)
    cfg, over, params, batch = tm_setup(
        name, layers, dict(TM_ALL_KNOBS, dtype="float32",
                           microbatches=TM_MICRO), TM_F32_TOKENS, device,
        rehearse, seed=22)
    cell = cells.build_cell(name, "train_4k", mesh, over,
                            batch=batch["tokens"].shape[0],
                            seq_len=batch["tokens"].shape[1], smoke=rehearse,
                            params=params, inputs=batch)
    out, ms = timed_call(cell.run, device)
    sharded = tm_metrics(out[2])
    moments = {k: {p: out[1][k].gather(p) for p in out[1][k].shapes}
               for k in ("mu", "nu")}
    with torch.no_grad():
        new = {p: out[0].gather(p) for p in out[0].shapes}
        old = {p: x.detach().clone()
               for p, x in tree.flatten_with_paths(params)}
    del cell, out
    un, un_mom, un_ms, _ = tm_unsharded(cfg, params, batch, TM_MICRO, device)
    upd_worst = 0.0
    tol = TM_F32_TOL
    with torch.no_grad():
        for p, want in tree.flatten_with_paths(params):
            moved = float(torch.linalg.vector_norm(want - old[p]))
            err = float(torch.linalg.vector_norm(new[p] - want))
            if not (moved > 0 and err <= tol["update_rel"] * moved):
                fail(f"5o float32: {p}'s update is {err} from the unsharded "
                     f"route's, which moved it by {moved}")
            upd_worst = max(upd_worst, err / moved)
    del params, batch, new, old
    diff = tm_check("5o float32", sharded, un, loss_rel=tol["loss_rel"],
                    gnorm_rel=tol["gnorm_rel"])
    worst = {}
    for k in ("mu", "nu"):
        for p, want in un_mom[k].items():
            scale = float(want.abs().max())
            err = float((moments[k][p] - want).abs().max())
            if not err <= tol["moment_rel"] * scale:
                fail(f"5o float32: {k} {p} is {err} from the unsharded "
                     f"route's, past {tol['moment_rel']} x {scale}")
            worst[k] = max(worst.get(k, 0.0), err / scale if scale else 0.0)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "knobs": TM_ALL_KNOBS, "microbatches": TM_MICRO,
            "tokens": list(TM_F32_TOKENS), "sharded": sharded,
            "unsharded": un, "diff": diff,
            "moment_worst_rel_to_max": worst,
            "update_worst_rel_to_moved": upd_worst,
            "step_ms": {"sharded": ms, "unsharded": un_ms}, "card": card}


def phase_lm_train_mesh(device, card: str, rehearse: bool) -> tuple:
    """Phase 5o: LM training on a model mesh (``launch.cells``' train
    cell), the shards sharing the one card: (a) ``tm_dense``, (b)
    ``tm_moe``, (c) ``tm_f32``.  No kernel launches on this path (the
    training route's attention is ``chunked_attention``; B5 is forward
    only).  Returns (row, the launch counts)."""
    t0 = time.perf_counter()
    zero_counts()
    dense = tm_dense(device, card, rehearse)
    log("mesh_train", json.dumps({"dense": dense}))
    moe = tm_moe(device, card, rehearse)
    log("mesh_train", json.dumps({"moe": moe}))
    f32 = tm_f32(device, card, rehearse)
    log("mesh_train", json.dumps({"float32": f32}))
    counts = launch_counts()
    if any(counts.values()):
        fail(f"5o: the mesh training path launched kernels {counts}")
    peak_reset(device)
    seconds = time.perf_counter() - t0
    row = {"card": card, "dense": dense, "moe": moe, "float32": f32,
           "launches": counts, "seconds": seconds, "budget_s": TM_BUDGET_S}
    log("mesh_train", f"phase 5o: {seconds:.1f} s (budget {TM_BUDGET_S} s: "
                      f"{'within' if seconds <= TM_BUDGET_S else 'PAST'} it)")
    return row, counts


# --------------------------------------------------------------------------
# phase 5p: MLA and the GNN / recsys cells on the model mesh
# --------------------------------------------------------------------------

MC_MLA = ("minicpm3-4b", (1, 4))           # full width, all 62 layers
MC_PREFILL_LEN = 4096                      # prefill_32k cut to 1 x 4096
# B5 launches the sharded MLA prefill makes: 62 layers x 4 shards, all on
# sm90, 10 / 10 heads a shard at D 96 (fixed here, not read from the code)
MC_PREFILL_LAUNCHES = 248
# the bfloat16 long_500k decode at 62 layers: the unsharded route against
# itself with the other decode knob (append, the same function) moved the
# logits by up to 0.277 > LOGITS_ATOL (H100 80GB HBM3, 700 W), so the
# sharded route is held to MC_NOISE_FACTOR x that distance, measured in the
# same run, and, in float32 at full width with the cache cut to
# MC_F32_SLOTS, to MC_F32_LOGITS_ATOL (measured 2.7e-5 to 3.7e-5)
MC_NOISE_FACTOR = 2.0
MC_F32_SLOTS = 65_536
MC_F32_LOGITS_ATOL = 1e-3
MC_TRAIN = ("minicpm3-4b", 2, (2, 2))      # depth cut to 2, (data, model)
MC_TRAIN_TOKENS = (2, 2048)
MC_TRAIN_KNOBS = dict(fsdp_inner=True, act_shard=True)
MC_RECSYS_MESH = (1, 4)
MC_RECSYS_TOL = dict(loss_rel=1e-4, gnorm_rel=1e-3, out=1e-5)   # float32
MC_GNN_MESH = (2, 2)
MC_GNN = (("gat-cora", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
          ("gatedgcn", "full_graph_sm"), ("nequip", "molecule"))
MC_HALO_MESH = (1, 4)
MC_GNN_TOL = dict(loss_rel=1e-4, gnorm_rel=1e-3)                 # float32
MC_BUDGET_S = 100.0                        # the phase's share of the limit


def mc_counts_zero(what: str):
    """The counts since they were zeroed: none (plain torch paths)."""
    counts = launch_counts()
    if any(counts.values()):
        fail(f"5p {what}: launched kernels {counts}")


def mc_mla(device, card: str, cmp: Cmp, rehearse: bool) -> tuple:
    """(a) minicpm3-4b at full width, all 62 layers, bf16, random weights
    from seed 0, on (data 1, model 4): 10 / 10 heads a shard at D 96.  The
    memory is reckoned first (weights unsharded and placed, the latent cache
    twice while it is placed) against the card's.  A prefill cell of 1 x
    4096 tokens: its warm-up run watches shard 0's first B5 launch and
    holds it to the plain attention on its own q, k, v (FA_TOL, ROW_TOL);
    the counted run makes exactly MC_PREFILL_LAUNCHES B5 launches, all
    sm90; logits within LOGITS_ATOL of the unsharded prefill.  The
    long_500k decode cell (B 1, S 524,288, write then attend, the latents
    sequence-sharded over model) for 8 steps from a seeded random cache,
    the sharded route first; its cache freed before the unsharded route's
    is made again from the seed; then the unsharded route once more with
    the other decode knob (append: the same function, other roundings),
    whose distance from the first is the bfloat16 noise floor of 62
    layers; every sharded step within the larger of LOGITS_ATOL and
    MC_NOISE_FACTOR x that floor.  Then the same decode cell in float32
    at full width, the cache cut to MC_F32_SLOTS, against the unsharded
    route within MC_F32_LOGITS_ATOL at every step.  Returns (row, the
    sharded prefill's counts, its designs)."""
    from repro_torch import configs, obs
    from repro_torch.core import mesh as M
    from repro_torch.kernels import ref
    from repro_torch.launch import cells
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    name, shape = MC_MLA
    full_layers = configs.get(name).make_full().n_layers
    cfg, over = sh_config(name, full_layers, rehearse, moe_ep=False)
    launch = device.type == "cuda"
    mesh = M.make_mesh(shape, ("data", "model"), device=device)
    S = 256 if rehearse else configs_shape("long_500k")["seq_len"]
    m = cfg.mla
    w_bytes = 2 * allocated_params(cfg)
    cache_bytes = 2 * cfg.n_layers * S * (m.kv_lora_rank + m.qk_rope_dim)
    # the unsharded weights, a placed copy of them, and the cache twice
    # while the decode cell places it
    reckoned = {"weights_gb": w_bytes / 1e9,
                "placed_weights_gb_at_most": w_bytes / 1e9,
                "cache_gb": cache_bytes / 1e9,
                "peak_gb_reckoned": (2 * w_bytes + 2 * cache_bytes) / 1e9}
    log("mesh_cells", json.dumps({"mla_reckoned": reckoned}))
    if launch:
        total = torch.cuda.get_device_properties(device).total_memory
        if 2 * w_bytes + 2 * cache_bytes > 0.9 * total:
            fail(f"5p {name}: {reckoned} does not fit {total / 1e9} GB")
    peak_reset(device)
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    rng = np.random.default_rng(13)
    Lp = 64 if rehearse else MC_PREFILL_LEN
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (1, Lp)).astype(
        np.int32)).to(device)
    with torch.no_grad():
        _, cold_u = timed_call(lambda: TF.prefill(params, cfg, tokens),
                               device)
        (lu, _), ttft_u = timed_call(lambda: TF.prefill(params, cfg, tokens),
                                     device)
    peak_u = peak_gb(device)
    cell = cells.build_cell(name, "prefill_32k", mesh, over, batch=1,
                            seq_len=Lp, smoke=rehearse, params=params,
                            inputs={"tokens": tokens})
    placed = cell.args[0]
    orig, seen = L.prefill_attention, []

    def watched(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if not seen:
            seen.append((q, k, v, out, kw["causal"]))
        return out

    peak_reset(device)
    L.prefill_attention = watched
    try:        # the first call, a warm-up: shard 0's layer-0 launch kept
        _, cold_s = timed_call(cell.run, device)
    finally:
        L.prefill_attention = orig
    q, k, v, out, causal = seen[0]
    label = (f"5p {name} shard 0 layer 0 Hq{q.shape[1]} Hkv{k.shape[1]} "
             f"L{q.shape[2]} D{q.shape[3]}")
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    cmp.close("flash_attention", label, out, want, *FA_TOL[q.dtype])
    cmp.rows("flash_attention", label, out, want, ROW_TOL[q.dtype])
    shard_check = {"heads": [q.shape[1], k.shape[1]], "L": q.shape[2],
                   "D": q.shape[3], "dtype": str(q.dtype)[6:],
                   "max_abs_err": float((out.float() - want.float()).abs()
                                        .max())}
    if not rehearse and shard_check["heads"] != [m.n_heads // shape[1]] * 2:
        fail(f"5p {name}: a shard's attention ran {shard_check['heads']} "
             f"heads, expected {m.n_heads // shape[1]} / "
             f"{m.n_heads // shape[1]}")
    del seen, q, k, v, out, want
    zero_counts()
    obs.metrics.reset()
    (ls, caches), ttft_s = timed_call(cell.run, device)
    counts, designs = launch_counts(), attention_designs()
    pre_coll = (M.collectives(), M.gathered_bytes())
    peak_s = peak_gb(device)
    if launch:
        want_counts = dict.fromkeys(KERNELS, 0)
        want_counts["flash_attention"] = (8 if rehearse
                                          else MC_PREFILL_LAUNCHES)
        if counts != want_counts:
            fail(f"5p {name} prefill: launches {counts}, expected "
                 f"{want_counts}")
        if designs != {"sm90": want_counts["flash_attention"], "fma": 0}:
            fail(f"5p {name} prefill: B5 launches by design {designs}, "
                 f"expected all {want_counts['flash_attention']} on sm90")
    err = float((ls.float() - lu.float()).abs().max())
    if not (err <= LOGITS_ATOL and bool(torch.isfinite(ls).all())):
        fail(f"5p {name}: sharded prefill logits {err} from the unsharded "
             f"(tolerance {LOGITS_ATOL})")
    cache_spec = {k: list(s) for k, s in caches.specs.items()}
    del caches, lu, ls
    # decode: the sharded route first, from a seeded cache it places (a
    # copy); the cache freed, then made again for the unsharded route
    steps = SH_DECODE_STEPS
    cache = sh_random_cache(cfg, 1, S, device, seed=3)
    dcell = cells.build_cell(
        name, "long_500k", mesh, over, smoke=rehearse,
        seq_len=S if rehearse else None, params=placed,
        inputs={"cache": cache})
    del cache
    toks = [torch.from_numpy(rng.integers(1, cfg.vocab, (1,)).astype(
        np.int32)).to(device) for _ in range(steps)]
    lens = [torch.full((1,), S - steps + t, dtype=torch.int32,
                       device=device) for t in range(steps)]
    peak_reset(device)
    zero_counts()
    s_lg, s_ms, s_coll = sh_decode(
        lambda t, n: dcell.step(dcell.args[0], t, dcell.args[2], n), toks,
        lens, device)
    mc_counts_zero(f"{name} sharded decode")
    peak_s_dec = peak_gb(device)
    cache_shard_bytes = dcell.args[2].bytes_per_shard()
    seq_axes = list(dcell.args[2].split("['c_kv']", 2))
    decode_notes = dcell.static_notes
    del dcell
    peak_reset(device)
    cache = sh_random_cache(cfg, 1, S, device, seed=3)
    u_lg, u_ms, _ = sh_decode(
        lambda t, n: TF.decode_step(params, cfg, t, cache, n), toks, lens,
        device)
    peak_u_dec = peak_gb(device)
    del cache
    cache = sh_random_cache(cfg, 1, S, device, seed=3)
    append = dataclasses.replace(cfg, decode_write_then_attend=False)
    a_lg, _, _ = sh_decode(
        lambda t, n: TF.decode_step(params, append, t, cache, n), toks, lens,
        device)
    del cache
    floor = [float((a - b).abs().max()) for a, b in zip(a_lg, u_lg)]
    tol = max(LOGITS_ATOL, MC_NOISE_FACTOR * max(floor))
    errs = [float((a - b).abs().max()) for a, b in zip(s_lg, u_lg)]
    if not (max(errs) <= tol
            and all(bool(torch.isfinite(x).all()) for x in s_lg)):
        fail(f"5p {name}: sharded decode logits {errs} from the unsharded "
             f"(tolerance {tol}: the unsharded route's append decode is "
             f"{floor} from its write-then-attend one)")
    row = {"arch": name, "n_layers": cfg.n_layers,
           "mesh": dict(zip(("data", "model"), shape)),
           "heads_per_shard": shard_check["heads"],
           "head_dim": m.qk_nope_dim + m.qk_rope_dim,
           "prefill_tokens": [1, Lp], "prefill_notes": cell.static_notes,
           "ttft_ms": {"unsharded": ttft_u, "sharded": ttft_s},
           "first_call_ms": {"unsharded": cold_u, "sharded": cold_s},
           "prefill_peak_gb": {"unsharded": peak_u, "sharded": peak_s},
           "prefill_logits_max_abs_err": err, "logits_tol": LOGITS_ATOL,
           "shard_attention_vs_plain": shard_check,
           "prefill_collectives": pre_coll[0],
           "prefill_gathered_bytes": pre_coll[1],
           "prefill_launches": counts, "attention_designs": designs,
           "prefill_cache_specs": cache_spec,
           "decode_cache": {"B": 1, "S": S, "filled_to": S - steps,
                            "seq_axes": seq_axes},
           "decode_notes": decode_notes,
           "decode_ms": {"unsharded": u_ms, "sharded": s_ms,
                         "unsharded_p50": statistics.median(u_ms),
                         "sharded_p50": statistics.median(s_ms)},
           "decode_peak_gb": {"unsharded": peak_u_dec, "sharded": peak_s_dec},
           "decode_logits_max_abs_err": errs,
           "decode_noise_floor": floor, "decode_logits_tol": tol,
           "decode_collectives_per_step": s_coll[-1][0],
           "decode_gathered_bytes_per_step": s_coll[-1][1],
           "param_bytes_per_shard": placed.bytes_per_shard(),
           "cache_bytes_per_shard": cache_shard_bytes,
           "param_bytes_unsharded": sum(
               p.numel() * p.element_size() for p in params.parameters()),
           "memory_reckoned": reckoned, "card": card}
    del params, placed, cell
    peak_reset(device)
    row["float32_decode"] = mc_mla_f32(device, name, mesh, over, toks,
                                       rehearse)
    return row, counts, designs


def mc_mla_f32(device, name: str, mesh, over: dict, toks: list,
               rehearse: bool) -> dict:
    """(a)'s decode cell in float32 at full width (62 layers), the cache
    cut to MC_F32_SLOTS, 8 steps against the unsharded route on the same
    weights and seeded cache, each within MC_F32_LOGITS_ATOL."""
    from repro_torch.launch import cells
    from repro_torch.models import transformer as TF
    over = dict(over, dtype="float32")
    cfg, _ = sh_config(name, over["n_layers"], rehearse, moe_ep=False)
    cfg = dataclasses.replace(cfg, dtype="float32")
    S = 64 if rehearse else MC_F32_SLOTS
    steps = len(toks)
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    cache = sh_random_cache(cfg, 1, S, device, seed=3)
    dcell = cells.build_cell(name, "long_500k", mesh, over, smoke=rehearse,
                             seq_len=S, params=params,
                             inputs={"cache": cache})
    del cache
    lens = [torch.full((1,), S - steps + t, dtype=torch.int32,
                       device=device) for t in range(steps)]
    zero_counts()
    s_lg, s_ms, _ = sh_decode(
        lambda t, n: dcell.step(dcell.args[0], t, dcell.args[2], n), toks,
        lens, device)
    mc_counts_zero(f"{name} float32 sharded decode")
    notes = dcell.static_notes
    del dcell
    cache = sh_random_cache(cfg, 1, S, device, seed=3)
    u_lg, u_ms, _ = sh_decode(
        lambda t, n: TF.decode_step(params, cfg, t, cache, n), toks, lens,
        device)
    del cache, params
    errs = [float((a - b).abs().max()) for a, b in zip(s_lg, u_lg)]
    if not max(errs) <= MC_F32_LOGITS_ATOL:
        fail(f"5p {name} float32: sharded decode logits {errs} from the "
             f"unsharded (tolerance {MC_F32_LOGITS_ATOL})")
    peak = peak_gb(device)
    peak_reset(device)
    return {"dtype": "float32", "S": S, "notes": notes,
            "logits_max_abs_err": errs, "tol": MC_F32_LOGITS_ATOL,
            "logits_absmax": float(u_lg[0].abs().max()),
            "decode_ms": {"unsharded": u_ms, "sharded": s_ms},
            "peak_gb": peak}


def mc_train(device, card: str, rehearse: bool) -> dict:
    """(b) minicpm3-4b's train cell at full width, depth cut to 2, bf16, on
    (data 2, model 2) with fsdp_inner and act_shard: one step of 2 x 2048
    tokens, then the unsharded route on the same weights and batch after
    the cell is freed: loss within TM_LOSS_ATOL, grad_norm within
    TM_GNORM_REL; counts zeroed before, none launched."""
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    name, layers, shape = MC_TRAIN
    mesh = M.make_mesh(shape, ("data", "model"), device=device)
    peak_reset(device)
    cfg, over, params, batch = tm_setup(name, layers, MC_TRAIN_KNOBS,
                                        MC_TRAIN_TOKENS, device, rehearse,
                                        seed=23)
    cell = cells.build_cell(name, "train_4k", mesh, over,
                            batch=batch["tokens"].shape[0],
                            seq_len=batch["tokens"].shape[1], smoke=rehearse,
                            params=params, inputs=batch)
    zero_counts()
    out, ms = timed_call(cell.run, device)
    mc_counts_zero(f"{name} train cell")
    sharded = tm_metrics(out[2])
    peak_s = peak_gb(device)
    del cell, out
    un, _, un_ms, peak_u = tm_unsharded(cfg, params, batch, 1, device)
    del params, batch
    diff = tm_check(f"5p {name} train", sharded, un, loss_atol=TM_LOSS_ATOL,
                    gnorm_rel=TM_GNORM_REL)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "mesh": dict(zip(("data", "model"), shape)),
            "knobs": {k: getattr(cfg, k) for k in
                      ("fsdp_inner", "act_shard", "remat")},
            "tokens": list(MC_TRAIN_TOKENS), "sharded": sharded,
            "unsharded": un, "diff": diff,
            "step_ms": {"sharded": ms, "unsharded": un_ms},
            "peak_gb": {"sharded": peak_s, "unsharded": peak_u},
            "card": card}


def mc_rel(what: str, got: float, want: float, tol: float) -> float:
    rel = abs(got - want) / max(abs(want), 1e-30)
    if not (np.isfinite(got) and rel <= tol):
        fail(f"5p {what}: {got} against the unsharded {want}: relative "
             f"{rel} > {tol}")
    return rel


def mc_recsys(device, card: str, rehearse: bool) -> dict:
    """(c) dcn-v2 uncut (26 tables of 1,000,000 x 16, float32) on (data 1,
    model 4), the tables row-sharded over model: serve_p99's probabilities
    and retrieval_cand's 1,000,000 candidates (made on the card, unit rows)
    against the unsharded route on the same weights (MC_RECSYS_TOL's
    ``out``), the top 100 ids equal to a host sort of the scores; then one
    train_batch step of 65,536 examples against the unsharded route's
    (train_loop.make_train_step, the cells' OPT), loss and grad_norm within
    MC_RECSYS_TOL; per-shard table bytes; counts zeroed before each sharded
    step, none launched."""
    from repro_torch import configs
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    from repro_torch.models import recsys as RS
    from repro_torch.training import optimizer as OP
    from repro_torch.training import train_loop as TL
    arch = configs.get("dcn-v2")
    cfg = arch.make_smoke() if rehearse else arch.make_full()
    tol = MC_RECSYS_TOL
    mesh = M.make_mesh(MC_RECSYS_MESH, ("data", "model"), device=device)
    peak_reset(device)
    params = RS.dcnv2_init(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    out = {"mesh": dict(zip(("data", "model"), MC_RECSYS_MESH)),
           "card": card}
    # serve_p99
    cut = {"batch": 64} if rehearse else {}
    cell = cells.build_cell("dcn-v2", "serve_p99", mesh, smoke=rehearse,
                            params=params, sizes=cut)
    b = {k: cell.args[1].gather(f"[{k!r}]") for k in ("dense", "sparse")}
    zero_counts()
    probs, ms = timed_call(cell.run, device)
    mc_counts_zero("dcn-v2 serve")
    with torch.no_grad():
        want, ms_u = timed_call(lambda: RS.predict(params, cfg, b), device)
    err = float((probs - want).abs().max())
    if not err <= tol["out"]:
        fail(f"5p dcn-v2 serve: probabilities {err} from the unsharded")
    tables = [sum(t.numel() * t.element_size() for t in sh["tables"])
              for sh in cell.args[0].shards]
    out["serve_p99"] = {"batch": probs.shape[0], "max_abs_err": err,
                        "ms": {"sharded": ms, "unsharded": ms_u}}
    out["table_bytes_per_shard"] = tables
    out["table_bytes_unsharded"] = sum(t.numel() * t.element_size()
                                       for t in params["tables"])
    del cell
    # retrieval_cand: the candidates made on the card
    NC = 8192 if rehearse else configs.common.RECSYS_SHAPES[
        "retrieval_cand"]["n_candidates"]
    gen = torch.Generator(device=device).manual_seed(7)
    cand = torch.randn((NC, cfg.mlp_dims[-1]), generator=gen, device=device)
    cand = cand / torch.linalg.vector_norm(cand, dim=1, keepdim=True)
    cell = cells.build_cell("dcn-v2", "retrieval_cand", mesh, smoke=rehearse,
                            params=params, sizes={"n_candidates": NC},
                            inputs={"cand": cand})
    zero_counts()
    (scores, top_v, top_i), ms = timed_call(cell.run, device)
    mc_counts_zero("dcn-v2 retrieval")
    d, s = cell.args[1].gather(""), cell.args[2].gather("")
    with torch.no_grad():
        (su, _, iu), ms_u = timed_call(lambda: RS.retrieval_scores(
            params, cfg, d, s, cand, top_k=RETRIEVAL_TOP_K), device)
    host = scores.cpu().numpy()
    order = np.argsort(-host, kind="stable")[:RETRIEVAL_TOP_K]
    if not np.array_equal(top_i.cpu().numpy(), order):
        fail("5p dcn-v2 retrieval: the merged top-100 is not a host sort "
             "of the scores")
    s_err = float((scores - su).abs().max())
    if not s_err <= tol["out"]:
        fail(f"5p dcn-v2 retrieval: scores {s_err} from the unsharded")
    out["retrieval_cand"] = {
        "n_candidates": NC, "top_k": RETRIEVAL_TOP_K,
        "top_k_equals_host_sort": True,
        "top_k_ids_equal_unsharded": bool(torch.equal(top_i, iu)),
        "scores_max_abs_err": s_err,
        "ms": {"sharded": ms, "unsharded": ms_u}}
    del cell, cand, scores, su
    # train_batch: the sharded step on the cell's copies, then the
    # unsharded one on the weights in place
    cut = {"batch": 64} if rehearse else {}
    cell = cells.build_cell("dcn-v2", "train_batch", mesh, smoke=rehearse,
                            params=params, sizes=cut)
    batch = {k: cell.args[2].gather(f"[{k!r}]")
             for k in ("dense", "sparse", "labels")}
    zero_counts()
    res, ms = timed_call(cell.run, device)
    mc_counts_zero("dcn-v2 train cell")
    sharded = tm_metrics(res[2])
    peak_s = peak_gb(device)
    del cell, res
    step = TL.make_train_step(lambda p, bt: RS.ctr_loss(p, cfg, bt),
                              cells.OPT, 1)
    (_, _, m), ms_u = timed_call(
        lambda: step(params, OP.init_opt_state(params), batch), device)
    un = tm_metrics(m)
    out["train_batch"] = {
        "batch": batch["labels"].shape[0], "sharded": sharded,
        "unsharded": un,
        "loss_rel_diff": mc_rel("dcn-v2 train loss", sharded["loss"],
                                un["loss"], tol["loss_rel"]),
        "grad_norm_rel_diff": mc_rel("dcn-v2 train grad_norm",
                                     sharded["grad_norm"], un["grad_norm"],
                                     tol["gnorm_rel"]),
        "ms": {"sharded": ms, "unsharded": ms_u},
        "peak_gb_sharded": peak_s}
    del params, batch
    peak_reset(device)
    return out


def mc_gnn(device, card: str, rehearse: bool) -> dict:
    """(d) gat-cora, meshgraphnet and gatedgcn at full width on
    full_graph_sm and nequip on molecule, each on (data 2, model 2), edges
    split over the mesh: one step of the cell against the unsharded route
    (gnn.gnn_loss_fn on the cell's batch, train_loop.make_train_step, the
    cells' OPT) on the same weights, loss and grad_norm within MC_GNN_TOL;
    the halo GatedGCN cell on (data 1, model 4) against the replicated
    loss and gradient norm on the partition's relabeled graph (HALO_REL,
    HALO_NORM_REL); counts zeroed before each sharded step, none
    launched."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    from repro_torch.models import gnn as G
    from repro_torch.training import optimizer as OP
    from repro_torch.training import train_loop as TL
    tol = MC_GNN_TOL
    mesh = M.make_mesh(MC_GNN_MESH, ("data", "model"), device=device)
    rows = {}
    small = {"full_graph_sm": {"n_nodes": 200, "n_edges": 800,
                               "d_feat": 16},
             "molecule": {"batch": 4}}
    for arch, shape in MC_GNN:
        arch_def = configs.get(arch)
        sizes = small[shape] if rehearse else {}
        shp = dict(GNN_SHAPES[shape], **sizes)
        model = arch_def.extras["model"]
        cfg = cells._gnn_config(arch_def, shp, rehearse)
        params = cells._gnn_init(model, cfg, device)
        cell = cells.build_cell(arch, shape, mesh, smoke=rehearse,
                                sizes=sizes, params=params)
        b = cell.args[2]
        batch = {p[2:-2]: b.gather(p) for p in b.shapes}
        zero_counts()
        res, ms = timed_call(cell.run, device)
        mc_counts_zero(f"{arch} train cell")
        sharded = tm_metrics(res[2])
        del cell, res
        loss_fn = G.gnn_loss_fn(arch_def, shp, cfg,
                                batch["feats"].shape[0])
        step = TL.make_train_step(loss_fn, cells.OPT, 1)
        (_, _, m), ms_u = timed_call(
            lambda: step(params, OP.init_opt_state(params), batch), device)
        un = tm_metrics(m)
        rows[arch] = {
            "shape": shape, "nodes": batch["feats"].shape[0],
            "edges": batch["src"].shape[0], "sharded": sharded,
            "unsharded": un,
            "loss_rel_diff": mc_rel(f"{arch} loss", sharded["loss"],
                                    un["loss"], tol["loss_rel"]),
            "grad_norm_rel_diff": mc_rel(f"{arch} grad_norm",
                                         sharded["grad_norm"],
                                         un["grad_norm"], tol["gnorm_rel"]),
            "ms": {"sharded": ms, "unsharded": ms_u}}
        del params, batch
    # the halo GatedGCN on (1, 4): a graph drawn here, its replicated form
    # from the same plan
    shp = dict(GNN_SHAPES["full_graph_sm"],
               **(small["full_graph_sm"] if rehearse else {}))
    n, E = shp["n_nodes"], shp["n_edges"]
    rng = np.random.default_rng(8)
    arrays = {"src": rng.integers(0, n, E), "dst": rng.integers(0, n, E),
              "feats": rng.standard_normal((n, shp["d_feat"])).astype(
                  np.float32),
              "labels": rng.integers(0, shp["n_classes"], n).astype(
                  np.int32),
              "train_mask": (rng.random(n) < 0.5).astype(np.float32)}
    hmesh = M.make_mesh(MC_HALO_MESH, ("data", "model"), device=device)
    cfg = cells._gnn_config(configs.get("gatedgcn"), shp, rehearse)
    params = cells._gnn_init("gatedgcn", cfg, device)
    cell = cells.build_cell("gatedgcn", "full_graph_sm", hmesh,
                            {"halo": True}, smoke=rehearse,
                            sizes=small["full_graph_sm"] if rehearse else {},
                            params=params, inputs=arrays)
    zero_counts()
    res, ms = timed_call(cell.run, device)
    mc_counts_zero("halo gatedgcn cell")
    halo = tm_metrics(res[2])
    notes = cell.static_notes
    del cell, res
    part, plan, _, rep = cells.halo_batch(*(arrays[k] for k in (
        "src", "dst", "feats", "labels", "train_mask")), n, hmesh.size)
    src, dst, feats, labels, mask = (torch.from_numpy(x).to(device)
                                     for x in rep)
    loss = G.node_classification_loss(G.gatedgcn_apply(
        params, cfg, feats, src, dst, part.n_pad), labels, mask)
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True, materialize_grads=True)
    gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    lr_ = float(loss.detach())
    if not abs(halo["loss"] - lr_) <= HALO_REL * abs(lr_):
        fail(f"5p halo: loss {halo['loss']} against the replicated {lr_}")
    if not abs(halo["grad_norm"] - gnorm) <= HALO_NORM_REL * gnorm:
        fail(f"5p halo: grad_norm {halo['grad_norm']} against the "
             f"replicated {gnorm}")
    rows["halo_gatedgcn"] = {
        "mesh": dict(zip(("data", "model"), MC_HALO_MESH)), "nodes": n,
        "edges_symmetric": int(part.graph.n_edges), "n_loc": part.n_loc,
        "max_boundary": int(plan.n_boundary.max()), "notes": notes,
        "sharded": halo, "replicated_loss": lr_,
        "replicated_grad_norm": gnorm, "ms": ms}
    del params
    return {"mesh": dict(zip(("data", "model"), MC_GNN_MESH)),
            "models": rows, "card": card}


def phase_mesh_cells(device, card: str, cmp: Cmp, rehearse: bool) -> tuple:
    """Phase 5p: MLA and the GNN / recsys cells on the model mesh
    (``launch.cells``), the shards sharing the one card: (a) ``mc_mla``,
    (b) ``mc_train``, (c) ``mc_recsys``, (d) ``mc_gnn``.  Returns (row, the
    sharded MLA prefill's counts, its B5 launches by design, the counts of
    (b)-(d), all 0)."""
    t0 = time.perf_counter()
    mla, counts, designs = mc_mla(device, card, cmp, rehearse)
    log("mesh_cells", json.dumps({"mla_serve": mla}))
    zero_counts()
    train = mc_train(device, card, rehearse)
    log("mesh_cells", json.dumps({"mla_train": train}))
    recsys = mc_recsys(device, card, rehearse)
    log("mesh_cells", json.dumps({"recsys": recsys}))
    gnn = mc_gnn(device, card, rehearse)
    log("mesh_cells", json.dumps({"gnn": gnn}))
    others = launch_counts()
    peak_reset(device)
    seconds = time.perf_counter() - t0
    row = {"card": card, "mla_serve": mla, "mla_train": train,
           "recsys": recsys, "gnn": gnn, "prefill_launches": counts,
           "attention_designs": designs, "other_launches": others,
           "seconds": seconds, "budget_s": MC_BUDGET_S}
    log("mesh_cells", f"phase 5p: {seconds:.1f} s (budget {MC_BUDGET_S} s: "
                      f"{'within' if seconds <= MC_BUDGET_S else 'PAST'} it)")
    return row, counts, designs, others


def exact_launch_counts(what: str, res):
    """The launch checks are exact for one cap attempt: a run that doubled
    its cap ran earlier attempts whose round counts the result does not
    carry, so its launches cannot be checked exactly and the run fails.
    (Every graph here is seeded and needs no retry at the default cap.)"""
    if res.retries:
        fail(f"{what}: {res.retries} cap-doubling retries; the launch counts "
             f"of the earlier attempts cannot be checked exactly")


def launch_counters() -> dict:
    """Kernel name -> its wrapper, whose ``.launches`` counts launches."""
    from repro_torch.kernels.detect_recolor import detect_recolor
    from repro_torch.kernels.ell_spmm import ell_spmm
    from repro_torch.kernels.firstfit import firstfit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.twohop import twohop_detect_recolor
    return {"firstfit": firstfit, "detect_recolor": detect_recolor,
            "twohop_detect_recolor": twohop_detect_recolor,
            "flash_attention": flash_attention, "ell_spmm": ell_spmm}


def launch_counts() -> dict:
    return {k: w.launches for k, w in launch_counters().items()}


def detect_only_counts() -> dict:
    """Launches of B2's detect-only form since the counts were zeroed, in
    all and per design (``detect_recolor.launches_detect[_<design>]``)."""
    dr = launch_counters()["detect_recolor"]
    return {"launches": dr.launches_detect,
            **{d: getattr(dr, f"launches_detect_{d}")
               for d in DESIGNS["detect_recolor"]}}


def slot_counts() -> dict:
    """Launches of B2's slot-stride form since the counts were zeroed, in
    all and per design (``detect_recolor.launches_slots[_<design>]``)."""
    dr = launch_counters()["detect_recolor"]
    return {"launches": dr.launches_slots,
            **{d: getattr(dr, f"launches_slots_{d}")
               for d in DESIGNS["detect_recolor"]}}


def sm90_ptxas(build_log: str, lib) -> list:
    """``ptxas -v`` of each variant of the attention kernel's sm90 design
    (``flash_fwd_sm90<D, CAUSAL>``): registers, spill stores / loads as
    ptxas printed them, and the dynamic shared memory a CTA asks for (the
    kernel's own ``Layout<D>::kBytes``, through the library)."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            v = re.search(r"flash_fwd_sm90ILi(\d+)ELb([01])E", m.group(1))
            cur = None
            if v:
                D, causal = int(v.group(1)), v.group(2)
                cur = {"D": D, "causal": causal == "1",
                       "smem_bytes": lib.attn_flash_sm90_smem(D)}
                rows.append(cur)
        elif cur is not None and "spill" in line:
            cur["spills"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["ptxas"] = line.split(":", 1)[-1].strip()
    return rows


# the kernels with more than one design, and each one's designs (a wrapper
# counts a design's launches in ``launches_<design>``)
DESIGNS = {"firstfit": ("vec16", "direct"),
           "detect_recolor": ("vec16", "direct"),
           "twohop_detect_recolor": ("staged16", "staged4", "direct"),
           "flash_attention": ("sm90", "fma")}


# The staged pass's shapes phase 2 reports shared memory and resident groups
# at: the main path's widest tiles (RMAT-B's W 512 for the repair pass,
# RMAT-ER's W 44 for the two-hop pass).
STAGED_REPORT_W = {1: 512, 2: 44}


def staged_shape(lib, hops: int, design: int, lanes: int, W: int):
    """(threads a block, dynamic shared memory a block, resident groups) of
    a staged-pass launch, from the library (``coloring_staged_shape``); None
    for a shape the design does not take."""
    import ctypes
    out = (ctypes.c_longlong * 3)()
    err = lib.coloring_staged_shape(hops, design, lanes, W, out)
    return None if err else tuple(out)


def staged_ptxas(build_log: str, lib) -> list:
    """``ptxas -v`` of each variant of the staged pass
    (``coloring::staged::pass<G, VEC, HOPS>``: the repair pass and
    the two-hop staged designs): registers, spill stores / loads as ptxas
    printed them, and the launch shape at ``STAGED_REPORT_W``."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            v = re.search(r"staged4passILi(\d+)ELi(\d+)ELi(\d+)EE",
                          m.group(1))
            cur = None
            if v:
                G, vec, hops = (int(x) for x in v.groups())
                design = ("vec16" if hops == 1 else
                          "staged16" if vec == 4 else "staged4")
                W = STAGED_REPORT_W[hops]
                # the C ids: B2's vec16 is 0, B3's staged16 / staged4 1 / 2
                shape = staged_shape(lib, hops, 0 if hops == 1 else
                                     (1 if vec == 4 else 2), G, W)
                cur = {"kernel": ("detect_recolor, firstfit" if hops == 1
                                  else "twohop_detect_recolor"),
                       "design": design, "lanes": G, "at_W": W, "threads": shape and shape[0],
                       "smem_bytes": shape and shape[1],
                       "resident_groups": shape and shape[2]}
                rows.append(cur)
        elif cur is not None and "spill" in line:
            cur["spills"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["ptxas"] = line.split(":", 1)[-1].strip()
    return rows


# kernel -> the mangled-name pattern of its variants, for the ptxas summary
# of phase 2 (B1: the direct design's firstfit_kernel and the staged pass
# it shares with B2; B4: every (dtype, lanes, vector) variant)
PTXAS_VARIANTS = {"firstfit direct": r"firstfit_kernelILi",
                  "firstfit / detect_recolor vec16":
                      r"staged4passILi\d+ELi4ELi1EE",
                  "ell_spmm": r"ell_spmm_kernelI"}


def ptxas_summary(build_log: str) -> dict:
    """Per ``PTXAS_VARIANTS`` entry: its variants, their register range and
    how many spill, from ``ptxas -v``."""
    out = {k: {"variants": 0, "registers": [], "spilling": 0}
           for k in PTXAS_VARIANTS}
    cur = None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = next((k for k, pat in PTXAS_VARIANTS.items()
                        if re.search(pat, m.group(1))), None)
            if cur:
                out[cur]["variants"] += 1
        elif cur and "spill" in line and "0 bytes spill stores, 0 bytes " \
                "spill loads" not in line:
            out[cur]["spilling"] += 1
        elif cur and "Used" in line:
            out[cur]["registers"].append(
                int(re.search(r"Used (\d+) registers", line).group(1)))
    for v in out.values():
        r = v.pop("registers")
        v["registers"] = [min(r), max(r)] if r else None
    return out


def zero_counts():
    """Every wrapper's count to 0, the per-design counts and B2's
    detect-only counts too."""
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    for k, designs in DESIGNS.items():
        for d in designs:
            setattr(wrappers[k], f"launches_{d}", 0)
    dr = wrappers["detect_recolor"]
    for form in ("detect", "slots"):
        setattr(dr, f"launches_{form}", 0)
        for d in DESIGNS["detect_recolor"]:
            setattr(dr, f"launches_{form}_{d}", 0)


def design_counts() -> dict:
    """kernel -> design -> launches since the counts were zeroed."""
    wrappers = launch_counters()
    return {k: {d: getattr(wrappers[k], f"launches_{d}") for d in designs}
            for k, designs in DESIGNS.items()}


def design_delta(before: dict, after: dict, counts: dict, what: str) -> dict:
    """Launches per design between two ``design_counts``, for the kernels
    that launched; fails unless they add up to the kernel's launches
    (``counts``: kernel -> launches over the same span)."""
    out = {}
    for k, designs in after.items():
        d = {x: after[k][x] - before[k][x] for x in designs}
        if sum(d.values()) != counts.get(k, 0):
            fail(f"{what}: {k} launched {counts.get(k, 0)} times but its "
                 f"designs count {d}")
        if counts.get(k, 0):
            out[k] = {x: v for x, v in d.items() if v}
    return out


def attention_designs() -> dict:
    """Launches of each attention design since the counts were zeroed."""
    return design_counts()["flash_attention"]


# --------------------------------------------------------------------------
# phase 5q: the dry run against the card; the four examples on the card
# --------------------------------------------------------------------------

DR_PREFILL_LEN = 4096     # qwen3-1.7b prefill_32k cut to 1 x 4096
DR_PEAK_BAND = (0.75, 1.33)   # dry-run peak / the allocator's rise
DR_TRAIN_STEPS = 10           # train_lm's 100M config on the card


def dr_cell(device, arch, shape, dm, rehearse: bool, **cut):
    """One cell dry-run on a meta mesh of shape ``dm``, then built on the
    card and run once under the counter (and, on (1, 1), the allocator's
    peak over that step), then once more without the counter, timed.
    Returns the cell's row; fails on any disagreement in FLOPs,
    collectives or B5 calls."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import cells as CELLS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.cost import count_step
    axes = ("data", "model")
    over = {"n_layers": 2} if rehearse and arch.startswith("qwen") else None
    t0 = time.perf_counter()
    dry = DR.run_cell(arch, shape, False, verbose=False, overrides=over,
                      mesh=make_mesh(dm, axes, device="meta"), smoke=rehearse,
                      **cut)
    t_dry = time.perf_counter() - t0
    mesh = make_mesh(dm, axes, device=device)
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
    cell = CELLS.build_cell(arch, shape, mesh, overrides=over, smoke=rehearse,
                            **cut)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = FA.flash_attention.launches
    _, cost = count_step(lambda *_: cell.run(), cell.args, mesh)
    sync(device)
    b5 = FA.flash_attention.launches - before
    rise = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else None)
    label = f"{arch} {shape} {dm[0]}x{dm[1]}"
    card_an = AN.analyze(cost, mesh.size)
    got = {"flops": cost["flops"]["total"],
           "collectives": card_an["collectives"],
           "b5": b5 if device.type == "cuda" else
           cost["kernels"].get("flash_attention", {}).get("calls", 0)}
    want = {"flops": dry["flops"]["total"], "collectives": dry["collectives"],
            "b5": dry["kernels"].get("flash_attention", {}).get("calls", 0)}
    if device.type == "cuda" and got != want:
        fail(f"5q {label}: the card's step counted {got}, the dry run "
             f"{want}")
    # the step's wall without the counter (its Python dispatch slows a
    # step, so the counted run is not timed)
    sync(device)
    t = time.perf_counter()
    cell.run()
    sync(device)
    wall = time.perf_counter() - t
    row = {"cell": label, "cut": cut, "static_notes": dry["static_notes"],
           "flops": want["flops"], "collectives_total_count":
           want["collectives"]["total_count"], "collectives_total_bytes":
           want["collectives"]["total_bytes"], "b5_calls": want["b5"],
           "b5_launches_on_card": got["b5"], "ops": dry["ops"],
           "t_bound_s": max(dry["roofline"]["t_compute_s"],
                            dry["roofline"]["t_memory_s"],
                            dry["roofline"]["t_collective_s"]),
           "bottleneck": dry["roofline"]["bottleneck"],
           "step_wall_s": wall, "dry_run_s": round(t_dry, 2),
           "peak_bytes_per_device": dry["memory"]["peak_bytes_per_device"]}
    if rise is not None and dm == (1, 1):
        ratio = dry["memory"]["peak_bytes_per_device"] / rise
        row.update(allocator_rise_bytes=rise, peak_ratio=ratio,
                   peak_band=DR_PEAK_BAND)
        if not DR_PEAK_BAND[0] <= ratio <= DR_PEAK_BAND[1]:
            fail(f"5q {label}: the dry run's peak "
                 f"{dry['memory']['peak_bytes_per_device']} B is "
                 f"{ratio:.3f} of the allocator's rise {rise} B, outside "
                 f"{DR_PEAK_BAND}")
    del cell
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def dr_examples(device, rehearse: bool) -> tuple:
    """Phase 5q (b): the four examples on the card, the counts zeroed
    before each and read after.  Returns (row, per example its launches)."""
    from repro_torch.examples import (color_then_train_gnn, quickstart,
                                      serve_lm, train_lm)
    dev = str(device)
    runs = {
        "quickstart": lambda: quickstart.main(
            ["--device", dev] + (["--side", "6"] if rehearse else [])),
        "serve_lm": lambda: serve_lm.main(["--device", dev]),
        "train_lm": lambda: train_lm.main(
            ["--device", dev, "--steps", str(DR_TRAIN_STEPS),
             "--log-every", "1"] + (["--tiny"] if rehearse else [])),
        "color_then_train_gnn": lambda: color_then_train_gnn.main(
            ["--device", dev] + (["--side", "12", "--steps", "11"]
                                 if rehearse else [])),
    }
    row, counts = {}, {}
    for name, fn in runs.items():
        zero_counts()
        sync(device)
        t = time.perf_counter()
        out = fn()
        sync(device)
        secs = time.perf_counter() - t
        c = launch_counts()
        counts[name] = c
        row[name] = {"seconds": round(secs, 2), "launches": c,
                     "slot_stride_launches": slot_counts()["launches"]}
        if name == "quickstart":
            row[name].update(rsoc_colors=out["rsoc"]["n_colors"],
                             distance2_colors=out["distance2"]["n_colors"],
                             replay_equal=out["replay_equal"],
                             tenant2_healed=out["tenant2"]["healed"])
            if not (out["replay_equal"] and out["tenant2"]["healed"]):
                fail(f"5q quickstart: {row[name]}")
        elif name == "serve_lm":
            row[name]["tokens"] = out["tokens"]
            if out["tokens"] <= 0:
                fail("5q serve_lm: no token was served")
        elif name == "train_lm":
            row[name].update(first_loss=out["first_loss"],
                             last_loss=out["last_loss"])
            if not out["last_loss"] < out["first_loss"]:
                fail(f"5q train_lm: the loss did not fall: {row[name]}")
        else:
            row[name].update(losses=out["losses"],
                             deterministic=out["deterministic"])
            if not out["deterministic"] or not (
                    out["losses"][max(out["losses"])] < out["losses"][0]):
                fail(f"5q color_then_train_gnn: {row[name]}")
        log("dryrun", json.dumps({name: row[name]}))
    if device.type == "cuda":
        need = {"firstfit": ("quickstart", "color_then_train_gnn"),
                "detect_recolor": ("quickstart", "color_then_train_gnn"),
                "twohop_detect_recolor": ("quickstart",),
                "flash_attention": ("serve_lm",)}
        for k, names in need.items():
            for n in names:
                if not counts[n][k]:
                    fail(f"5q {n} launched no {k} (counts {counts[n]})")
        if not row["quickstart"]["slot_stride_launches"]:
            fail("5q quickstart: the service's megabatched step launched "
                 "no slot-stride B2")
    return row, counts


def phase_dryrun(device, card: str, rehearse: bool) -> tuple:
    """Phase 5q: (a) the dry run (``launch/dryrun.py`` on meta) against the
    card: ``qwen3-1.7b`` ``prefill_32k`` cut to 1 x ``DR_PREFILL_LEN`` at
    full width on (1, 1) and on 5n's (1, 4), ``gatedgcn``
    ``full_graph_sm`` train on (2, 2); FLOPs, collectives (kind, count,
    bytes) and B5's calls equal exactly, on (1, 1) the dry run's peak
    within ``DR_PEAK_BAND`` of the allocator's rise over the step (from
    before the cell was built), and ``t_bound`` beside the step's wall
    (timed in a run without the counter); (b) the four examples on the
    card (``dr_examples``).  Returns (row, (a)'s counts, (b)'s counts)."""
    t0 = time.perf_counter()
    L = 64 if rehearse else DR_PREFILL_LEN
    cells = []
    zero_counts()
    for dm in ((1, 1), (1, 4)):
        cells.append(dr_cell(device, "qwen3-1.7b", "prefill_32k", dm,
                             rehearse, batch=1, seq_len=L))
        log("dryrun", json.dumps(cells[-1]))
    cells.append(dr_cell(device, "gatedgcn", "full_graph_sm", (2, 2),
                         rehearse))
    log("dryrun", json.dumps(cells[-1]))
    counts = launch_counts()
    t_a = time.perf_counter() - t0
    ex, ex_counts = dr_examples(device, rehearse)
    row = {"cells": cells, "examples": ex, "seconds_a": round(t_a, 2),
           "seconds_b": round(time.perf_counter() - t0 - t_a, 2),
           "card": card,
           "note": "t_bound_s: the dry run's bound from the H100 SXM data "
                   "sheet (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s NVLink); "
                   "bytes are eager unfused traffic"}
    log("dryrun", json.dumps({k: v for k, v in row.items()
                              if k not in ("cells", "examples")}))
    return row, counts, ex_counts


# --------------------------------------------------------------------------
# phase 5r: train cells on a mesh whose positions sit on different devices
# --------------------------------------------------------------------------

TD_MESH = (1, 2)                           # (data, model), a device each
# the one cross-device mesh of a one-card host: one position on the card
# and one on its host, asked for by name (a route under test, not a
# fallback: every copy of a replicated block, its gradient's all-reduce and
# its update cross the PCIe bus)
TD_DEVICES = ("cuda:0", "cpu")
TD_STEPS = 2
# (a) dcn-v2's train_batch at full width: the host position holds half of
# every table (13M rows x 16) and its moments and updates them on the
# host's cores.  That update, not the batch, sets the host position's
# step: 3.9-5.5 s at 16,384-65,536 rows (H100 80GB HBM3, 700.00 W, its
# host's 8 cores), so the batch is not cut
TD_RECSYS_BATCH = 65_536
# (b) the smoke qwen3-1.7b (fsdp_inner, act_shard, remat, 2
# microbatches): remat puts one checkpoint frame across the card's and the
# host's positions, which the backward recomputes.  At full width it does
# not fit the phase's budget: td_lm(full=True), at TD_LM_FULL's cut (1
# layer, 2 x 64 tokens, float32), takes 4.5-6.2 s a step on this mesh
# (H100 80GB HBM3, 700.00 W, its host's 8 cores), and as long at 2 layers
# or 4 x 128 tokens: the host position's update of half the 151,936 x 2048
# embedding and its moments, as (a)'s is of half the tables.  gatedgcn at
# full width on full_graph_sm (Cora: 16 layers, d_hidden 70, 2,708
# nodes), as 5p (d) runs it
TD_LM = ("qwen3-1.7b", dict(fsdp_inner=True, act_shard=True, remat=True,
                            microbatches=2), (4, 64))
# in float32: in the config's bfloat16 a step's update (lr 3e-6 at warmup)
# is below the weights' rounding, and no leaf would move for the updates'
# check to see
TD_LM_FULL = dict(n_layers=1, dtype="float32", tokens=(2, 64))
TD_GNN = ("gatedgcn", "full_graph_sm")
# float32 on a card and on its host: products and sums round differently.
# The leaves are held by norms.  The moments are linear in the gradient.
# The update is Adam's, which divides a gradient by its own size plus eps
# (1e-8): an element whose gradient is near eps (a unit that barely fires)
# turns a rounding difference into a share of its step (dcn-v2's
# mlp_b[0] came 0.028 apart, a moment 2.3e-3, at 16,384 rows on H100 80GB
# HBM3, 700.00 W).  Planted faults read 0.94-1.47 at the worst leaf's
# update and 0.71-1.24 at its moments in every cell of (a) and (b), on the
# same card: a set that skips the sum over its copies, and every copy
# updated on its own gradient (before replica sets)
TD_TOL = dict(loss_rel=1e-4, gnorm_rel=1e-3, update_rel=0.1,
              moment_rel=1e-2)
TD_BUDGET_S = 30.0                         # the phase's share of the limit
# planted in (b)'s cells, each must trip the all-reduce count and the
# update or moment limit: each set's first copy keeps its own gradient (no
# sum over the copies); every copy is a set of its own (updated on its own
# gradient, as before replica sets)
TD_FAULTS = ("no_sum", "own_sets")
_td_tripped = None      # while td_faults plants a fault: the limits tripped


def td_fail(limit: str, msg: str):
    """``fail``; while ``td_faults`` plants a fault, a tripped ``limit``
    noted instead."""
    if _td_tripped is None:
        fail(msg)
    _td_tripped.append((limit, msg))


def td_faults(what: str, run) -> dict:
    """``run()`` (one cell's ``td_pair``) under each of ``TD_FAULTS``,
    planted in ``launch.sharding``: per fault the limits it trips (with
    their counts), the worst readings and the loss and grad_norm relative
    to the one-card cell a step.  Fails unless each trips the all-reduce
    count and the update or moment limit."""
    global _td_tripped
    from repro_torch.launch import sharding as SH
    planted = {
        "no_sum": ("reduce_replicas", lambda mesh, sets, grads: [
            grads[copies[0][1]] for _, copies in sets]),
        "own_sets": ("replica_sets", lambda placed: [
            (path, ((0, i),)) for i, (path, _) in enumerate(
                SH.distinct(placed))])}
    out = {}
    for name in TD_FAULTS:
        attr, fake = planted[name]
        real, _td_tripped = getattr(SH, attr), []
        setattr(SH, attr, fake)
        try:
            row = run()
        finally:
            setattr(SH, attr, real)
            tripped, _td_tripped = _td_tripped, None
        limits = {}
        for limit, _ in tripped:
            limits[limit] = limits.get(limit, 0) + 1
        rel = {k: [abs(m[k] - o[k]) / max(abs(o[k]), 1e-30) for m, o in
                   zip(row["steps"], row["one_card_steps"])]
               for k in ("loss", "grad_norm")}
        out[name] = {"tripped": limits, "worst": row["worst"], **rel}
        if "all_reduces" not in limits or not {"update", "moment"} & set(
                limits):
            fail(f"5r {what}: the planted fault {name} tripped only "
                 f"{limits}")
    return out


def tree_paths(tree) -> list:
    from repro_torch import tree as T
    return T.flatten_with_paths(tree)


def td_copies(placed) -> dict:
    """Per leaf path, per block (by its index along each dimension, from
    the leaf's spec and the mesh's coordinates): {device: (the first
    position holding it there, its tensor)}.  Reckoned here, not read from
    ``launch.sharding``."""
    mesh = placed.mesh
    flat = [dict(tree_paths(s)) for s in placed.shards]
    out = {}
    for path, spec in placed.specs.items():
        blocks = {}
        for pos in range(mesh.size):
            coords = dict(zip(mesh.axis_names,
                              np.unravel_index(pos, mesh.axis_sizes)))
            key = []
            for entry in spec:
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                idx = 0
                for a in axes:
                    idx = idx * mesh.shape[a] + int(coords[a])
                key.append(idx)
            blocks.setdefault(tuple(key), {}).setdefault(
                mesh.devices[pos], (pos, flat[pos][path]))
        out[path] = blocks
    return out


def td_reckoned(placed, grad_dtype=None) -> dict:
    """A step's gradient all-reduces reckoned from the specs: a block held
    on more than one device is summed over its copies; the leaves whose
    copies sit at the same positions, in one gradient dtype, make one
    collective; each copy's bytes count (``mesh.gathered_bytes``' rule)."""
    patterns = {}
    for path, blocks in td_copies(placed).items():
        groups = tuple(sorted(tuple(sorted(p for p, _ in d.values()))
                              for d in blocks.values() if len(d) > 1))
        if not groups:
            continue
        t = next(iter(next(iter(blocks.values())).values()))[1]
        dtype = grad_dtype or t.dtype
        key = (groups, str(dtype))
        patterns[key] = patterns.get(key, 0) + sum(
            len(g) for g in groups) * t.numel() * dtype.itemsize
    return {"all_reduces": len(patterns), "bytes": sum(patterns.values()),
            "patterns": [[list(map(list, g)), d] for g, d in patterns]}


def td_copies_equal(what: str, cell) -> int:
    """Every block's copies on different devices bit-equal (weights and
    moments); returns how many copies were compared."""
    n = 0
    for name, tree in (("weights", cell.args[0]),
                       ("mu", cell.args[1]["mu"]), ("nu", cell.args[1]["nu"])):
        for path, blocks in td_copies(tree).items():
            for d in blocks.values():
                ts = [t.detach().cpu() for _, t in d.values()]
                for t in ts[1:]:
                    if not torch.equal(t, ts[0]):
                        td_fail("copies",
                                f"5r {what}: the copies of {name} {path} "
                             f"differ: {float((t - ts[0]).abs().max())}")
                    n += 1
    return n


def td_steps(what: str, cell, device, check_copies: bool,
             sync_all: bool = False) -> list:
    """``TD_STEPS`` steps of ``cell``: per step its metrics, wall ms (every
    card synchronised with ``sync_all``), collectives and gathered bytes
    (counted from 0 each step), the copies held bit-equal after each; no
    kernel launched."""
    from repro_torch import obs
    from repro_torch.core import mesh as M

    def run():
        out = cell.run()
        if sync_all:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        return out

    steps = []
    for _ in range(TD_STEPS):
        obs.metrics.reset()
        zero_counts()
        out, ms = timed_call(run, device)
        counts = launch_counts()
        if any(counts.values()):
            td_fail("launches", f"5r {what}: the training path launched "
                                f"kernels {counts}")
        row = {**tm_metrics(out[2]), "ms": ms,
               "collectives": M.collectives(),
               "gathered_bytes": M.gathered_bytes()}
        if check_copies:
            row["copies_bit_equal"] = td_copies_equal(what, cell)
        steps.append(row)
    return steps


def td_leaves(what: str, mixed, one, initial: dict) -> dict:
    """After the last step, every weight leaf's update on the mixed mesh
    against the one-card cell's (the norm of their difference over the
    norm of the one-card update) and every moment leaf (the norm of the
    difference over the one-card leaf's norm)."""
    tol, worst = TD_TOL, {"update": [0.0, None], "mu": [0.0, None],
                          "nu": [0.0, None]}

    def note(k, rel, path):
        if rel >= worst[k][0]:
            worst[k] = [rel, path]

    with torch.no_grad():
        for path in one.args[0].shapes:
            want = one.args[0].gather(path).float()
            moved = float(torch.linalg.vector_norm(
                want - initial[path].float()))
            err = float(torch.linalg.vector_norm(
                mixed.args[0].gather(path).float() - want))
            if not err <= tol["update_rel"] * moved:
                td_fail("update", f"5r {what}: {path}'s update is {err} "
                                  f"from the "
                     f"one-card cell's, which moved it by {moved}")
            note("update", err / moved if moved else 0.0, path)
            for k in ("mu", "nu"):
                w = one.args[1][k].gather(path)
                scale = float(torch.linalg.vector_norm(w))
                err = float(torch.linalg.vector_norm(
                    mixed.args[1][k].gather(path) - w))
                if not err <= tol["moment_rel"] * scale:
                    td_fail("moment", f"5r {what}: {k} {path} is {err} "
                                      f"from the "
                         f"one-card cell's, past {tol['moment_rel']} x "
                         f"{scale}")
                note(k, err / scale if scale else 0.0, path)
    return worst


def td_pair(what: str, build, params, device, mixed_mesh, one_mesh,
            grad_dtype=None) -> dict:
    """The cell ``build(mesh, params)`` on the one-card (1, 2) mesh and on
    the mixed one, ``TD_STEPS`` steps each on copies of the same weights:
    loss and grad_norm a step within ``TD_TOL``, the same lr, every leaf
    after the last step (``td_leaves``), the copies bit-equal after each
    step, and each step's collectives and gathered bytes past the one-card
    cell's equal to the all-reduces reckoned from the specs."""
    initial = {p: x.detach() for p, x in tree_paths(params)}
    peaks = {}

    def held():
        return (torch.cuda.memory_allocated(device) / 1e9
                if device.type == "cuda" else None)

    before = held()
    peak_reset(device)
    one = build(one_mesh, params)
    one_steps = td_steps(what, one, device, False)
    peaks["one_card"] = {"peak_gb": peak_gb(device), "held_before_gb": before}
    before = held()
    peak_reset(device)
    mixed = build(mixed_mesh, params)
    reckoned = td_reckoned(mixed.args[0], grad_dtype)
    steps = td_steps(what, mixed, device, True)
    peaks["mixed"] = {"peak_gb": peak_gb(device), "held_before_gb": before}
    tol = TD_TOL
    for i, (m, o) in enumerate(zip(steps, one_steps)):
        for k, rel in (("loss", tol["loss_rel"]),
                       ("grad_norm", tol["gnorm_rel"])):
            d = abs(m[k] - o[k]) / max(abs(o[k]), 1e-30)
            if not (np.isfinite(m[k]) and d <= rel):
                td_fail(k, f"5r {what} step {i + 1}: {k} {m[k]} against the "
                     f"one-card {o[k]}: relative {d} > {rel}")
        if m["lr"] != o["lr"]:
            td_fail("lr", f"5r {what} step {i + 1}: lr {m['lr']} against "
                          f"{o['lr']}")
        got = (m["collectives"] - o["collectives"],
               m["gathered_bytes"] - o["gathered_bytes"])
        if got != (reckoned["all_reduces"], reckoned["bytes"]):
            td_fail("all_reduces",
                    f"5r {what} step {i + 1}: {got[0]} collectives of "
                 f"{got[1]} bytes past the one-card cell's, against the "
                 f"{reckoned['all_reduces']} all-reduces of "
                 f"{reckoned['bytes']} bytes reckoned from the specs")
        if not m["copies_bit_equal"]:
            td_fail("copies", f"5r {what}: no block has copies on two "
                              f"devices")
    worst = td_leaves(what, mixed, one, initial)
    moments = [a + b for a, b in zip(mixed.args[1]["mu"].bytes_per_shard(),
                                     mixed.args[1]["nu"].bytes_per_shard())]
    return {"mesh": {"devices": [str(d) for d in mixed_mesh.devices],
                     "shape": dict(zip(("data", "model"), TD_MESH))},
            "bytes_per_position": {"weights": mixed.args[0].bytes_per_shard(),
                                   "moments": moments},
            "notes": mixed.static_notes, "steps": steps,
            "one_card_steps": one_steps, "all_reduces_reckoned": reckoned,
            "worst": worst, "card_memory": peaks}


def td_recsys(device, mixed, one, rehearse: bool) -> dict:
    """(a) dcn-v2 at full width (26 tables of 1,000,000 x 16, row-sharded
    over model: half of them and their moments on the host), train_batch
    cut to TD_RECSYS_BATCH rows."""
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.models import recsys as RS
    arch = configs.get("dcn-v2")
    cfg = arch.make_smoke() if rehearse else arch.make_full()
    params = RS.dcnv2_init(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    B = 64 if rehearse else TD_RECSYS_BATCH

    def build(mesh, p):
        return cells.build_cell("dcn-v2", "train_batch", mesh,
                                smoke=rehearse, batch=B, params=p)

    row = td_pair("dcn-v2", build, params, device, mixed, one)
    del params
    row.update(batch=B, tables=[len(cfg.vocab_sizes), cfg.vocab_sizes[0],
                                cfg.embed_dim],
               batch_cut="none: the host position's table update, not the "
                         "batch, sets its step (TD_RECSYS_BATCH)")
    return row


def td_lm(device, mixed, one, full: bool = False) -> dict:
    """(b) the smoke qwen3-1.7b train cell (``TD_LM``'s knobs and tokens)
    on the two meshes; ``full``: at full width, cut to ``TD_LM_FULL`` (the
    measurement that keeps it out of 5r)."""
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.models import transformer as TF
    name, knobs, (B, L) = TD_LM
    over = dict(knobs)
    arch = configs.get(name)
    if full:
        cut = dict(TD_LM_FULL)
        B, L = cut.pop("tokens")
        over.update(cut)
    cfg = dataclasses.replace(
        arch.make_full() if full else arch.make_smoke(),
        **{k: v for k, v in over.items() if k != "microbatches"})
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    rng = np.random.default_rng(24)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, (B, L)).astype(
        np.int32)).to(device) for k in ("tokens", "labels")}

    def build(mesh, p):
        return cells.build_cell(name, "train_4k", mesh, dict(over), batch=B,
                                seq_len=L, smoke=not full, params=p,
                                inputs=batch)

    # the microbatches' gradients are summed in float32
    row = td_pair(name, build, params, device, mixed, one,
                  grad_dtype=torch.float32)
    return dict(row, knobs=knobs, n_layers=cfg.n_layers,
                width=[cfg.d_model, cfg.vocab], tokens=[B, L])


def td_gnn(device, mixed, one, rehearse: bool) -> dict:
    """(b) gatedgcn at full width on full_graph_sm (in the rehearsal its
    smoke config) on the two meshes."""
    from repro_torch import configs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.launch import cells
    arch, shape = TD_GNN
    arch_def = configs.get(arch)
    cfg = cells._gnn_config(arch_def, dict(GNN_SHAPES[shape]), rehearse)
    params = cells._gnn_init(arch_def.extras["model"], cfg, device)

    def build(mesh, p):
        return cells.build_cell(arch, shape, mesh, smoke=rehearse, params=p)

    row = td_pair(arch, build, params, device, mixed, one)
    return dict(row, shape=shape, n_layers=cfg.n_layers,
                d_hidden=cfg.d_hidden)


def td_cards(device, card: str, rehearse: bool, dense: dict) -> dict:
    """(c) qwen3-1.7b at full width, 28 layers, bf16, on a (1, 2) mesh of
    cuda:0 and cuda:1 at 5o's batch, knobs and weights: two steps against
    5o (a)'s one-card steps (TM_LOSS_ATOL, TM_GNORM_REL: another mesh in
    bf16), the copies bit-equal after each.  Where the host has one card
    it does not run and says so."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if rehearse or n < 2:
        log("train_devices", f"5r (c) did not run: {n} CUDA device(s) on "
            f"this host, and qwen3-1.7b at full width on a (1, 2) mesh of "
            f"cuda:0 / cuda:1 needs two (still owed)")
        return {"ran": False, "cuda_devices": n,
                "owed": "qwen3-1.7b at full width on (1, 2) over two cards"}
    from repro_torch.core import mesh as M
    from repro_torch.launch import cells
    mesh = M.make_mesh(TD_MESH, ("data", "model"),
                       devices=["cuda:0", "cuda:1"])
    over = dict(TM_DENSE_KNOBS, microbatches=TM_MICRO)
    for i in range(2):
        peak_reset(torch.device("cuda", i))
    cfg, over, params, batch = tm_setup(TM_DENSE, None, over,
                                        (TM_BATCH, TM_SEQ), device, False,
                                        seed=20)
    cell = cells.build_cell(TM_DENSE, "train_4k", mesh, over,
                            batch=TM_BATCH, seq_len=TM_SEQ, params=params,
                            inputs=batch)
    del params, batch
    reckoned = td_reckoned(cell.args[0], torch.float32)
    steps = td_steps("qwen3-1.7b on two cards", cell, device, True,
                     sync_all=True)
    for i, (m, o) in enumerate(zip(steps, dense["steps"])):
        dl = abs(m["loss"] - o["loss"])
        dg = abs(m["grad_norm"] - o["grad_norm"]) / abs(o["grad_norm"])
        if not (dl <= TM_LOSS_ATOL and dg <= TM_GNORM_REL
                and m["lr"] == o["lr"]):
            fail(f"5r (c) step {i + 1}: {m} against 5o (a)'s one-card "
                 f"{o}: loss {dl} (> {TM_LOSS_ATOL}?), grad_norm relative "
                 f"{dg} (> {TM_GNORM_REL}?)")
    peaks = [peak_gb(torch.device("cuda", i)) for i in range(2)]
    del cell
    return {"ran": True, "cuda_devices": n, "arch": cfg.name,
            "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "mesh": {"devices": ["cuda:0", "cuda:1"],
                     "shape": dict(zip(("data", "model"), TD_MESH))},
            "batch": [TM_BATCH, TM_SEQ], "microbatches": TM_MICRO,
            "steps": steps, "five_o_steps": dense["steps"],
            "all_reduces_reckoned": reckoned, "peak_gb_per_card": peaks,
            "card": card}


def phase_train_devices(device, card: str, rehearse: bool,
                        dense: dict) -> dict:
    """Phase 5r: the train cells on a mesh whose positions sit on different
    devices: (1, 2) with one position on ``cuda:0`` and one on the host's
    ``cpu`` (``TD_DEVICES``; in the rehearsal ``cpu:0`` / ``cpu:1``), each
    cell against the same cell on a one-card (1, 2) mesh: (a)
    ``td_recsys``, (b) ``td_lm``, ``td_gnn`` and both under
    ``td_faults``; (c) ``td_cards`` where the host has two cards.  No
    kernel launched.  Returns the row."""
    from repro_torch.core import mesh as M
    t0 = time.perf_counter()
    mixed = M.make_mesh(TD_MESH, ("data", "model"), devices=list(
        ("cpu:0", "cpu:1") if rehearse else TD_DEVICES))
    one = M.make_mesh(TD_MESH, ("data", "model"), device=device)
    recsys = td_recsys(device, mixed, one, rehearse)
    log("train_devices", json.dumps({"dcn-v2": recsys}))
    models = {TD_LM[0]: td_lm(device, mixed, one),
              TD_GNN[0]: td_gnn(device, mixed, one, rehearse)}
    log("train_devices", json.dumps({"models": models}))
    faults = {TD_LM[0]: td_faults(TD_LM[0], lambda: td_lm(device, mixed,
                                                          one)),
              TD_GNN[0]: td_faults(TD_GNN[0], lambda: td_gnn(
                  device, mixed, one, rehearse))}
    log("train_devices", json.dumps({"planted_faults": faults}))
    cards = td_cards(device, card, rehearse, dense)
    log("train_devices", json.dumps({"two_cards": cards}))
    peak_reset(device)
    seconds = time.perf_counter() - t0
    row = {"card": card, "dcn_v2": recsys, "models": models,
           "planted_faults": faults,
           "two_cards": cards, "tolerances": TD_TOL, "seconds": seconds,
           "budget_s": TD_BUDGET_S}
    log("train_devices", f"phase 5r: {seconds:.1f} s (budget {TD_BUDGET_S} "
                         f"s: {'within' if seconds <= TD_BUDGET_S else 'PAST'}"
                         f" it)")
    return row


def phase_plain(device, kept, prepared: PreparedCache, skip=("rmat_b",),
                **kw):
    """The kept problems through the plain versions on the card: the same
    ``api.color(g, **kw)`` call under the ``kernel.fallback`` fault site
    (on phase 5's prepared problems, ``prepared``)."""
    from repro_torch import api, obs
    from repro_torch.resilience import faults
    done = []
    for name, (g, res) in kept.items():
        if name.startswith(skip):
            continue       # W = ell_cap rows: the plain pack is (rows, W, nW)
        before = launch_counts()
        obs.metrics.reset()
        with faults.inject("kernel.fallback"), prepared.reuse():
            plain = api.color(g, device=device, **kw)
        if launch_counts() != before:
            fail(f"{name}: the plain run launched a kernel")
        forced = obs.metrics.total_matching("kernels.fallback")
        torch_disp = sum(v for k, v in obs.metrics.counters_matching(
            "kernels.dispatch").items() if "backend=torch" in k)
        if device.type == "cuda" and (forced == 0 or forced != torch_disp):
            fail(f"{name}: plain run dispatched {torch_disp} plain calls for "
                 f"{forced} forced fallbacks")
        assert_same_result(res, plain, f"{name} {kw}: kernel path vs plain "
                                       f"path")
        done.append(name)
    obs.metrics.reset()
    return done


# --------------------------------------------------------------------------
# phase 5c: distance-2, bipartite partial and frontier compaction at real
# size
# --------------------------------------------------------------------------

D2_MESHES = ("mesh2d", "bmw3_2", "pwtk")
BIPARTITE_DEGREE = 8.0     # nonzeros per column of the Jacobian pattern


def make_bipartite(log2: int):
    """Worker-process body: the bipartite (Jacobian) pattern, as arrays."""
    from repro_torch.graphs import generators as gen
    t = time.perf_counter()
    g = gen.bipartite_random(2 ** log2, 2 ** log2, BIPARTITE_DEGREE, seed=0)
    return g.indptr, g.indices, g.n_vertices, time.perf_counter() - t


def host_check(indptr, indices, n: int, colors, n_left=None) -> bool:
    """Worker-process body: the package's host oracle on one result —
    ``is_distance_d_proper(g, colors, 2)``, or with ``n_left``
    ``is_bipartite_partial_proper``."""
    from repro_torch.core.distance2 import (is_bipartite_partial_proper,
                                            is_distance_d_proper)
    from repro_torch.graphs.csr import CSRGraph
    g = CSRGraph(indptr=indptr, indices=indices, n_vertices=n)
    if n_left is None:
        return is_distance_d_proper(g, colors, 2)
    return is_bipartite_partial_proper(g, n_left, colors)


def d2_conflicts_on_card(g, colors, device) -> int:
    """Distance-2 conflicts of a full coloring, counted on the card in plain
    torch (not the kernel), a block of rows at a time: pairs (v, u) with u
    within two hops of v, u != v, and the same colour.  For graphs whose G²
    is too large to build on the host."""
    from repro_torch.graphs.csr import to_ell
    ell = torch.from_numpy(to_ell(g)).to(device)
    col = torch.from_numpy(np.ascontiguousarray(colors)).to(device)
    if bool((col < 0).any()):
        return -1
    n, W = ell.shape
    step = max(1, 2 ** 24 // (W + W * W))
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for lo in range(0, n, step):
        e1 = ell[lo:lo + step]
        R = e1.shape[0]
        v = torch.arange(lo, lo + R, device=device)
        c_v = col[lo:lo + R][:, None]
        live1 = e1 >= 0
        s1 = e1.clamp(min=0).long()
        e2 = ell[s1.reshape(-1)].reshape(R, W * W)
        live2 = (live1.repeat_interleave(W, dim=1) & (e2 >= 0)
                 & (e2 != v[:, None]))
        bad += (live1 & (col[s1] == c_v)).sum()
        bad += (live2 & (col[e2.clamp(min=0).long()] == c_v)).sum()
    return int(bad)


def phase_distance2(kept, bip, device, rehearse: bool, pool,
                    prepared: PreparedCache):
    """``api.color(g, distance=2)`` on the meshes and the uniform RMAT,
    ``mode="partial"`` on the bipartite pattern, ``algorithm=
    "rsoc_compact"`` on the meshes and the skewed RMAT.  Returns the rows,
    the problems phase 5b / 6 reuse (two-hop runs, compacted runs), the
    launch counts of the whole phase and the pending host checks."""
    from repro_torch import api, obs
    from repro_torch.core.coloring import is_proper
    from repro_torch.graphs.csr import CSRGraph
    n_chunks = api.ColoringSpec().n_chunks
    rmat_er = next(k for k in kept if k.startswith("rmat_er"))
    rmat_b = next(k for k in kept if k.startswith("rmat_b"))
    indptr, indices, n_bip, bip_gen_s = bip.get()
    g_bip = CSRGraph(indptr=indptr, indices=indices, n_vertices=n_bip)
    n_left = n_bip // 2
    bip_name = f"bipartite_{int(np.log2(n_left))}"
    runs = ([(nm, kept[nm][0], dict(distance=2)) for nm in D2_MESHES]
            + [(rmat_er, kept[rmat_er][0], dict(distance=2)),
               (bip_name, g_bip, dict(distance=2, mode="partial",
                                      n_left=n_left))]
            + [(nm, kept[nm][0], dict(algorithm="rsoc_compact"))
               for nm in D2_MESHES + (rmat_b,)])
    rows, kept_d2, kept_compact, checks = [], {}, {}, {}
    # counts to 0 just before this path is driven ...
    zero_counts()
    for name, g, kw in runs:
        what = "partial" if "mode" in kw else (
            "distance2" if "distance" in kw else "rsoc_compact")
        obs.metrics.reset()
        c0, des0 = launch_counts(), design_counts()
        traced_only = what == "rsoc_compact"
        sync(device)
        t = time.perf_counter()
        # rsoc_compact's prepare is RSOC's: phase 5's problem is reused
        with (prepared.reuse() if traced_only
              else contextlib.nullcontext(types.SimpleNamespace(hits=0))
              ) as reused:
            res = api.color(g, device=device, trace=traced_only, **kw)
        sync(device)
        e2e_ms = (time.perf_counter() - t) * 1e3
        c1 = launch_counts()
        d = {k: c1[k] - c0[k] for k in c1}
        per_design = design_delta(des0, design_counts(), d,
                                  f"{name} {what}")
        if traced_only:
            split = split_of(res, e2e_ms, f"{name} {what}")
        else:
            res2, split = traced_split(g, device, f"{name} {what}", **kw)
            assert_same_result(res, res2, f"{name} {what}: traced vs "
                                          f"untraced run")
        if device.type == "cuda":
            exact_launch_counts(f"{name} {what}", res)
            # rsoc_compact: firstfit n_chunks, detect_recolor
            # n_chunks*n_rounds; the two-hop engines: twohop
            # n_chunks*(1+n_rounds) (round 0 is a two-hop pass too)
            want = ({"firstfit": n_chunks,
                     "detect_recolor": n_chunks * res.n_rounds,
                     "twohop_detect_recolor": 0} if traced_only else
                    {"firstfit": 0, "detect_recolor": 0,
                     "twohop_detect_recolor": n_chunks * (1 + res.n_rounds)})
            want.update(flash_attention=0, ell_spmm=0)
            if d != want:
                fail(f"{name} {what}: launches {d}, expected {want}")
        fb = obs.metrics.counters_matching("kernels.fallback")
        if fb:
            fail(f"{name} {what}: kernels.fallback counters are not "
                 f"empty: {fb}")
        # properness: host oracles in worker processes (collected at the
        # end), on the card for the RMAT, whose G² the host cannot build
        want_shape = (n_left,) if what == "partial" else (g.n_vertices,)
        if res.colors.shape != want_shape or res.colors.dtype != np.int32 \
                or (res.colors < 0).any():
            fail(f"{name} {what}: colors have shape {res.colors.shape} "
                 f"dtype {res.colors.dtype}, or uncolored vertices")
        if what == "rsoc_compact":
            if not is_proper(g, res.colors):
                fail(f"{name} {what}: result is not a proper coloring")
            check = "is_proper (host)"
        elif name == rmat_er:
            bad = d2_conflicts_on_card(g, res.colors, device)
            if bad != 0:
                fail(f"{name} {what}: {bad} distance-2 conflicts on the card")
            check = "distance-2 conflicts on the card: 0"
        else:
            checks[f"{name} {what}"] = pool.apply_async(
                host_check, (g.indptr, g.indices, g.n_vertices, res.colors,
                             n_left if what == "partial" else None))
            check = ("is_bipartite_partial_proper (host, worker)"
                     if what == "partial" else
                     "is_distance_d_proper(g, colors, 2) (host, worker)")
        row = {"graph": name, "run": what, "n": g.n_vertices,
               "directed_edges": g.n_edges, "max_degree": g.max_degree,
               "n_colors": res.n_colors, "n_rounds": res.n_rounds,
               "conflicts": res.total_conflicts, "retries": res.retries,
               "final_C": res.final_C, "gather_passes": res.gather_passes,
               "e2e_cold_ms": round(e2e_ms, 2),
               **split, "prepare_reused": reused.hits > 0,
               "launches": d, "launches_per_design": per_design,
               "check": check}
        if what == "partial":
            row["n_left"] = n_left
            row["generate_ms"] = round(bip_gen_s * 1e3, 1)
        log("distance2", json.dumps(row))
        rows.append(row)
        if what == "rsoc_compact":
            kept_compact[name] = (g, res)
        else:
            kept_d2[name] = (g, res, kw)
    # ... and read just after
    counts = launch_counts()
    if device.type == "cuda":
        for k in COLORING_KERNELS:
            if counts[k] < 1:
                fail(f"the distance-2 / compacted path never launched the "
                     f"{k} kernel")
    return rows, kept_d2, kept_compact, counts, checks


# --------------------------------------------------------------------------
# phase 5d: serving qwen3-1.7b at full width
# --------------------------------------------------------------------------

SERVE_BATCH, SERVE_MAX_LEN = 4, 4096
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 32
SERVE_PROMPT_LENS = (128, 2048)       # drawn uniformly, both ends included
# Last-position logits of the kernel route against the plain route (the
# plain attention under kernel.fallback), compared in float32.  The model is
# bfloat16 end to end: each of the 28 layers' attention outputs may differ
# by a bfloat16 step between the routes (see FA_TOL), which the residual
# stream carries to the logits (std about 0.9 with these random weights);
# a wrong attention kernel moves them by O(1).
LOGITS_ATOL = 0.25


def device_time(fn, device) -> dict:
    """Where one call's time goes: its wall time (host clock, synchronized,
    unprofiled), then the same call again under ``torch.profiler``: the
    summed time of its device kernels (one stream: no overlap) and the
    largest kernels.  ``device_busy_ms`` is None where the profiler records
    no device time (the share is then not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    kern, copies = [], [0.0, 0]
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kern.append((e.key[:90], us / 1e3, e.count))
        if "copy" in e.key.lower():     # copy kernels and memcpys
            copies[0] += us / 1e3
            copies[1] += e.count
    busy = sum(ms for _, ms, _ in kern)
    return {"wall_ms": wall, "device_busy_ms": busy if busy > 0 else None,
            "device_idle_share": 1 - busy / wall if busy > 0 else None,
            "kernel_launches": sum(c for _, _, c in kern),
            "copies": {"ms": copies[0], "count": copies[1]},
            "top_kernels": [{"name": k, "ms": ms, "count": c} for k, ms, c
                            in sorted(kern, key=lambda r: -r[1])[:6]]}


def phase_serve(device, rehearse: bool):
    """``ServeEngine`` on qwen3-1.7b (``make_full()``; the smoke config in
    the rehearsal), random weights from ``torch.Generator`` seed 0: 8
    requests with prompts of 128-2048 tokens (``default_rng(0)``), 32 new
    tokens each, 4 slots of 4096.  Counts zeroed before, read after: the
    attention kernel launches exactly once per layer per prefill.  Each
    request's TTFT comes with the caching allocator's cudaMalloc calls
    during its submit (``device_allocs_in_submit``).  Then the
    same prompts' prefill through the plain attention on the card
    (``kernel.fallback``): logits within ``LOGITS_ATOL``, the same greedy
    first token wherever the plain route's top-2 margin exceeds it."""
    from repro_torch import configs, obs
    from repro_torch.models import transformer as TF
    from repro_torch.resilience import faults
    from repro_torch.serving import Request, ServeEngine
    arch = configs.get("qwen3-1.7b")
    cfg = arch.make_smoke() if rehearse else arch.make_full()
    t = time.perf_counter()
    params = TF.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    sync(device)
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(0)
    lo, hi = (8, 64) if rehearse else SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, L).astype(np.int32) for L in lens]
    eng = ServeEngine(params, cfg, batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                      device=device)
    # warm-up (library handles, allocator): one short request, not counted
    eng.run([Request(prompt=prompts[0][:64], max_new_tokens=2)])
    # time each prefill and each decode step (host clock, synchronized)
    ttft, allocs, steps = {}, {}, []
    submit, step_all = eng.submit, eng.step_all

    def device_allocs() -> int:
        """cudaMalloc calls of PyTorch's caching allocator so far (a submit
        during which the cache grows pays for them on the host)."""
        return (torch.cuda.memory_stats(device).get("num_device_alloc", 0)
                if device.type == "cuda" else 0)

    def timed_submit(req):
        sync(device)
        a0 = device_allocs()
        t0 = time.perf_counter()
        ok = submit(req)
        sync(device)
        if ok:
            ttft[id(req)] = (time.perf_counter() - t0) * 1e3
            allocs[id(req)] = device_allocs() - a0
        return ok

    def timed_step():
        live = [id(r) for r in eng.active if r is not None]
        sync(device)
        t0 = time.perf_counter()
        n = step_all()
        sync(device)
        steps.append(((time.perf_counter() - t0) * 1e3, live))
        return n

    eng.submit, eng.step_all = timed_submit, timed_step
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
            for p in prompts]
    obs.metrics.reset()
    # counts to 0 just before the serving path is driven ...
    zero_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    sync(device)
    wall_s = time.perf_counter() - t0
    # ... and read just after
    counts = launch_counts()
    designs = attention_designs()
    fb = obs.metrics.counters_matching("kernels.fallback")
    if fb:
        fail(f"serve: kernels.fallback counters are not empty: {fb}")
    if device.type == "cuda":
        want = {k: 0 for k in KERNELS}
        want["flash_attention"] = cfg.n_layers * len(reqs)
        if counts != want:
            fail(f"serve: launches {counts}, expected {want} (one attention "
                 f"launch per layer per prefill)")
        # bfloat16, head dim 128: every prefill on the Hopper design
        if designs != {"sm90": want["flash_attention"], "fma": 0}:
            fail(f"serve: attention launches by design {designs}, expected "
                 f"all {want['flash_attention']} on sm90")
    for r in reqs:
        if not r.done or len(r.out_tokens) != SERVE_NEW_TOKENS or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"serve: a request ended with {len(r.out_tokens)} tokens "
                 f"(done={r.done}), or with a token outside the vocabulary")
    # the kernel route against the plain route, prompt by prompt
    worst, checked, margins = 0.0, 0, []
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            tokens = torch.from_numpy(p).to(device)[None]
            before = launch_counts()
            with faults.inject("kernel.fallback"):
                plain = TF.prefill(params, cfg, tokens)[0].float()
            if launch_counts() != before:
                fail("serve: the plain route launched a kernel")
            kern = TF.prefill(params, cfg, tokens)[0].float()
            if kern.shape != (1, cfg.vocab) or not bool(
                    torch.isfinite(kern).all()):
                fail(f"serve: prefill logits {tuple(kern.shape)} are not "
                     f"(1, {cfg.vocab}) finite values")
            err = float((kern - plain).abs().max())
            worst = max(worst, err)
            top2 = torch.topk(plain[0], 2).values
            margin = float(top2[0] - top2[1])
            margins.append(margin)
            if margin > LOGITS_ATOL:
                checked += 1
                if r.out_tokens[0] != int(torch.argmax(plain[0])):
                    fail(f"serve: greedy first token {r.out_tokens[0]} of "
                         f"the kernel route, {int(torch.argmax(plain[0]))} "
                         f"of the plain route (top-2 margin {margin})")
    if worst > LOGITS_ATOL:
        fail(f"serve: last-position logits differ by {worst} between the "
             f"kernel and the plain route (tolerance {LOGITS_ATOL})")
    per_req = []
    for L, r in zip(lens, reqs):
        mine = [ms for ms, live in steps if id(r) in live]
        per_req.append({"prompt_len": int(L), "ttft_ms": ttft[id(r)],
                        "device_allocs_in_submit": allocs[id(r)],
                        "decode_ms_per_step": statistics.mean(mine),
                        "decode_steps": len(mine)})
    n_tok = sum(len(r.out_tokens) for r in reqs)
    # where the time goes: a decode step with every slot live, and the
    # longest prompt's prefill, each timed, then traced
    for p in prompts[:SERVE_BATCH]:
        submit(Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS))
    step_all()
    longest = torch.from_numpy(prompts[int(np.argmax(lens))]).to(device)[None]
    with torch.inference_mode():
        breakdown = {"decode_step_4_live": device_time(step_all, device),
                     f"prefill_{int(lens.max())}": device_time(
                         lambda: TF.prefill(params, cfg, longest), device)}
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": n_params,
           "init_s": init_s, "batch": SERVE_BATCH, "max_len": SERVE_MAX_LEN,
           "requests": per_req, "tokens": n_tok, "wall_s": wall_s,
           "tokens_per_s": n_tok / wall_s, "decode_steps": len(steps),
           "decode_ms_per_step_mean": statistics.mean(ms for ms, _ in steps),
           "attention_designs": designs,
           "logits_max_abs_err_vs_plain": worst,
           "logits_tol": LOGITS_ATOL, "first_tokens_checked": checked,
           "top2_margins": margins, "breakdown": breakdown}
    log("serve", json.dumps(row))
    del eng, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row, counts


# --------------------------------------------------------------------------
# phase 5e: ops.ell_aggregate on the uniform RMAT's ELL table
# --------------------------------------------------------------------------

AGG_D = 100     # d_feat of ogb_products (configs.common.GNN_SHAPES)
AGG_BLOCK_ROWS = 2 ** 16     # rows per block of the plain version


def spmm_plain_blocks(ell, feats, op):
    """``ell_spmm_ref`` over the whole table in row blocks (its gather is
    (rows, W, d) floats)."""
    from repro_torch.kernels import ref
    return torch.cat([ref.ell_spmm_ref(ell[lo:lo + AGG_BLOCK_ROWS], feats, op)
                      for lo in range(0, ell.shape[0], AGG_BLOCK_ROWS)])


def phase_aggregate(device, g, name: str, cmp: Cmp):
    """``ops.ell_aggregate`` on the ELL table of the uniform RMAT (every
    vertex, its real neighbours, FILL-padded to the max degree) with
    ``AGG_D`` random features, float32 and bfloat16, all three ops; each
    result against the plain version on the card.  Counts zeroed before,
    read after: one launch per call."""
    from repro_torch import obs
    from repro_torch.graphs.csr import to_ell
    from repro_torch.kernels import ops
    ell = torch.from_numpy(to_ell(g)).to(device)
    R, W = ell.shape
    gen = torch.Generator(device=device).manual_seed(0)
    feats32 = torch.randn((g.n_vertices, AGG_D), generator=gen,
                          device=device)
    inputs = {torch.float32: feats32, torch.bfloat16: feats32.bfloat16()}
    obs.metrics.reset()
    # counts to 0 just before the aggregation path is driven ...
    zero_counts()
    outs = {}
    for dtype, feats in inputs.items():
        for op in ("sum", "mean", "max"):
            outs[(dtype, op)] = ops.ell_aggregate(ell, feats, op)
    sync(device)
    # ... and read just after
    counts = launch_counts()
    if obs.metrics.counters_matching("kernels.fallback"):
        fail("aggregate: kernels.fallback counters are not empty")
    if device.type == "cuda":
        want = {k: 0 for k in KERNELS}
        want["ell_spmm"] = len(outs)
        if counts != want:
            fail(f"aggregate: launches {counts}, expected {want}")
    for (dtype, op), got in outs.items():
        cmp.close("ell_spmm", f"{name} R{R} W{W} d{AGG_D} {str(dtype)[6:]} "
                  f"{op}", got, spmm_plain_blocks(ell, inputs[dtype], op),
                  *SPMM_TOL[dtype])
    del outs
    row = {"graph": name, "R": R, "W": W, "live_slots": int((ell >= 0).sum()),
           "d": AGG_D, "calls": 6, "launches": counts["ell_spmm"]}
    log("aggregate", json.dumps(row))
    return row, counts, ell, feats32


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


SLEEP_CYCLES = 20_000_000   # about 10 ms of device sleep at H100 clocks


def device_ms(fn, device, reps: int, rounds: int = 5) -> float:
    """A kernel's own time: CUDA events around ``reps`` back-to-back calls
    queued behind a device-side sleep (``torch.cuda._sleep``) that outlasts
    their host side, so that the device runs them back to back whatever
    each call costs the host; divided by ``reps``, the median of ``rounds``,
    after a warm-up call.  (Host clock on the CPU rehearsal.)"""
    if device.type != "cuda":
        return time_ms(fn, device, reps, rounds)
    fn()
    sync(device)
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def timed(kernel: str, fn, device, reps: int, launch: bool) -> dict:
    """``ms`` (``device_ms``), ``call_ms`` (``time_ms``) and ``design`` of
    ``fn``: the design whose count rose over those timed calls, read from
    the wrapper's per-design counts (None for a kernel of one design, and
    on the CPU rehearsal, where nothing launches).  Fails unless exactly
    one design rose."""
    before = design_counts().get(kernel)
    out = {"ms": device_ms(fn, device, reps),
           "call_ms": time_ms(fn, device, reps), "design": None}
    if before is not None and launch:
        after = design_counts()[kernel]
        rose = [d for d in after if after[d] != before[d]]
        if len(rose) != 1:
            fail(f"{kernel}: the timed calls launched the designs {rose}, "
                 f"not exactly one ({before} -> {after})")
        out["design"] = rose[0]
    return out


def phase_times(device, kept, kept_compact, cmp: Cmp, launch: bool,
                prepared: PreparedCache):
    """One chunk of each kept graph: kernel ms, plain ms, bound ms; and on
    the skewed RMAT one compacted pass, kernels against plain versions
    (``check_compact_pass``).

    Bound: the bytes the function must move over the card's memory rate,
    inputs read once and outputs written once (``kernels/cost.py``'s ``gather_bytes`` for the ELL
    rows, colours and priorities), plus the per-row flags, the forb0 words
    where given, and the outputs.  The integer work (a few operations per
    slot) is far below any operation peak of the card, so bytes bound both
    kernels.
    """
    from repro_torch import api
    from repro_torch.core import coloring, frontier
    from repro_torch.core.context import PassContext
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.firstfit import firstfit
    spec = api.ColoringSpec()
    kb = "cuda" if launch else "torch"
    rows = []
    for name, (g, res) in kept.items():
        with prepared.reuse():      # phase 5's problem, copied to the card
            prob = coloring.prepare(g, spec.seed, spec.n_chunks,
                                    spec.ell_cap, spec.C, spec.relabel,
                                    device=device)
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
        nW = -(-C // 32)
        reps = 20

        def bound(nbytes):
            return nbytes / HBM_BYTES_PER_S * 1e3

        vids = torch.arange(lo, hi, device=device)
        all_k = torch.ones(cs, dtype=torch.bool, device=device)
        ff_bytes, live = kcost.gather_bytes(ell_k, colors, vids, all_k,
                                            ~all_k, own=False)
        ff_bytes = kcost.firstfit_bytes(ff_bytes, cs, nW, has_ovf)
        ff = lambda: ops.firstfit(ell_k, colors, C, backend=kb, forb0=f0)
        ff_plain = lambda: ref.firstfit_ref(ell_k, colors, C, forb0=f0)
        cmp.check("firstfit", f"{name} chunk R{cs} W{W} n{n_pad} C{C}",
                  ff(), ff_plain(), ("mex", "ovf"))
        t = timed("firstfit", ff, device, reps, launch)
        if t["design"] == "vec16":
            # the direct design on the same inputs: the kernel every chunk
            # took before first fit had the staged pass (its source is
            # unchanged), timed in turns with the design that serves it
            direct = lambda: firstfit(ell_k, colors, C, f0, route="direct")
            cmp.check("firstfit", f"{name} chunk R{cs} W{W} direct",
                      direct(), ff_plain(), ("mex", "ovf"))
            t["direct_ms"] = device_ms(direct, device, reps)
            t["ms_again"] = device_ms(ff, device, reps)
        rows.append({"kernel": "firstfit", "graph": name, "R": cs, "W": W,
                     "n": n_pad, "C": C, "live_slots": live,
                     "bytes": ff_bytes, **t,
                     "plain_ms": time_ms(ff_plain, device, 3, 3),
                     "bound_ms": bound(ff_bytes)})
        # state after a whole round 0
        colors = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
        _, U0, _, _ = coloring._chunked_pass(
            ctx, prob.ell, prob.ovf_src, prob.ovf_dst, prob.pri, colors,
            zeros, valid, detect=False)
        U_k, valid_k, force_k = valid[lo:hi], valid[lo:hi], zeros[lo:hi]
        xd = None
        if has_ovf:
            f0 = coloring._snapshot_coo(prob.ovf_src, prob.ovf_dst, colors,
                                        n_pad, C, "bitset")[lo:hi].contiguous()
            xd = coloring._ovf_conflict(prob.ovf_src, prob.ovf_dst, colors,
                                        prob.pri, n_pad)[lo:hi]
        work_k = valid_k & (U_k | force_k)
        test_k = work_k & U_k & ~force_k & (colors[lo:hi] >= 0)
        dr_bytes, live_may = kcost.gather_bytes(ell_k, colors, vids, work_k,
                                                test_k, own=True)
        may = int(work_k.sum())
        dr_bytes = kcost.detect_recolor_bytes(dr_bytes, cs, may, nW, has_ovf)
        kw = dict(forb0=f0, extra_defect=xd, force=force_k, valid=valid_k)
        dr = lambda: ops.detect_recolor(ell_k, colors, prob.pri, U_k, lo, C,
                                        backend=kb, **kw)
        dr_plain = lambda: ref.detect_recolor_ref(ell_k, colors, prob.pri, lo,
                                                  U_k, C, **kw)
        cmp.check("detect_recolor", f"{name} chunk R{cs} W{W} n{n_pad} C{C}",
                  dr(), dr_plain(), ("newc", "recolored", "ovf"))
        rows.append({"kernel": "detect_recolor", "graph": name, "R": cs,
                     "W": W, "n": n_pad, "C": C, "live_slots": live_may,
                     "bytes": dr_bytes,
                     **timed("detect_recolor", dr, device, reps, launch),
                     "plain_ms": time_ms(dr_plain, device, 3, 3),
                     "bound_ms": bound(dr_bytes)})
        for r in rows[-2:]:
            log("times", json.dumps(r))
        rows += time_detect_only(name, prob, colors, C, has_ovf, cmp, device,
                                 launch)
        if name.startswith("rmat_b"):
            ctx_c = PassContext.for_problem(prob, n_chunks=spec.n_chunks,
                                            C=kept_compact[name][1].final_C)
            small, full = frontier._d1_passes(ctx_c, prob.ell, prob.ovf_src,
                                              prob.ovf_dst, prob.pri)
            check_compact_pass(cmp, "detect_recolor", name, n_pad,
                               colors.clone(), U0, small, full, spec)
        del prob, colors, ell_k, f0, xd, U0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def phase_times_slots(device, states, cmp: Cmp, launch: bool) -> dict:
    """B2's slot-stride form at phase 5h's chunk shape: the stacked tables
    of 5h's megabatched tenants after their last step, each tenant's
    frontier the endpoints of one batch of 5h's size (``SVC_INS`` +
    ``SVC_DEL`` random pairs, compacted into its ``frontier_cap`` buffer),
    its overflow snapshot as the pass builds it.  Timed: chunk 0 (every
    live row) as ONE slot-stride launch and, at the same rows, as one
    launch of the one-table form a tenant; the plain version; an all-dead
    chunk.  Bound: bytes over 3.35 TB/s (``gather_bytes`` on the rows'
    global neighbour ids; every row's id, U and force flags and 6 output
    bytes; the forb0 words and ``extra_defect`` flag of the rows that can
    work, ``U | force``, alone: a dead row reads neither)."""
    from repro_torch.core import frontier
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import detect_recolor as dr_mod, ops
    from repro_torch.kernels.firstfit import n_words
    st0 = states[0]
    S, n_pad, W, C = len(states), st0.n_pad, int(st0.ell.shape[1]), st0.C
    cap, nc = st0.frontier_cap, st0.n_chunks
    cs = cap // nc
    ell = torch.stack([x.ell for x in states]).reshape(S * n_pad, W)
    colors = torch.stack([x.colors_dev for x in states]).reshape(-1)
    pri = torch.stack([x.pri for x in states]).reshape(-1)
    osrc = torch.stack([x.ovf_src for x in states])
    odst = torch.stack([x.ovf_dst for x in states])
    rng = np.random.default_rng(1)
    U = torch.zeros((S, n_pad), dtype=torch.bool, device=device)
    for j in range(S):
        ends = rng.integers(0, st0.n, 2 * (SVC_INS + SVC_DEL))
        U[j, dev(ends, device)] = True
    idx = frontier._compact_rows(U, cap, n_pad)
    slots = torch.arange(S, device=device)
    valid = idx < n_pad
    gid = slots[:, None] * n_pad + idx.clamp(max=n_pad - 1)
    force = valid & (colors[gid] < 0)
    snap, extra = frontier._slot_snapshot(C, n_pad, osrc, odst, pri, colors,
                                          slots, idx)
    nW = n_words(C)
    if snap is None:
        snap = torch.zeros((S * cap, nW), dtype=torch.int32, device=device)
        extra = torch.zeros((S * cap,), dtype=torch.bool, device=device)
    lay = lambda t: frontier._slot_layout(t, nc)        # noqa: E731
    rows_k = lay(gid.to(torch.int32))
    valid_k, force_k = lay(valid), lay(force)
    snap_k = lay(snap.reshape(S, cap, nW))
    extra_k = lay(extra.reshape(S, cap))

    def slot_call(k, backend="auto"):
        return ops.detect_recolor(ell, colors, pri, valid_k[k], 0, C,
                                  backend=backend, forb0=snap_k[k],
                                  extra_defect=extra_k[k], force=force_k[k],
                                  row_ids=rows_k[k], slot_rows=n_pad)

    # one launch of the one-table form a tenant, at the same rows: the
    # arguments made once, so that the timed calls are the launches alone
    each_args = []
    for j in range(S):
        lo, hi, r0 = j * n_pad, (j + 1) * n_pad, j * cap
        each_args.append((
            (ell[lo:hi], colors[lo:hi], pri[lo:hi],
             valid[j, :cs].contiguous(), 0, C),
            dict(forb0=snap[r0:r0 + cs], extra_defect=extra[r0:r0 + cs],
                 force=force[j, :cs].contiguous(),
                 row_ids=idx[j, :cs].clamp(max=n_pad - 1).to(torch.int32))))

    def per_slot():
        return [ops.detect_recolor(*a, **kw) for a, kw in each_args]

    names = ("newc", "recolored", "ovf")
    got = slot_call(0)
    cmp.check(SLOT_STRIDE, f"5h chunk S{S} R{S * cs} W{W} C{C}", got,
              slot_call(0, "torch"), names)
    cmp.check(SLOT_STRIDE, f"5h chunk S{S} R{S * cs} W{W} C{C} == per-slot "
              f"launches", got, [torch.cat(x) for x in zip(*per_slot())],
              names)
    reps = 50
    ms = device_ms(lambda: slot_call(0), device, reps)
    call_ms = time_ms(lambda: slot_call(0), device, reps)
    each_ms = device_ms(per_slot, device, 5)
    each_call_ms = time_ms(per_slot, device, 5)
    dead_ms = device_ms(lambda: slot_call(1), device, reps)
    plain_ms = time_ms(lambda: slot_call(0, "torch"), device, 3, rounds=3)
    # the bound, on this chunk's data
    r = rows_k[0].long()
    e = ell[r]
    base = (r - r % n_pad)[:, None]
    e_glob = torch.where(e >= 0, base + e.clamp(max=n_pad - 1), -1)
    work = valid_k[0] | force_k[0]
    c_r = colors[r]
    test = valid_k[0] & ~force_k[0] & (c_r >= 0)
    nbytes, live = kcost.gather_bytes(e_glob, colors, r, work, test,
                                      own=True)
    R, may = r.numel(), int(work.sum())
    nbytes += R * (4 + 1 + 1 + 6) + may * (4 * nW + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"kernel": SLOT_STRIDE, "graph": f"5h: {S} tenants",
           "design": dr_mod.design(W), "S": S, "R": R, "W": W,
           "n": S * n_pad, "C": C, "live_rows": int(valid_k[0].sum()),
           "live_slots": live, "ms": round(ms, 6),
           "call_ms": round(call_ms, 6),
           "per_slot_launches_ms": round(each_ms, 6),
           "per_slot_launches_call_ms": round(each_call_ms, 6),
           "dead_chunk_ms": round(dead_ms, 6),
           "plain_ms": round(plain_ms, 4), "bound_ms": round(bound_ms, 6),
           "bound_by": "bytes", "bytes": nbytes}
    log("times", json.dumps(row))
    return row


PLAIN_BLOCK_ROWS = 2 ** 18   # rows per block of the full-width plain passes


def time_detect_only(name, prob, colors, C: int, has_ovf: bool, cmp: Cmp,
                     device, launch: bool) -> list:
    """B2's detect-only form at the shape CAT's and GM's detect pass
    launches it: every row of the table (``row_start`` 0, R = n_pad), U =
    every valid row (round 0's detect pass), the overflow-edge conflicts as
    ``extra_defect``, on the colours after a whole round 0.  Beside it the
    full B2 pass at the same shape (U = valid, the snapshot words as
    ``forb0``).  Each against its plain version, run in blocks of
    ``PLAIN_BLOCK_ROWS`` rows (rows are independent: the same function,
    and a full-width plain gather of RMAT-B's table would not fit).

    Bound (bytes, PR 12 run C's rule, ``gather_bytes``): the ELL row of
    each valid row, each distinct colour once (the rows' own included) and
    each priority the defect test needs once, the U / valid (and
    extra_defect) masks, and the 1-byte output; the full pass adds the
    forb0 words of its working rows and 5 more output bytes a row."""
    from repro_torch.core import bitset, coloring
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops, ref
    n_pad = prob.n_pad
    ell, pri = prob.ell, prob.pri
    W = ell.shape[1]
    valid = torch.arange(n_pad, device=device) < prob.n
    xd = f0 = None
    if has_ovf:
        xd = coloring._ovf_conflict(prob.ovf_src, prob.ovf_dst, colors, pri,
                                    n_pad)
        f0 = coloring._snapshot_coo(prob.ovf_src, prob.ovf_dst, colors,
                                    n_pad, C, "bitset")
    kb = "cuda" if launch else "torch"
    kw = dict(extra_defect=xd, valid=valid)

    def blocks(fn):
        outs = [fn(lo, min(lo + PLAIN_BLOCK_ROWS, n_pad))
                for lo in range(0, n_pad, PLAIN_BLOCK_ROWS)]
        return [torch.cat(x) for x in zip(*outs)]

    def sl(t, lo, hi):
        return None if t is None else t[lo:hi]

    det = lambda: ops.detect_recolor(ell, colors, pri, valid, 0, C,
                                     backend=kb, detect_only=True, **kw)
    det_plain = lambda: blocks(lambda lo, hi: [ref.detect_recolor_ref(
        ell[lo:hi], colors, pri, lo, valid[lo:hi], C, detect_only=True,
        extra_defect=sl(xd, lo, hi), valid=valid[lo:hi])])
    full = lambda: ops.detect_recolor(ell, colors, pri, valid, 0, C,
                                      backend=kb, forb0=f0, **kw)
    full_plain = lambda: blocks(lambda lo, hi: ref.detect_recolor_ref(
        ell[lo:hi], colors, pri, lo, valid[lo:hi], C, forb0=sl(f0, lo, hi),
        extra_defect=sl(xd, lo, hi), valid=valid[lo:hi]))
    label = f"{name} full width R{n_pad} W{W} C{C}"
    cmp.check(DETECT_ONLY, label, [det()], det_plain(), ("recolored",))
    cmp.check("detect_recolor", label, full(), full_plain(),
              ("newc", "recolored", "ovf"))
    vids = torch.arange(n_pad, device=device)
    test = valid & (colors >= 0)
    nbytes, live = kcost.gather_bytes(ell, colors, vids, valid, test,
                                      own=True)
    n_valid = int(valid.sum())
    det_bytes = nbytes + n_pad * (2 + (1 if has_ovf else 0)) + n_pad
    full_bytes = (nbytes + n_pad * (2 + (1 if has_ovf else 0))
                  + (n_valid * bitset.n_words(C) * 4 if has_ovf else 0)
                  + n_pad * 6)
    reps = 5
    before = detect_only_counts()
    row = {"kernel": DETECT_ONLY, "graph": name, "R": n_pad, "W": W,
           "n": n_pad, "C": C, "live_slots": live, "bytes": det_bytes,
           "ms": device_ms(det, device, reps),
           "call_ms": time_ms(det, device, reps),
           "design": None, "plain_ms": time_ms(det_plain, device, 1, 3),
           "bound_ms": det_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "full_pass_bytes": full_bytes,
           "full_pass": timed("detect_recolor", full, device, reps, launch),
           "full_pass_bound_ms": full_bytes / HBM_BYTES_PER_S * 1e3}
    if launch:
        after = detect_only_counts()
        rose = [d for d in DESIGNS["detect_recolor"] if after[d] != before[d]]
        if len(rose) != 1 or after["launches"] == before["launches"]:
            fail(f"{label}: the detect-only calls launched the designs "
                 f"{rose}, not exactly one ({before} -> {after})")
        row["design"] = rose[0]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log("times", json.dumps(row))
    return [row]


def phase_times_twohop(device, kept_d2, cmp: Cmp, launch: bool):
    """One chunk of each distance-2 graph: kernel ms, plain ms, bound ms;
    and on the uniform RMAT one compacted pass, kernel against plain
    version (``check_compact_pass``).

    The chunk is chunk n_chunks/2 of repair round 1 (U = every row to
    colour, after a whole round 0): the widest two-hop pass.  Bound: bytes
    over the card's memory rate — ``gather_bytes`` with the full table (the
    ELL rows of the rows that can work, each distinct hop-2 row once, the
    colours and priorities the function reads, each once), 3 B of per-row
    flags and 6 B of outputs per row.  Integer work only: bytes bound
    it."""
    from repro_torch import api
    from repro_torch.core import distance2
    from repro_torch.core.context import PassContext
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops, ref
    spec = api.ColoringSpec()
    kb = "cuda" if launch else "torch"
    K = "twohop_detect_recolor"
    rows = []
    for name, (g, res, kw) in kept_d2.items():
        prob = distance2._prepare_native(g, spec.seed, spec.n_chunks, spec.C,
                                         spec.relabel, spec.ell_cap,
                                         device=device)
        C, n_pad, W = res.final_C, prob.n_pad, prob.ell.shape[1]
        cs = n_pad // spec.n_chunks
        rows_mask = torch.arange(n_pad, device=device) < prob.n
        if kw.get("mode") == "partial":
            mask = np.zeros(n_pad, dtype=bool)
            mask[prob.perm[:kw["n_left"]]] = True
            rows_mask = torch.from_numpy(mask).to(device)
        ctx = PassContext.for_problem(prob, n_chunks=spec.n_chunks, C=C)
        colors = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
        zeros = torch.zeros((n_pad,), dtype=torch.bool, device=device)
        _, U0, _, _ = distance2._d2_chunked_pass(
            ctx, prob.ell, prob.pri, rows_mask, colors, zeros, rows_mask,
            detect=False)
        k = spec.n_chunks // 2
        lo, hi = k * cs, (k + 1) * cs
        ell_k, U_k, force_k = prob.ell[lo:hi], rows_mask[lo:hi], zeros[lo:hi]
        args = (ell_k, prob.ell, colors, prob.pri, U_k, lo, C)
        kw_k = dict(force=force_k, valid=U_k)
        fn = lambda: ops.twohop(*args, backend=kb, **kw_k)
        plain = lambda: ref.twohop_ref(ell_k, prob.ell, colors, prob.pri, lo,
                                       U_k, C, **kw_k)
        cmp.check(K, f"{name} chunk R{cs} W{W} n{n_pad} C{C}", fn(), plain(),
                  ("newc", "recolored", "ovf"))
        work_k = U_k            # valid & (U | force), with valid = U here
        test_k = work_k & ~force_k & (colors[lo:hi] >= 0)
        nbytes, live = kcost.gather_bytes(
            ell_k, colors, torch.arange(lo, hi, device=device), work_k,
            test_k, own=True, ell=prob.ell)
        nbytes = kcost.twohop_bytes(nbytes, cs)
        big = live > 2 ** 26                     # the plain panels are large
        rows.append({"kernel": K, "graph": name, "R": cs, "W": W, "n": n_pad,
                     "C": C, "live_slots": live, "bytes": nbytes,
                     **timed(K, fn, device, 10, launch),
                     "plain_ms": time_ms(plain, device, 1 if big else 3,
                                         3),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        log("times", json.dumps(rows[-1]))
        if name.startswith("rmat_er"):
            def small(colors_, idx, idx_valid, count):
                return distance2._d2_compact_pass(
                    ctx, prob.ell, prob.pri, colors_, idx, idx_valid, count)

            def full(colors_, U, force):
                return distance2._d2_chunked_pass(
                    ctx, prob.ell, prob.pri, rows_mask, colors_, U, force,
                    detect=True)

            check_compact_pass(cmp, K, name, n_pad, colors.clone(), U0,
                               small, full, spec)
        del prob, colors, ell_k, U0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


BF16_TFLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
F32_TFLOPS = 67e12       # H100 SXM float32 rate outside the tensor cores
# a typical serving prompt, the serving prefill's longest, and 4x it
FA_TIME_LENS = (512, 2048, 8192)
FA_F32_LEN = 2048        # the float32 row (the unchanged CUDA-core kernel)
FA_D80_LEN = 2048        # qwen3-32b's prefill row (head dim 80, sm90 design)
FA_D96_LEN = 2048        # minicpm3-4b's prefill row (head dim 96, sm90)


def fma_kernel(q, k, v, launch: bool):
    """Causal attention on the CUDA-core kernel (``csrc/flash_attention.cu``,
    ``attn_flash_forward``'s design id 0) whatever the wrapper's design for
    these inputs: what bfloat16 D 80 / 96 ran on before the sm90 design
    took them, timed beside it in phase 6.  Bypasses the wrapper, so no
    launch is counted; on the rehearsal the plain version."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.firstfit import ptr
    from repro_torch.kernels.flash_attention import DTYPES, row_strides
    if not launch:
        return ref.flash_attention_ref(q, k, v, causal=True)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    out = torch.empty_like(q)
    err = _build.library().attn_flash_forward(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Lq, Lk, D, 1,
        DTYPES[q.dtype], 0, *row_strides(q), *row_strides(k),
        *row_strides(v), 1.0 / (D ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        fail(f"fma_kernel: attn_flash_forward returned {err}")
    return out


def phase_times_models(device, ell, feats32, cmp: Cmp, launch: bool,
                       rehearse: bool):
    """Times of the two float kernels at their paths' shapes.

    ``flash_attention`` at the serving prefill's head shape (B=1, Hq=16,
    Hkv=8, D=128, causal): bfloat16 at L = 512, 2048 and 8192 (the sm90
    design), and float32 at L = 2048 (the CUDA-core design, unchanged);
    and at qwen3-32b's prefill (Hq=64, Hkv=8, D=80, L=2048, bfloat16: the
    sm90 design's tail panel) and minicpm3-4b's (Hq=Hkv=40, D=96, L=2048,
    bfloat16: sm90); each held to ``FA_TOL`` and ``ROW_TOL``.  At D 80 and
    96 also ``fma_ms``: the CUDA-core kernel that served them before, at
    the same inputs, through ``attn_flash_forward``'s design id 0 (a
    measurement only: ``fma_kernel``, no path, no count), with its error
    against the plain version.  Bound: the larger
    of 4 * Hq * D FLOPs per visible (query, key) pair at the type's rate
    (bf16 tensor cores; float32 outside them) and q, k, v, out read /
    written once at the memory rate — operations bound it.  Library:
    ``scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)``
    on the same tensors (timed here only); ``ms_over_library`` is the
    ratio of the two in this run.  ``ms`` and ``library_ms`` are device
    times (``device_ms``: launches queued behind a device-side sleep);
    ``call_ms`` is what a caller's loop of ``ops.attention`` calls pays per
    call, host side included (``time_ms``).

    ``ell_spmm`` on the uniform RMAT's table, d=100, float32 and bfloat16,
    ``sum`` / ``mean`` / ``max`` (six rows; the float32 ``sum`` one is the
    kernels line's), ``ms`` by ``device_ms`` and ``call_ms`` by
    ``time_ms``.  Bound: the table's bytes, each distinct feature row a
    live slot names once and the output, at the memory rate; beside it the
    gather floor (``ell_spmm.gather_floor_bytes``: every live slot's row
    read as the 32-B sectors it spans, which a table without locality
    costs).  Library: ``embedding_bag`` (FILL mapped to the padding row n
    of an (n + 1)-row copy of the features, built untimed) for every op,
    and for float32 ``sum`` also ``torch.sparse.mm`` of a CSR matrix of
    the same table (built untimed); both timed by ``device_ms``."""
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import design
    kb = "cuda" if launch else "torch"
    rows = []
    gen = torch.Generator(device=device).manual_seed(1)
    B, Hq, Hkv, D = (1, 4, 2, 16) if rehearse else (1, 16, 8, 128)
    lens = (32, 64, 128) if rehearse else FA_TIME_LENS
    cases = [(L, torch.bfloat16, (B, Hq, Hkv, D)) for L in lens]
    cases.append((64 if rehearse else FA_F32_LEN, torch.float32,
                  (B, Hq, Hkv, D)))
    # qwen3-32b's prefill: 64 / 8 heads at head dim 80 (sm90, tail panel)
    cases.append((64 if rehearse else FA_D80_LEN, torch.bfloat16,
                  (1, 8, 1, 80) if rehearse else (1, 64, 8, 80)))
    # minicpm3-4b's MLA prefill: 40 / 40 heads at head dim 96 (sm90)
    cases.append((64 if rehearse else FA_D96_LEN, torch.bfloat16,
                  (1, 8, 8, 96) if rehearse else (1, 40, 40, 96)))
    # one shard's prefill in 5n: qwen3-32b at model 4, 16 / 2 heads, D 80
    cases.append((64 if rehearse else SH_PREFILL_LEN, torch.bfloat16,
                  (1, 4, 1, 80) if rehearse else (1, 16, 2, 80)))
    # one shard's MLA prefill in 5p: minicpm3-4b at model 4, 10 / 10 heads
    cases.append((64 if rehearse else MC_PREFILL_LEN, torch.bfloat16,
                  (1, 2, 2, 96) if rehearse else (1, 10, 10, 96)))
    for L, dt, (B, Hq, Hkv, D) in cases:
        q, k, v = (torch.randn((B, H, L, D), generator=gen, device=device,
                               dtype=torch.float32).to(dt)
                   for H in (Hq, Hkv, Hkv))
        name = str(dt)[6:]
        fn = lambda: ops.attention(q, k, v, causal=True, backend=kb)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=True)
        route, before = design(dt, D), attention_designs()
        want, got = plain(), fn()
        if launch and attention_designs()[route] != before[route] + 1:
            fail(f"flash_attention: the {name} L={L} call did not launch "
                 f"the {route} design")
        label = f"times B{B} Hq{Hq} Hkv{Hkv} L{L} D{D} {name} causal"
        cmp.close("flash_attention", label, got, want, *FA_TOL[dt])
        cmp.rows("flash_attention", label, got, want, ROW_TOL[dt])
        del got
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        flops, nbytes = kcost.attention_work(B, Hq, Hkv, L, L, D, True,
                                             q.element_size())
        rate = BF16_TFLOPS if dt == torch.bfloat16 else F32_TFLOPS
        row = {"kernel": "flash_attention", "B": B, "Hq": Hq, "Hkv": Hkv,
               "L": L, "D": D, "dtype": name, "causal": True,
               # the kernels line's row: the serving prefill's longest prompt
               "kernels_line": dt == torch.bfloat16 and L == lens[1]
               and D not in (80, 96),
               "head_dim_80": D == 80 and Hq == (8 if rehearse else 64),
               "shard_head_dim_80": D == 80 and Hq == (4 if rehearse
                                                        else 16),
               "head_dim_96": D == 96 and Hq == (8 if rehearse else 40),
               "shard_head_dim_96": D == 96 and Hq == (2 if rehearse
                                                        else 10),
               "design": route, "flops": flops, "bytes": nbytes,
               "ms": device_ms(fn, device, 10),
               "call_ms": time_ms(fn, device, 10),
               "plain_ms": time_ms(plain, device, 1, 3),
               "library_ms": device_ms(lib, device, 10),
               "bound_ms": max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3,
               "bound_by": ("operations" if flops / rate
                            >= nbytes / HBM_BYTES_PER_S else "bytes")}
        row["ms_over_library"] = row["ms"] / row["library_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if D in (80, 96):
            old = lambda: fma_kernel(q, k, v, launch)
            row["fma_ms"] = device_ms(old, device, 3)
            row["fma_max_abs_err_vs_plain"] = float(
                (old().float() - want.float()).abs().max())
            row["ms_over_fma"] = row["ms"] / row["fma_ms"]
        rows.append(row)
        log("times", json.dumps(row))
        del q, k, v, want
    # ell_spmm on the table of phase 5e: float32 and bfloat16, each op
    from repro_torch.kernels.ell_spmm import gather_floor_bytes
    R, W = ell.shape
    n, d = feats32.shape
    live = ell >= 0
    ids = ell[live].clamp(max=n - 1).long()      # row-major: ascending j
    need = torch.zeros(n, dtype=torch.bool, device=device)
    need[ids] = True
    distinct = int(need.sum())
    # the yardsticks' inputs, built outside the timed windows: a CSR of the
    # same table for torch.sparse.mm (sum, float32), and for embedding_bag
    # the ids with FILL mapped to padding row n of an (n + 1)-row copy
    crow = torch.zeros(R + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, ids, torch.ones(
        ids.shape[0], dtype=torch.float32, device=device), size=(R, n))
    bag_ids = torch.where(live, ell.clamp(max=n - 1), n)
    del ids, need
    for dt in (torch.float32, torch.bfloat16):
        feats = feats32.to(dt)
        padded = torch.cat([feats, feats.new_zeros((1, d))])
        es = feats.element_size()
        nbytes = kcost.ell_spmm_bytes(R, W, distinct, d, es)
        floor = gather_floor_bytes(ell, n, d, es)
        for op in ("sum", "mean", "max"):
            fn = lambda: ops.ell_aggregate(ell, feats, op, backend=kb)
            plain = lambda: spmm_plain_blocks(ell, feats, op)
            bag = lambda: torch.nn.functional.embedding_bag(
                bag_ids, padded, mode=op, padding_idx=n)
            want = plain()
            lib_err = float((bag().float() - want.float()).abs().max())
            row = {"kernel": "ell_spmm", "R": R, "W": W, "n": n, "d": d,
                   "dtype": str(dt)[6:], "op": op,
                   "kernels_line": dt == torch.float32 and op == "sum",
                   "live_slots": int(live.sum()), "distinct_rows": distinct,
                   "bytes": nbytes, "floor_bytes": floor,
                   "ms": device_ms(fn, device, 5),
                   "call_ms": time_ms(fn, device, 5),
                   "plain_ms": time_ms(plain, device, 1, 3),
                   "library": "embedding_bag",
                   "library_ms": device_ms(bag, device, 5),
                   "library_max_abs_err_vs_plain": lib_err,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "gather_floor_ms": floor / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            if dt == torch.float32 and op == "sum":
                sp = lambda: torch.sparse.mm(csr, feats32)
                row["sparse_mm_ms"] = device_ms(sp, device, 5)
                row["sparse_mm_max_abs_err_vs_plain"] = float(
                    (sp() - want).abs().max())
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["floor_share"] = row["gather_floor_ms"] / row["ms"]
            rows.append(row)
            log("times", json.dumps(row))
            del want
        del feats, padded
    return rows


def check_compact_pass(cmp: Cmp, kernel: str, name: str, n_pad: int, colors,
                       U, small, full, spec):
    """The engine's first compacted repair pass, kernels against plain
    versions on the same inputs, at the shapes the engine gives them
    (``row_ids``; on a graph with an overflow COO also ``forb0`` and
    ``extra_defect``).  From the state after round 0 (``colors``, ``U``)
    the full-width rounds run while |U| exceeds the frontier cap, as in
    ``frontier._compact_repair``; then the compacted pass ``small`` runs
    twice from the same state: on the kernels, and under the
    ``kernel.fallback`` fault site (the plain versions).  Every output must
    be equal; chunk k's inputs are the commits of chunks < k, so equal
    outputs mean every chunk agreed on equal inputs."""
    from repro_torch.core import frontier
    from repro_torch.resilience import faults
    wrapper = launch_counters()[kernel]
    cap = frontier.frontier_cap(n_pad, spec.n_chunks, spec.frontier_frac)
    count, r = int(U.sum()), 1
    while count > cap:
        colors, U, _, _ = full(colors, U, U & (colors < 0))
        count, r = int(U.sum()), r + 1
    if count == 0:
        fail(f"{name}: no frontier left to compact in round {r}")
    idx, live = frontier._compact(U, cap, n_pad)
    before = wrapper.launches
    got = small(colors.clone(), idx, live, count)
    mid = wrapper.launches
    with faults.inject("kernel.fallback"):
        want = small(colors.clone(), idx, live, count)
    if colors.device.type == "cuda" and (mid - before != spec.n_chunks
                                         or wrapper.launches != mid):
        fail(f"{name} compacted pass: {kernel} launched {mid - before} / "
             f"{wrapper.launches - mid} times (kernels / plain), expected "
             f"{spec.n_chunks} / 0")
    label = (f"{name} compacted pass: round {r}, |U| {count}, cap {cap}, "
             f"chunk R{cap // spec.n_chunks}")
    cmp.check(kernel, label,
              [got[0], got[1], got[2].reshape(1), got[3].reshape(1)],
              [want[0], want[1], want[2].reshape(1), want[3].reshape(1)],
              ("colors", "recolored", "n_defects", "ovf"))
    log("times", f"{kernel} {label}: kernels == plain versions")


def wait_checks(checks: dict) -> list:
    """Collect the host checks started in worker processes."""
    done = []
    for what, fut in checks.items():
        if not fut.get():
            fail(f"{what}: the host oracle found the coloring not proper")
        done.append(what)
    return done


def kernels_line(kept, time_rows, model_rows, paths: dict, designs: dict,
                 cmp: Cmp, t1_path: Path, slot_row: dict,
                 slot_path: Path) -> list:
    """The ``kernels`` entries: per coloring kernel, the chunk of the
    largest table its path ran (RMAT-B for the distance-1 kernels, RMAT-ER
    for the two-hop kernel); the attention kernel at the serving prefill's
    longest prompt (L=2048); the aggregation kernel on the RMAT-ER table
    (float32, sum; beside its bound the gather floor, and as its library
    call ``embedding_bag``, with ``torch.sparse.mm``'s time beside it).
    ``launches`` is the count of the path that runs the kernel: phase 5 for
    B1 / B2, 5c for B3, 5d (serve) for the attention kernel, 5e (aggregate)
    for the aggregation kernel; ``paths`` holds every path's counts,
    ``designs`` every path's launches per design (``launches_per_design``:
    the kernel's path).  ``ms_method`` names how ``ms`` was taken:
    ``device`` (calls queued behind a device sleep, ``device_ms``) for
    every kernel; ``call_ms`` is the back-to-back call time (``time_ms``),
    host side included.  ``design`` and ``source`` name the design that
    served the row's shape and its file.  B2's entry holds its detect-only
    form under ``detect_only``: its launches on the Table 1 path (5f), its
    cases, and its times at the full-width shape of RMAT-B's detect pass
    beside the full B2 pass at that shape; and its slot-stride form under
    ``slot_stride``: its launches on the megabatched service's path (5h),
    its cases, and its times at 5h's chunk beside one launch a tenant."""
    csrc = "src/repro_torch/kernels/csrc/"
    largest = {"firstfit": list(kept)[-1], "detect_recolor": list(kept)[-1],
               "twohop_detect_recolor": next(k for k in kept
                                             if k.startswith("rmat_er"))}
    row_of = {r["kernel"]: r for r in time_rows
              if r["graph"] == largest.get(r["kernel"])}
    meta = {"firstfit": ("src/repro/kernels/firstfit.py:48", "main"),
            "detect_recolor": ("src/repro/kernels/detect_recolor.py:54",
                               "main"),
            "twohop_detect_recolor": ("src/repro/kernels/twohop.py:130",
                                      "distance2_compact")}
    source = {("firstfit", "vec16"): "staged_pass.cuh",
              ("firstfit", "direct"): "coloring.cu",
              ("firstfit", None): "coloring.cu",
              ("detect_recolor", "vec16"): "detect_recolor.cu",
              # the rehearsal launches nothing: the entry point's file
              ("detect_recolor", None): "detect_recolor.cu",
              ("twohop_detect_recolor", None): "twohop.cu",
              ("detect_recolor", "direct"): "coloring.cu",
              ("twohop_detect_recolor", "staged16"): "twohop_staged.cu",
              ("twohop_detect_recolor", "staged4"): "twohop_staged.cu",
              ("twohop_detect_recolor", "direct"): "twohop.cu"}
    kernels = []
    for name in COLORING_KERNELS:
        r = row_of[name]
        replaces, path = meta[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + source[name, r.get("design")],
            "replaces": replaces, "launches": paths[path][name],
            **({"design": r["design"],
                "launches_per_design": designs[path][name]}
               if name in designs[path] else {}),
            "max_abs_err": cmp.max_err[name],
            "ms": r["ms"], "ms_method": "device", "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "library_ms_why": "no single PyTorch call computes it",
            "launches_per_path": {p: c[name] for p, c in paths.items()},
            "shape": {k: r[k] for k in ("graph", "R", "W", "n", "C")},
            "cases_checked": len(cmp.cases[name])})
    r = next(x for x in time_rows if x["kernel"] == DETECT_ONLY
             and x["graph"] == largest["detect_recolor"])
    next(k for k in kernels if k["name"] == "detect_recolor")[
        "detect_only"] = {
        "source": csrc + source["detect_recolor", r["design"]],
        "path": "table1", "launches": t1_path.detect["launches"],
        "launches_per_design": {d: v for d, v in t1_path.detect.items()
                                if d != "launches" and v},
        "design": r["design"], "max_abs_err": cmp.max_err[DETECT_ONLY],
        "ms": r["ms"], "ms_method": "device", "call_ms": r["call_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library_ms_why": "no single PyTorch call computes it",
        "full_pass_ms": r["full_pass"]["ms"],
        "full_pass_bound_ms": r["full_pass_bound_ms"],
        "shape": {k: r[k] for k in ("graph", "R", "W", "n", "C")},
        "cases_checked": len(cmp.cases[DETECT_ONLY])}
    r = slot_row
    next(k for k in kernels if k["name"] == "detect_recolor")[
        "slot_stride"] = {
        "source": csrc + source["detect_recolor", r["design"]],
        "path": "service_mega", "launches": slot_path.slots["launches"],
        "launches_per_design": {d: v for d, v in slot_path.slots.items()
                                if d != "launches" and v},
        "design": r["design"], "max_abs_err": cmp.max_err[SLOT_STRIDE],
        "ms": r["ms"], "ms_method": "device", "call_ms": r["call_ms"],
        "per_slot_launches_ms": r["per_slot_launches_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library_ms_why": "no single PyTorch call computes it",
        "shape": {k: r[k] for k in ("graph", "S", "R", "W", "n", "C")},
        "cases_checked": len(cmp.cases[SLOT_STRIDE])}
    fa = next(r for r in model_rows if r.get("kernels_line"))
    d80 = next(r for r in model_rows if r.get("head_dim_80"))
    d96 = next(r for r in model_rows if r.get("head_dim_96"))
    shard80 = next(r for r in model_rows if r.get("shard_head_dim_80"))
    shard96 = next(r for r in model_rows if r.get("shard_head_dim_96"))
    sp = next(r for r in model_rows
              if r["kernel"] == "ell_spmm" and r["kernels_line"])
    fa_src_of = {"sm90": "flash_attention_sm90.cu",
                 "fma": "flash_attention.cu"}
    fa_src = fa_src_of[fa["design"]]
    for name, r, src, replaces, path, shape in (
            ("flash_attention", fa, fa_src,
             "src/repro/kernels/flash_attention.py:58", "serve",
             ("B", "Hq", "Hkv", "L", "D", "dtype", "causal")),
            ("ell_spmm", sp, "ell_spmm.cu", "src/repro/kernels/ell_spmm.py:52",
             "aggregate", ("R", "W", "n", "d", "dtype", "op"))):
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": paths[path][name],
            **({"design": r["design"],
                "launches_per_design": designs[path][name]}
               if name in designs[path] else {}),
            "max_abs_err": cmp.max_err[name],
            **({"max_row_rel_err": cmp.max_row_err[name]}
               if name in cmp.max_row_err else {}),
            "ms": r["ms"],
            "ms_method": "device", "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            **({"gather_floor_ms": r["gather_floor_ms"]}
               if "gather_floor_ms" in r else {}),
            "library_ms": r["library_ms"],
            **({"library": r["library"], "sparse_mm_ms": r["sparse_mm_ms"]}
               if "library" in r else {}),
            "launches_per_path": {p: c[name] for p, c in paths.items()},
            "shape": {k: r[k] for k in shape},
            "cases_checked": len(cmp.cases[name])})
    # D 80 (qwen3-32b, 5k d) and D 96 (minicpm3-4b's MLA, 5m): the sm90
    # design's tail panel, beside the fma kernel that served them before
    fa_line = next(k for k in kernels if k["name"] == "flash_attention")
    # and one shard's attention on the sharded serving paths (5n, 5p)
    for key, r, path in (("head_dim_80", d80, "lm_serve_32b"),
                         ("head_dim_96", d96, "mla_serve"),
                         ("shard_head_dim_80", shard80, "lm_serve_sharded"),
                         ("shard_head_dim_96", shard96,
                          "mla_serve_sharded")):
        per_design = designs.get(path, {}).get("flash_attention", {})
        fa_line[key] = {
            "source": csrc + fa_src_of[r["design"]], "path": path,
            "launches": per_design.get(r["design"], 0),
            "launches_per_design": per_design,
            "design": r["design"], "ms": r["ms"], "ms_method": "device",
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "fma_ms": r["fma_ms"],
            "fma_max_abs_err_vs_plain": r["fma_max_abs_err_vs_plain"],
            "shape": {k: r[k] for k in ("B", "Hq", "Hkv", "L", "D", "dtype",
                                        "causal")}}
    return kernels


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

    # the RMAT and bipartite generators start now, in worker processes, and
    # are collected in phases 5 and 5c; the same workers then run the host
    # oracles of phase 5c; leaving the block terminates the workers
    # whatever happens
    prepared = PreparedCache()
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        rmats = start_rmats(pool, args.rmat_scale)
        bip = pool.apply_async(make_bipartite,
                               (9 if args.rehearse else BIPARTITE_LOG2,))
        # ---- phase 2: build ----
        if launch:
            _build.library()
            # the sources compile side by side: "seconds" (wall, link
            # included) against the sum of "compile_seconds", about what
            # one nvcc over all sources in turn would take
            log("build", json.dumps({
                "library": os.path.relpath(_build.library_path(), HERE),
                "seconds": _build.build_seconds,
                "compile_seconds": _build.compile_seconds}))
            # ptxas -v: registers per kernel variant, and any spills
            regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                               _build.build_log)]
            spills, fn = {}, None
            for line in _build.build_log.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    fn = m.group(1)
                elif "spill" in line and "0 bytes spill stores, 0 bytes " \
                        "spill loads" not in line:
                    spills[fn] = line.strip()
            if regs:
                log("build", f"{len(regs)} kernel variants, {min(regs)}-"
                    f"{max(regs)} registers, {len(spills)} with spills")
            for fn, line in spills.items():
                log("build", f"spills: {fn}: {line}")
            for row in sm90_ptxas(_build.build_log, _build.library()):
                log("build", "ptxas -v, attention sm90 design:",
                    json.dumps(row))
            for row in staged_ptxas(_build.build_log, _build.library()):
                log("build", "ptxas -v, staged pass:", json.dumps(row))
            log("build", "ptxas -v, B1 / B4 variants:",
                json.dumps(ptxas_summary(_build.build_log)))

        # ---- phase 3: kernels vs plain versions ----
        cmp = phase_kernels(device, launch)
        log("kernels", json.dumps({k: len(v) for k, v in cmp.cases.items()}),
            "cases equal to the plain versions (coloring kernels bit for "
            "bit, attention and aggregation within FA_TOL / SPMM_TOL)")
        log("kernels", json.dumps({"shapes_checked": cmp.cases}))

        # ---- phase 4: golden ----
        n_golden = phase_golden(device)
        log("golden", f"{n_golden} runs (distance 1, 2, partial; cat, gm, "
                      f"jp) equal tests/torch_golden.json")
        n_inc, n_svc = phase_golden_dynamic(device)
        log("golden", f"{n_inc} incremental batches and {n_svc} service "
                      f"tenant-steps equal tests/torch_golden.json")
        n_dist, n_shard = phase_golden_mesh(device)
        log("golden", f"{n_dist} distributed runs (rsoc, cat; 1 and 4 "
                      f"shards) and {n_shard} sharded batches equal "
                      f"tests/torch_golden.json")
        lm_golden = phase_golden_lm(device)
        log("golden", f"LM smoke training within {LM_GOLDEN_TOL} of "
                      f"tests/torch_golden.json's lm_train: "
                      f"{json.dumps(lm_golden)}")
        models_golden = phase_golden_models(device)
        log("golden", f"smoke nequip / dcn-v2 within {MODELS_GOLDEN_TOL} of "
                      f"tests/torch_golden.json's models: "
                      f"{json.dumps(models_golden)}")

        # ---- phase 5: main path ----
        if args.rmat_scale != 24:
            log("main", f"RMAT scale {args.rmat_scale}: {RMAT_SCALE_WHY}")
        # (with phase 5f, the paper's Table 1, on each graph in turn)
        (main_rows, kept, main_path, t1_rows, t1_path, kept_cat, inc_rows,
         inc_path, dist_rows, dist_path) = phase_main(rmats, device,
                                                      args.rehearse,
                                                      prepared)
        # every path's calls run with the counts zeroed just before each and
        # read just after (Path.run): a path's launches are its calls' sum
        zeros = zero_designs()
        counts = main_path.counts
        designs = {"main": design_delta(zeros, main_path.designs, counts,
                                        "the main path")}
        log("main", json.dumps({"launches": counts,
                                "launches_per_design": designs["main"]}))
        counts_t1 = t1_path.counts
        designs["table1"] = design_delta(zeros, t1_path.designs, counts_t1,
                                         "the Table 1 path")
        log("table1", json.dumps({
            "launches": counts_t1,
            "launches_per_design": designs["table1"],
            "detect_only_launches": t1_path.detect}))
        designs["incremental"] = design_delta(zeros, inc_path.designs,
                                              inc_path.counts,
                                              "the incremental path")
        log("incremental", json.dumps({
            "launches": inc_path.counts,
            "launches_per_design": designs["incremental"]}))
        designs["distributed"] = design_delta(zeros, dist_path.designs,
                                              dist_path.counts,
                                              "the distributed path")
        log("distributed", json.dumps({
            "launches": dist_path.counts,
            "launches_per_design": designs["distributed"],
            "detect_only_launches": dist_path.detect}))

        # ---- phase 5c: distance-2, partial, compacted ----
        d2_rows, kept_d2, kept_compact, counts_d2, checks = phase_distance2(
            kept, bip, device, args.rehearse, pool, prepared)
        designs["distance2_compact"] = design_delta(
            zeros, design_counts(), counts_d2, "the distance-2 / compacted "
                                               "path")
        log("distance2", json.dumps({
            "launches": counts_d2,
            "launches_per_design": designs["distance2_compact"]}))
        table1 = table1_summary(main_rows, t1_rows, d2_rows)
        for row in table1:
            log("table1", json.dumps(row))

        # ---- phase 5b: plain versions on the card ----
        done = phase_plain(device, kept, prepared)
        log("plain", f"kernel path == plain path on the card for {done}")
        meshes_d2 = {k: v[:2] for k, v in kept_d2.items() if k in D2_MESHES}
        done = phase_plain(device, meshes_d2, prepared, skip=(),
                           distance=2)
        log("plain", f"distance 2: kernel path == plain path on the card for "
                     f"{done}")
        meshes_c = {k: v for k, v in kept_compact.items() if k in D2_MESHES}
        done = phase_plain(device, meshes_c, prepared, skip=(),
                           algorithm="rsoc_compact")
        log("plain", f"rsoc_compact: kernel path == plain path on the card "
                     f"for {done}")
        done = phase_plain(device, kept_cat, prepared, algorithm="cat")
        log("plain", f"cat: kernel path == plain path on the card for "
                     f"{done}")
        del kept_cat

        # ---- phase 5d: serving qwen3-1.7b ----
        serve_row, counts_serve = phase_serve(device, args.rehearse)
        # (the serving phase launches again after reading its counts: its
        # designs were read with them)
        designs["serve"] = design_delta(
            zeros, dict(zeros, flash_attention=serve_row["attention_designs"]),
            counts_serve, "the serving path")
        log("serve", json.dumps({"launches": counts_serve}))

        # ---- phase 5e: ops.ell_aggregate on the RMAT-ER table ----
        rmat_er = next(k for k in kept if k.startswith("rmat_er"))
        agg_row, counts_agg, ell, feats = phase_aggregate(
            device, kept[rmat_er][0], rmat_er, cmp)
        designs["aggregate"] = design_delta(zeros, design_counts(),
                                            counts_agg, "the aggregation path")
        log("aggregate", json.dumps({"launches": counts_agg}))

        # ---- phase 5h: the megabatched multi-tenant service ----
        svc_row, svc_states, counts_svc, svc_path = phase_service(
            device, args.rehearse)
        log("service", json.dumps({"launches": counts_svc,
                                   "slot_stride_launches": svc_path.slots}))

        # ---- phase 5j: GNN training ----
        gnn_row = phase_gnn(device, card, args.rehearse)

        # ---- phase 5k: LM training, qwen3-32b serving ----
        lm_row, counts_lm_train, counts_lm_32b = phase_lm(
            device, card, args.rehearse)
        designs["lm_serve_32b"] = {"flash_attention": lm_row[
            "serve_qwen3_32b"]["attention_designs"]}

        # ---- phase 5l: dcn-v2 and nequip at full width ----
        models_row, counts_models = phase_models(device, card, args.rehearse)

        # ---- phase 5m: MoE and MLA served at full width, trained ----
        (mm_row, counts_mm_serve, mm_designs,
         counts_mm_train) = phase_moe_mla(device, card, cmp, args.rehearse)
        designs["moe_mla_serve"] = design_delta(
            zeros, dict(zeros, flash_attention=mm_designs), counts_mm_serve,
            "the MoE / MLA serving path")
        # minicpm3-4b's own launches: B5 at D 96 (MLA's prefill)
        designs["mla_serve"] = {"flash_attention": mm_row["serve"][
            "minicpm3-4b"]["attention_designs"]}

        # ---- phase 5n: sharded LM serving on a model mesh ----
        sh_row, counts_sh, sh_designs = phase_lm_sharded(device, card,
                                                         args.rehearse)
        designs["lm_serve_sharded"] = {"flash_attention": sh_designs}

        # ---- phase 5o: LM training on the model mesh ----
        tm_row, counts_tm = phase_lm_train_mesh(device, card, args.rehearse)

        # ---- phase 5p: MLA and the GNN / recsys cells on the mesh ----
        mc_row, counts_mc, mc_designs, counts_mc_other = phase_mesh_cells(
            device, card, cmp, args.rehearse)
        designs["mla_serve_sharded"] = {"flash_attention": mc_designs}

        # ---- phase 5q: the dry run against the card; the examples ----
        dr_row, counts_dr, counts_ex = phase_dryrun(device, card,
                                                    args.rehearse)

        # ---- phase 5r: train cells on positions of different devices ----
        td_row = phase_train_devices(device, card, args.rehearse,
                                     tm_row["dense"])

        # ---- phase 6: kernel times ----
        slot_row = phase_times_slots(device, svc_states, cmp, launch)
        del svc_states
        model_rows = phase_times_models(device, ell, feats, cmp, launch,
                                        args.rehearse)
        del ell, feats
        time_rows = phase_times(device, kept, kept_compact, cmp, launch,
                                prepared)
        log("times", json.dumps({
            "prepare_reused": prepared.hits,
            "prepare_seconds_saved": round(prepared.saved_s, 1)}),
            "(phase 5's prepared problems in 5f, 5c, 5b and 6)")
        prepared.drop()
        time_rows += phase_times_twohop(device, kept_d2, cmp, launch)
        if launch:
            torch.cuda.synchronize()
        log("distance2", f"host oracles passed: {wait_checks(checks)}")

    paths = {"main": counts, "table1": counts_t1,
             "incremental": inc_path.counts,
             "distributed": dist_path.counts,
             "distance2_compact": counts_d2,
             "serve": counts_serve, "aggregate": counts_agg, **counts_svc,
             "lm_train": counts_lm_train, "lm_serve_32b": counts_lm_32b,
             "models": counts_models, "moe_mla_serve": counts_mm_serve,
             "moe_mla_train": counts_mm_train,
             "lm_serve_sharded": counts_sh, "lm_train_mesh": counts_tm,
             "mla_serve_sharded": counts_mc, "mesh_cells": counts_mc_other,
             "dryrun": counts_dr,
             **{f"example_{k}": v for k, v in counts_ex.items()}}
    kernels = kernels_line(kept, time_rows, model_rows, paths, designs, cmp,
                           t1_path, slot_row, svc_path)
    if args.rehearse:
        log("kernels", json.dumps(kernels))
        log("rehearsal on the CPU finished; no kernel was built or launched")
        return 3

    # ---- result lines ----
    print(json.dumps({"main_path": main_rows}), flush=True)
    print(json.dumps({"table1": table1, "table1_runs": t1_rows}), flush=True)
    print(json.dumps({"incremental_path": inc_rows}), flush=True)
    print(json.dumps({"distributed_path": dist_rows}), flush=True)
    print(json.dumps({"service_path": svc_row}), flush=True)
    print(json.dumps({"distance2_path": d2_rows}), flush=True)
    print(json.dumps({"serve_path": serve_row}), flush=True)
    print(json.dumps({"aggregate_path": agg_row}), flush=True)
    print(json.dumps({"gnn_train_path": gnn_row}), flush=True)
    print(json.dumps({"lm_path": lm_row}), flush=True)
    print(json.dumps({"models_path": models_row}), flush=True)
    print(json.dumps({"moe_mla_path": mm_row}), flush=True)
    print(json.dumps({"lm_serve_sharded_path": sh_row}), flush=True)
    print(json.dumps({"lm_train_mesh_path": tm_row}), flush=True)
    print(json.dumps({"mesh_cells_path": mc_row}), flush=True)
    print(json.dumps({"dryrun_path": dr_row}), flush=True)
    print(json.dumps({"train_devices_path": td_row}), flush=True)
    print(json.dumps({"kernel_times": time_rows + model_rows + [slot_row]}),
          flush=True)
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
# the Jacobian pattern of phase 5c: 2^20 columns x 2^20 rows, 8 nonzeros per
# column (8.4M), coloured one-sided (mode="partial")
BIPARTITE_LOG2 = 20
RMAT_SCALE_WHY = ("below the paper's 2^24: there the host-side numpy work "
                  "(generation, and one prepare per api.color call) alone "
                  "exceeds this script's time limit, and RMAT-B's ELL table "
                  "at ell_cap=512 (34 GB) plus the pass-start overflow "
                  "snapshot's transients would not fit one 80 GB card")


if __name__ == "__main__":
    sys.exit(main())
