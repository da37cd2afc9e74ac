"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the port of the reference's ``python -m repro.launch.train``).

Runs real training on one device: config registry -> data pipeline ->
train step -> checkpointing -> watchdog.  An LM trains its smoke config, or
with ``--full`` its published one, on a ``TokenStream`` of ``--batch``
sequences of ``--seq-len`` tokens (``build_lm``).  As in the reference,
``--full``, ``--batch`` and ``--seq-len`` do not change the GNN path (it
always trains the smoke config on ``mesh2d(24, 24)``); a full-width GNN run
goes through the module functions.  ``--device`` defaults to the card
(CUDA, or an error without one); ``--device cpu`` runs on the CPU.

Ported families: the LMs ``qwen3-1.7b`` and ``qwen3-32b`` and the GNNs
``gat-cora``, ``meshgraphnet`` and ``gatedgcn``.  Recsys training and
``nequip`` raise ``NotImplementedError`` naming their ROADMAP item.

Fault-tolerance wiring (the reference's):
  * checkpoint every --ckpt-every steps (async, atomic) + data-stream state;
  * crash/restart: rerun the same command; it resumes from LATEST
    (bitwise-identical stream continuation — counter-based RNG);
  * straggler watchdog: if a step exceeds --step-timeout x the trailing
    median, the launcher exits with code 75 so the job manager relaunches
    from LATEST;
  * elastic restart: checkpoints hold full logical arrays
    (training/elastic.py).
"""
from __future__ import annotations

import argparse
import statistics
import sys

import torch

from repro_torch import configs
from repro_torch.api import _resolve_device
from repro_torch.data import pipeline as DP
from repro_torch.models import gnn as GNN
from repro_torch.models import transformer as TF
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import OptimizerConfig

_NOT_PORTED_FAMILIES = {
    "recsys": "recsys training is not ported yet (ROADMAP queue A.5.3: "
              "models/recsys.py with dcn_v2)",
}


def build_lm(arch_def, smoke: bool, batch: int, seq_len: int, device):
    """(params, stream, loss) of an LM arch (the reference's ``build_lm``):
    its smoke or full config, weights from ``torch.Generator`` seed 0 on
    ``device``, trainable."""
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    gen = torch.Generator(device=device).manual_seed(0)
    params = TF.init_params(gen, cfg, device, trainable=True)
    stream = DP.TokenStream(batch=batch, seq_len=seq_len, vocab=cfg.vocab)
    return params, stream, lambda p, b: TF.train_step_loss(p, cfg, b)


def build_gnn(arch_def, device):
    """(params, stream, loss) of a GNN arch: its smoke config on
    ``mesh2d(24, 24)``, as the reference's ``build_gnn`` gives for any
    ``smoke`` / ``batch``."""
    from repro_torch.graphs.generators import mesh2d
    model = arch_def.extras["model"]
    if model == "nequip":
        raise NotImplementedError(configs.NOT_PORTED["nequip"])
    cfg = arch_def.make_smoke()
    g = mesh2d(24, 24)
    stream = DP.FullGraphStream(g, d_feat=cfg.d_in,
                                n_classes=getattr(cfg, "n_classes",
                                                  getattr(cfg, "d_out", 3)),
                                pad_edges_to=1024)
    init = {"gat": GNN.gat_init, "mgn": GNN.mgn_init,
            "gatedgcn": GNN.gatedgcn_init}[model]
    gen = torch.Generator(device=device).manual_seed(0)
    params = init(gen, cfg, device)
    shp = {"mode": "full", "d_feat": cfg.d_in, "n_classes": 3}
    loss_fn = GNN.gnn_loss_fn(arch_def, shp, cfg, g.n_vertices + 1)

    def loss(p, b):
        if model == "mgn" and "edge_feats" not in b:
            b = dict(b, edge_feats=torch.zeros(
                (b["src"].shape[0], 4), dtype=torch.float32,
                device=b["src"].device))
        return loss_fn(p, b)
    return params, stream, loss


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    # --batch and --seq-len size the LM stream
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full", action="store_true",
                    help="full config (LMs; the GNN path trains the smoke "
                         "config either way, as the reference's)")
    ap.add_argument("--step-timeout", type=float, default=10.0,
                    help="abort (exit 75) if a step exceeds this many x the "
                         "trailing-median step time (straggler watchdog)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; an error without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.arch in configs.NOT_PORTED:
        raise NotImplementedError(f"{args.arch}: "
                                  f"{configs.NOT_PORTED[args.arch]}")
    arch_def = configs.get(args.arch)
    if arch_def.family in _NOT_PORTED_FAMILIES:
        raise NotImplementedError(f"{args.arch}: "
                                  f"{_NOT_PORTED_FAMILIES[arch_def.family]}")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train runs on CUDA by default "
                           "and no GPU is available; pass --device cpu")
    device = _resolve_device(args.device)
    if arch_def.family == "lm":
        params, stream, loss = build_lm(arch_def, not args.full, args.batch,
                                        args.seq_len, device)
    else:
        params, stream, loss = build_gnn(arch_def, device)

    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    loop_cfg = TL.TrainLoopConfig(
        total_steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, log_every=5)

    times = []

    def watchdog(m):
        print(f"  step {m['step']:5d} loss {m['loss']:.4f} "
              f"({m['sec_per_step']:.3f}s/step)", flush=True)
        times.append(m["sec_per_step"])
        if len(times) >= 5:
            med = statistics.median(times[-20:])
            if times[-1] > args.step_timeout * med:
                print(f"WATCHDOG: step took {times[-1]:.1f}s "
                      f"(> {args.step_timeout}x median {med:.1f}s); "
                      "exiting 75 for relaunch-from-LATEST", file=sys.stderr)
                raise SystemExit(75)

    params, _, hist = TL.run(loss, params, stream, opt_cfg, loop_cfg,
                             to_device=lambda b: to_device(b, device),
                             on_metrics=watchdog)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} after {args.steps} steps "
              f"(device={device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
