"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the port of the reference's ``python -m repro.launch.train``).

Runs real training on one device: config registry -> data pipeline ->
train step -> checkpointing -> watchdog.  An LM trains its smoke config, or
with ``--full`` its published one, on a ``TokenStream`` of ``--batch``
sequences of ``--seq-len`` tokens (``build_lm``); ``dcn-v2`` its smoke or
full config on a ``RecsysStream`` of ``--batch`` examples
(``build_recsys``).  As in the reference, ``--full`` and ``--seq-len`` do
not change the GNN path: ``gat-cora``, ``meshgraphnet`` and ``gatedgcn``
train their smoke config on ``mesh2d(24, 24)``, ``nequip`` its smoke
config on a ``MoleculeStream`` of ``--batch`` molecules, one batch of which
is drawn before training starts (the reference's ``b0``); a full-width GNN
run goes through the module functions.  ``--device`` defaults to the card
(CUDA, or an error without one); ``--device cpu`` runs on the CPU.

Ported: every arch of the reference, the MoE / MLA LMs
(``minicpm3-4b``, ``phi3.5-moe-42b-a6.6b``, ``qwen2-moe-a2.7b``) among
them.

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
from repro_torch.models import equivariant as EQ
from repro_torch.models import gnn as GNN
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as TF
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import OptimizerConfig


def build_lm(arch_def, smoke: bool, batch: int, seq_len: int, device):
    """(params, stream, loss) of an LM arch (the reference's ``build_lm``):
    its smoke or full config, weights from ``torch.Generator`` seed 0 on
    ``device``, trainable."""
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    gen = torch.Generator(device=device).manual_seed(0)
    params = TF.init_params(gen, cfg, device, trainable=True)
    stream = DP.TokenStream(batch=batch, seq_len=seq_len, vocab=cfg.vocab)
    return params, stream, lambda p, b: TF.train_step_loss(p, cfg, b)


def build_recsys(arch_def, smoke: bool, batch: int, device):
    """(params, stream, loss) of ``dcn-v2`` (the reference's
    ``build_recsys``): its smoke or full config, weights from
    ``torch.Generator`` seed 0 on ``device``, a ``RecsysStream`` of
    ``batch`` examples, the click loss."""
    cfg = arch_def.make_smoke() if smoke else arch_def.make_full()
    gen = torch.Generator(device=device).manual_seed(0)
    params = RS.dcnv2_init(gen, cfg, device)
    stream = DP.RecsysStream(batch=batch, n_dense=cfg.n_dense,
                             n_sparse=cfg.n_sparse, vocabs=cfg.vocabs,
                             max_hots=cfg.max_hots)
    return params, stream, lambda p, b: RS.ctr_loss(p, cfg, b)


def build_gnn(arch_def, device, batch: int = 8):
    """(params, stream, loss) of a GNN arch, as the reference's
    ``build_gnn`` gives for any ``smoke``: its smoke config, on
    ``mesh2d(24, 24)``, or for ``nequip`` on a ``MoleculeStream`` of
    ``batch`` molecules whose first batch is drawn here (the reference's
    ``b0 = next(stream)``: training starts at stream step 1)."""
    from repro_torch.graphs.generators import mesh2d
    model = arch_def.extras["model"]
    gen = torch.Generator(device=device).manual_seed(0)
    if model == "nequip":
        cfg = arch_def.make_smoke()
        stream = DP.MoleculeStream(n_nodes=10, n_edges=24, batch=batch,
                                   n_species=cfg.n_species, d_feat=0)
        next(stream)
        params = EQ.nequip_init(gen, cfg, device)
        return params, stream, lambda p, b: EQ.energy_loss(p, cfg, b)
    cfg = arch_def.make_smoke()
    g = mesh2d(24, 24)
    stream = DP.FullGraphStream(g, d_feat=cfg.d_in,
                                n_classes=getattr(cfg, "n_classes",
                                                  getattr(cfg, "d_out", 3)),
                                pad_edges_to=1024)
    init = {"gat": GNN.gat_init, "mgn": GNN.mgn_init,
            "gatedgcn": GNN.gatedgcn_init}[model]
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
    # --batch sizes the LM, recsys and nequip streams, --seq-len the LM's
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full", action="store_true",
                    help="full config (LMs, dcn-v2; the GNN path trains the "
                         "smoke config either way, as the reference's)")
    ap.add_argument("--step-timeout", type=float, default=10.0,
                    help="abort (exit 75) if a step exceeds this many x the "
                         "trailing-median step time (straggler watchdog)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; an error without a GPU) or cpu")
    args = ap.parse_args(argv)

    arch_def = configs.get(args.arch)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train runs on CUDA by default "
                           "and no GPU is available; pass --device cpu")
    device = _resolve_device(args.device)
    if arch_def.family == "lm":
        params, stream, loss = build_lm(arch_def, not args.full, args.batch,
                                        args.seq_len, device)
    elif arch_def.family == "recsys":
        params, stream, loss = build_recsys(arch_def, not args.full,
                                            args.batch, device)
    else:
        params, stream, loss = build_gnn(arch_def, device, args.batch)

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
