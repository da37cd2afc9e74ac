"""End to end: train a ~100M-param GQA transformer for a few hundred
steps with the full production substrate (data pipeline -> step with grad
accumulation -> async checkpointing -> restart support).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--tiny] [--device cpu]

--tiny shrinks the model so the example finishes in about a minute on a
CPU; the default ~100M config is sized for the card.  Training runs the
plain ``chunked_attention`` (the attention kernel is forward only).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.data.pipeline import TokenStream
from repro_torch.models import transformer as TF
from repro_torch.serving.serve_loop import resolve_device
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import OptimizerConfig


def config(tiny: bool) -> tuple:
    """(cfg, batch, seq) of the example."""
    if tiny:
        return TF.TransformerConfig(
            name="lm-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            head_dim=32, d_ff=512, vocab=2048, qk_norm=True, dtype="float32",
            remat=False, chunk_q=128, chunk_k=128), 8, 128
    # ~100M params: 12L x d512 (GQA 8/4) x ff2048, 32k vocab
    return TF.TransformerConfig(
        name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=32768, qk_norm=True, dtype="float32",
        remat=False, chunk_q=256, chunk_k=256), 16, 256


def main(argv=None, params=None) -> dict:
    """``params``: trainable weights (default: ``init_params`` seed 0 on the
    device).  Returns the loss history and the first / last loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (none: no checkpoints)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="None: the CUDA card (raises without one); cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, batch, seq = config(args.tiny)
    print(f"model {cfg.name}: {cfg.n_params() / 1e6:.1f}M params")
    if params is None:
        params = TF.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, dev, trainable=True)
    stream = TokenStream(batch=batch, seq_len=seq, vocab=cfg.vocab)
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=20,
                              total_steps=args.steps)
    loop_cfg = TL.TrainLoopConfig(total_steps=args.steps, microbatches=2,
                                  ckpt_every=100, ckpt_dir=args.ckpt_dir,
                                  log_every=args.log_every)
    params, _, hist = TL.run(
        lambda p, b: TF.train_step_loss(p, cfg, b), params, stream, opt_cfg,
        loop_cfg, to_device=lambda b: {k: torch.as_tensor(v).to(dev)
                                       for k, v in b.items()},
        on_metrics=lambda m: print(
            f"step {m['step']:4d}  loss {m['loss']:.4f}  "
            f"{m['sec_per_step']:.2f}s/step", flush=True))
    where = f" (checkpoints in {args.ckpt_dir})" if args.ckpt_dir else ""
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {args.steps} steps{where}")
    return {"history": hist, "first_loss": hist[0]["loss"],
            "last_loss": hist[-1]["loss"], "n_params": cfg.n_params()}


if __name__ == "__main__":
    main()
