"""Batched serving with continuous batching: submit a stream of requests
against fixed-capacity KV-cache slots and drain them.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

On the card every prompt's prefill runs the hand-written attention kernel
(B5: float32, head dim 32, the CUDA-core ``fma`` design); ``--device cpu``
takes the plain path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models import transformer as TF
from repro_torch.serving.serve_loop import Request, ServeEngine, \
    resolve_device

CFG = TF.TransformerConfig(
    name="serve-demo", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=1024, qk_norm=True, dtype="float32",
    remat=False, chunk_q=64, chunk_k=64)


def requests(cfg=CFG, n: int = 12) -> list:
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 24)),
                    max_new_tokens=int(rng.integers(8, 24)))
            for _ in range(n)]


def main(argv=None, params=None) -> dict:
    """``params``: the weights (default: ``init_params`` seed 0 on the
    device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="None: the CUDA card (raises without one); cpu")
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CFG
    if params is None:
        params = TF.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, dev)
    engine = ServeEngine(params, cfg, batch=4, max_len=128, device=dev)
    reqs = requests(cfg, args.requests)
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"{len(reqs)} requests, {tokens} tokens, {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s with batch=4 continuous batching)")
    for r in reqs[:3]:
        print(f"  prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return {"n_requests": len(reqs), "tokens": tokens, "seconds": dt,
            "out_tokens": [list(map(int, r.out_tokens)) for r in reqs]}


if __name__ == "__main__":
    main()
