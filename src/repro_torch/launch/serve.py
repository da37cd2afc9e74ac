"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Spins up the batched ``ServeEngine`` on the arch's smoke config with random
weights (seed 0) and runs a request stream through it, as the reference's
``python -m repro.launch.serve`` does.  ``--device`` defaults to the card
(CUDA, or an error without one); ``--device cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer as TF
from repro_torch.serving.serve_loop import (Request, ServeEngine,
                                            resolve_device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; an error without a GPU) or cpu")
    args = ap.parse_args(argv)

    arch_def = configs.get(args.arch)
    if arch_def.family != "lm":
        raise SystemExit("serving applies to LM archs")
    cfg = arch_def.make_smoke()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = TF.init_params(gen, cfg, device)
    eng = ServeEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                      device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 32)),
                    max_new_tokens=args.max_new_tokens)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, batch={args.batch}, device={device})")
    if not all(r.done for r in reqs):
        raise SystemExit("not every request finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
