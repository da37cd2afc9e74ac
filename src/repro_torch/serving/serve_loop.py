"""Batched serving loop: continuous-batching-lite over fixed-capacity slots.

Port of ``src/repro/serving/serve_loop.py``.  The engine holds ``batch``
request slots, each with a fixed-capacity KV cache.  ``submit`` prefills a
prompt into a free slot (on the card: one launch of the attention kernel
per layer); ``step_all`` advances every active slot one token (one
``decode_step`` for the whole batch).  Finished slots (EOS or max tokens)
free at once and are refilled between steps.  The reference jits both
calls; here they run eagerly.  Sampling draws from an explicit
``torch.Generator`` seeded with ``seed`` (not JAX's numbers); greedy
decoding is the same function in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as TF


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: int = -1             # -1: never stops early
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


def resolve_device(device) -> torch.device:
    """``None`` means the card: CUDA, or raise.  The CPU only when asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine(device=None) runs on CUDA and no GPU is "
                "available; pass device='cpu' to run the plain path")
        return torch.device("cuda")
    return torch.device(device)


class ServeEngine:
    def __init__(self, params: TF.TransformerParams,
                 cfg: TF.TransformerConfig, batch: int, max_len: int,
                 greedy: bool = True, seed: int = 0, *, device=None):
        TF.check_supported(cfg)
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"the parameters are on {params.device}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = batch, max_len
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = TF.make_empty_cache(cfg, batch, max_len, self.device)
        self.length = torch.zeros((batch,), dtype=torch.int32,
                                  device=self.device)
        self.cur_token = torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)
        self.active: list[Optional[Request]] = [None] * batch
        self.budget = np.zeros(batch, np.int64)

    # -- slot management ----------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if the engine is full."""
        slots = self.free_slots()
        if not slots:
            return False
        slot = slots[0]
        L = len(req.prompt)
        if not 1 <= L <= self.max_len:
            raise ValueError(f"prompt of {L} tokens for a cache of "
                             f"{self.max_len} slots")
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.device)[None]
        with torch.inference_mode():
            logits, kv = TF.prefill(self.params, self.cfg, tokens)
        # the prefill caches go into the slot's fixed-capacity buffers,
        # along their sequence axis: (layers, 1, L, r) for MLA's latents,
        # (layers, 1, Hkv, L, Dh) for GQA's K / V
        for k, v in kv.items():
            dst = self.cache[k][:, slot]
            dst = dst[:, :L] if self.cfg.attn_type == "mla" else dst[:, :, :L]
            dst.copy_(v[:, 0])
        tok = int(self._pick(logits)[0])
        req.out_tokens.append(tok)
        req.slot = slot
        self.active[slot] = req
        self.length[slot] = L
        self.cur_token[slot] = tok
        self.budget[slot] = req.max_new_tokens - 1
        return True

    def _pick(self, logits):
        """Next tokens (B,) int32: argmax, or a draw from softmax(logits)."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(
            torch.int32)

    # -- decode -------------------------------------------------------------

    def step_all(self) -> int:
        """One batched decode step for all active slots; returns #finished."""
        if all(r is None for r in self.active):
            return 0
        with torch.inference_mode():
            logits, self.cache = TF.decode_step(self.params, self.cfg,
                                                self.cur_token, self.cache,
                                                self.length)
        nxt = self._pick(logits)
        self.length = torch.clamp(self.length + 1, max=self.max_len - 1)
        self.cur_token = nxt
        nxt_np = nxt.cpu().numpy()
        n_done = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt_np[i])
            req.out_tokens.append(tok)
            self.budget[i] -= 1
            if self.budget[i] <= 0 or tok == req.eos_id:
                req.done = True
                self.active[i] = None
                n_done += 1
        return n_done

    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Serve a request list to completion with continuous batching."""
        pending = list(requests)
        steps = 0
        while (pending or any(r is not None for r in self.active)) \
                and steps < max_steps:
            while pending and self.free_slots():
                self.submit(pending.pop(0))
            self.step_all()
            steps += 1
        return requests
