"""Config-driven decoder-only LM: the dense GQA variant (+ optional qk-norm).

Port of ``src/repro/models/transformer.py`` for serving:

  forward(params, cfg, tokens)                  -> (logits, aux)
  prefill(params, cfg, tokens)                  -> (logits_last, caches)
  decode_step(params, cfg, token, cache, length) -> (logits, caches)

The reference stacks the layers on a leading axis and scans over them; here
``TransformerParams.layers`` is an ``nn.ModuleList`` and a Python loop runs
it.  Weights keep the reference's layout (a dense weight is ``(d_in,
d_out)``, applied as ``x @ w``), so ``params_from_reference`` copies arrays
without transposing them.  Caches are fixed-capacity; ``decode_step`` writes
the step's K / V at position ``length`` **in place** (the reference returns
a new cache; the port saves the copy) and returns the same dict.

Only ``attn_type="gqa"`` without ``moe`` is ported; MLA, MoE, the mesh-only
knobs and ``decode_write_then_attend`` raise ``NotImplementedError``.
``remat`` and ``flash_bwd`` are training knobs: accepted and unused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"              # gqa | mla
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    dtype: str = "bfloat16"
    remat: bool = True
    chunk_q: int = 1024
    chunk_k: int = 1024
    # the reference's mesh and performance knobs (see its TransformerConfig)
    wire_barrier: bool = False
    act_shard: bool = False
    act_batch_axes: tuple = ()
    flash_bwd: bool = False
    decode_seq_axis: Optional[str] = None
    decode_write_then_attend: bool = False
    fsdp_inner: bool = False
    model_axis_size: int = 0

    @property
    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.qk_norm, self.rope_theta)

    def n_params(self) -> int:
        """Total parameter count."""
        d, H, Hkv = self.d_model, self.n_heads, self.n_kv_heads
        Dh = self.head_dim
        if self.attn_type == "mla":
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * H * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * m.kv_lora_rank + d * m.qk_rope_dim
                    + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        else:
            attn = d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d
        if self.moe:
            E = self.moe.n_experts
            ffn = E * 3 * d * self.moe.d_ff_expert + d * E
            if self.moe.n_shared:
                d_sh = (self.moe.d_ff_shared
                        or self.moe.d_ff_expert * self.moe.n_shared)
                ffn += 3 * d * d_sh
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (attn + ffn + 2 * d) + self.vocab * d + d


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for a setting the port does not have yet (no silent stand-in)."""
    if cfg.attn_type != "gqa" or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: attn_type={cfg.attn_type!r} (MLA) is not ported "
            f"yet (ROADMAP queue A.5)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue A.5)")
    for knob in ("wire_barrier", "act_shard", "fsdp_inner",
                 "decode_write_then_attend"):
        if getattr(cfg, knob):
            raise NotImplementedError(
                f"{cfg.name}: {knob}=True is a mesh / sharding knob of the "
                f"reference, not ported (ROADMAP queue A.4)")
    if cfg.decode_seq_axis is not None:
        raise NotImplementedError(
            f"{cfg.name}: decode_seq_axis is a mesh knob of the reference, "
            f"not ported (ROADMAP queue A.4)")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module, indexed like the dict:
    ``tree["attn"]["wq"]``.  Leaves are frozen parameters (inference)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]


class TransformerParams(nn.Module):
    """The reference's parameter tree with the stacked ``layers`` axis cut
    into one ``ParamTree`` per layer."""

    def __init__(self, embed: dict, layers: list, final_norm: dict):
        super().__init__()
        self.embed = ParamTree(embed)
        self.layers = nn.ModuleList(ParamTree(lp) for lp in layers)
        self.final_norm = ParamTree(final_norm)

    def __getitem__(self, key):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None) -> TransformerParams:
    """Random weights with the reference's distributions (embedding
    N(0, 0.02²), dense N(0, 1/d_in), norms 1), drawn from ``generator``
    (which must live on ``device``).  Not the reference's numbers: JAX's
    generator differs; ``params_from_reference`` carries those across."""
    check_supported(cfg)
    dt = cfg.torch_dtype
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": L.rmsnorm_init(cfg.d_model, device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.gqa_init(generator, cfg.attn_cfg(), dt, device),
            "ffn": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt,
                                 device)})
    return TransformerParams(
        L.embedding_init(generator, cfg.vocab, cfg.d_model, dt, device),
        layers, L.rmsnorm_init(cfg.d_model, device))


def _tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 ones too, as ``ml_dtypes`` arrays) -> tensor."""
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_reference(cfg: TransformerConfig, tree: dict,
                          device=None) -> TransformerParams:
    """The reference's parameter tree (``repro.models.transformer.
    init_params``), its leaves as numpy arrays, as port parameters: the
    scanned ``layers`` axis is unstacked into per-layer trees, every array
    keeps its layout."""
    check_supported(cfg)

    def conv(t, layer=None):
        if isinstance(t, dict):
            return {k: conv(v, layer) for k, v in t.items()}
        return _tensor(t if layer is None else np.asarray(t)[layer], device)

    n = np.asarray(tree["layers"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"the tree has {n} layers, the config "
                         f"{cfg.n_layers}")
    return TransformerParams(conv(tree["embed"]),
                             [conv(tree["layers"], i) for i in range(n)],
                             conv(tree["final_norm"]))


# --------------------------------------------------------------------------
# forward (a loop over the layers)
# --------------------------------------------------------------------------

def _attend(cfg, lp, xn, positions, kv_cache=None, cache_length=None):
    return L.gqa_attend(lp["attn"], cfg.attn_cfg(), xn, positions,
                        kv_cache=kv_cache, cache_length=cache_length,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)


def _positions(B: int, Lq: int, device) -> torch.Tensor:
    return torch.arange(Lq, dtype=torch.int32, device=device)[None].expand(
        B, Lq)


def forward(params: TransformerParams, cfg: TransformerConfig, tokens):
    """tokens (B, L) -> logits (B, L, vocab), aux loss (0: no MoE)."""
    check_supported(cfg)
    B, Lq = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = _positions(B, Lq, x.device)
    for lp in params.layers:
        h, _ = _attend(cfg, lp, L.rmsnorm(lp["ln1"], x), positions)
        x = x + h
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], x))
    x = L.rmsnorm(params["final_norm"], x)
    return (L.unembed(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def make_empty_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     device=None) -> dict:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def prefill(params: TransformerParams, cfg: TransformerConfig, tokens):
    """tokens (B, L) -> (last-position logits (B, vocab), caches filled to
    L: {"k", "v"} of shape (n_layers, B, Hkv, L, Dh)).  On CUDA tensors each
    layer's attention is one launch of the attention kernel."""
    check_supported(cfg)
    B, Lq = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = _positions(B, Lq, x.device)
    ks, vs = [], []
    for lp in params.layers:
        h, (k, v) = _attend(cfg, lp, L.rmsnorm(lp["ln1"], x), positions)
        x = x + h
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], x))
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(params["final_norm"], x[:, -1:])
    logits = L.unembed(params["embed"], x)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: TransformerParams, cfg: TransformerConfig, token,
                cache: dict, length):
    """token (B,) int; cache dict of (n_layers, B, Hkv, S, Dh); length (B,)
    current valid cache entries.  Returns (logits (B, vocab), cache) — the
    step's K / V are written into ``cache`` in place at ``length``."""
    check_supported(cfg)
    x = L.embed(params["embed"], token[:, None])
    positions = length[:, None]
    for i, lp in enumerate(params.layers):
        kvc = (cache["k"][i], cache["v"][i])
        h, (k, v) = _attend(cfg, lp, L.rmsnorm(lp["ln1"], x), positions,
                            kv_cache=kvc, cache_length=length)
        x = x + h
        x = x + L.swiglu(lp["ffn"], L.rmsnorm(lp["ln2"], x))
        # (B, Hkv, 1, Dh) -> written at [b, :, length[b]]
        _write_at(cache["k"][i], k[:, :, 0], length, axis=2)
        _write_at(cache["v"][i], v[:, :, 0], length, axis=2)
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embed"], x)[:, 0], cache


def _write_at(buf, val, length, axis: int):
    """Write val (B, ...) into buf (B, ..., S, ...) at index length[b]
    (clipped to [0, S - 1]), in place; returns buf.  The reference's
    version builds a new buffer by a one-hot select (a sharding choice)."""
    S = buf.shape[axis]
    idx = length.long().clamp(0, S - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf.movedim(axis, 1)[rows, idx] = val.to(buf.dtype)
    return buf
