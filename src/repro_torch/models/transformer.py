"""Config-driven decoder-only LM: dense GQA (+ optional qk-norm), MLA and
MoE (+ shared experts) variants.

Port of ``src/repro/models/transformer.py``:

  forward(params, cfg, tokens)                  -> (logits, aux)
  train_step_loss(params, cfg, batch)           -> scalar loss
  prefill(params, cfg, tokens)                  -> (logits_last, caches)
  decode_step(params, cfg, token, cache, length) -> (logits, caches)

The parameters keep the reference's tree: ``embed``, ``final_norm`` and
``layers``, whose every leaf is stacked on a leading ``n_layers`` axis
(``TransformerParams``), so ``repro_torch.tree`` flattens them to the
reference's paths, order and shapes and a checkpoint crosses packages.  A
Python loop runs the layers over views of the stacked leaves
(``TransformerParams.layer_views``: one ``unbind`` a leaf, whose backward
is one stack of the layers' gradients).  Weights keep the reference's
layout (a dense weight is ``(d_in, d_out)``, applied as ``x @ w``), so
``params_from_reference`` / ``params_to_reference`` copy arrays without
transposing them.

``forward`` is the training route: its attention is ``chunked_attention``
on every device (MLA's too), with the FA-2 backward when ``flash_bwd`` is
set, and with ``remat`` each layer runs under ``torch.utils.checkpoint``
(the reference's ``jax.checkpoint`` of its scan body).  MoE layers add
their aux loss, summed over the layers, to what ``forward`` returns.
``prefill`` is the serving route: on CUDA tensors each layer's attention is
one launch of the attention kernel (MLA's at head dim ``qk_nope_dim +
qk_rope_dim``).  MoE runs over the flattened ``(B·L, d)`` tokens in
``prefill`` and over the ``B`` slots in ``decode_step``, as in the
reference.  Caches are fixed-capacity (GQA: ``k`` / ``v`` of ``(n_layers,
B, Hkv, S, Dh)``; MLA: ``c_kv`` / ``k_rope`` of ``(n_layers, B, S, r)``);
``decode_step`` writes the step's K / V or latents at position ``length``
**in place** (the reference returns a new cache; the port saves the copy)
and returns the same dict; with ``decode_write_then_attend`` it writes
first and attends over the cache as written (the reference's
``body_write_then_attend``), else it attends with the step's own K / V
appended and writes after.

On a mesh ``prefill`` and ``decode_step`` take the tree placed by
``launch.sharding.place(params, mesh, lm_param_spec_tp)`` (a ``Placed``)
and run SPMD, a host loop over the shards (``models/spmd.py``): tensor
parallel attention and FFN, expert parallel MoE (``MoEConfig.ep_axes``),
and decode over a sequence-sharded cache (``decode_seq_axis``).
``forward`` and ``train_step_loss`` take a placed tree in the storage
layout (``lm_param_spec``: FSDP over ``data``, TP over ``model``) and
train on it: ``fsdp_inner`` moves each layer to the compute layout inside
its body, ``act_shard`` holds the residual stream as sequence blocks.  On
one device (a ``TransformerParams``) the reference's mesh knobs change no
value and are accepted: ``wire_barrier`` (the port's partial sums already
cross the mesh in the activation dtype), ``decode_seq_axis``, ``ep_axes``,
``act_shard`` and ``fsdp_inner``.  MLA configs run on a mesh too
(``models/spmd.py``'s ``_mla_*``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE


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
    moe: Optional[MOE.MoEConfig] = None
    mla: Optional[MLA.MLAConfig] = None
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

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        E, k = self.moe.n_experts, self.moe.top_k
        expert_p = 3 * d * self.moe.d_ff_expert
        return full - self.n_layers * (E - k) * expert_p


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict (or list) of tensors as a module, indexed like the
    container it holds: ``tree["attn"]["wq"]``, ``tree["blocks"][0]["A"]``.
    Leaves are parameters, frozen (inference) unless ``trainable``.  A list
    keeps its order and iterates over its items; a dict iterates over its
    keys, in the order given."""

    def __init__(self, tree, trainable: bool = False):
        super().__init__()
        self.is_list = isinstance(tree, (list, tuple))
        for key, val in (enumerate(tree) if self.is_list else tree.items()):
            if isinstance(val, (dict, list, tuple)):
                self.add_module(str(key), ParamTree(val, trainable))
            else:
                self.register_parameter(
                    str(key), nn.Parameter(val, requires_grad=trainable))

    def keys(self) -> list:
        return list(self._parameters) + list(self._modules)

    def __getitem__(self, key):
        key = str(key)
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key) -> bool:
        return str(key) in self._parameters or str(key) in self._modules

    def __len__(self) -> int:
        return len(self._parameters) + len(self._modules)

    def __iter__(self):
        if self.is_list:
            return (self[i] for i in range(len(self)))
        return iter(self.keys())


class TransformerParams(nn.Module):
    """The reference's parameter tree: ``embed``, ``layers`` (every leaf
    stacked on a leading ``n_layers`` axis) and ``final_norm``, each a
    ``ParamTree``; a dict to ``repro_torch.tree``.  Leaves are frozen
    (inference) unless ``trainable``."""

    is_list = False

    def __init__(self, embed: dict, layers: dict, final_norm: dict,
                 trainable: bool = False):
        super().__init__()
        self.embed = ParamTree(embed, trainable)
        self.layers = ParamTree(layers, trainable)
        self.final_norm = ParamTree(final_norm, trainable)

    def keys(self) -> list:
        return ["embed", "final_norm", "layers"]

    def __getitem__(self, key):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    @property
    def n_layers(self) -> int:
        return self.layers["ln1"]["scale"].shape[0]

    def layer_views(self) -> list:
        """One nested dict of views a layer: each stacked leaf ``unbind``-ed
        once, so autograd sees one node a leaf (its backward stacks the
        layers' gradients) rather than one full-size scatter a layer."""
        def split(t):
            if isinstance(t, torch.Tensor):
                return t.unbind(0)
            parts = {k: split(t[k]) for k in t.keys()}
            return [{k: v[i] for k, v in parts.items()}
                    for i in range(self.n_layers)]
        return split(self.layers)


def _stacked(make_layer, n: int) -> dict:
    """``make_layer()`` called ``n`` times in turn (the reference's draw
    order a layer), each leaf written into its ``(n, ...)`` stack."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    first = make_layer()
    out = alloc(first)
    put(out, first, 0)
    for i in range(1, n):
        put(out, make_layer(), i)
    return out


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None, trainable: bool = False) -> TransformerParams:
    """Random weights with the reference's distributions (embedding
    N(0, 0.02²), dense N(0, 1/d_in), norms 1), drawn from ``generator``
    (which must live on ``device``).  Not the reference's numbers: JAX's
    generator differs; ``params_from_reference`` carries those across."""
    dt = cfg.torch_dtype

    def layer():
        p = {"ln1": L.rmsnorm_init(cfg.d_model, device),
             "ln2": L.rmsnorm_init(cfg.d_model, device)}
        if cfg.attn_type == "mla":
            p["attn"] = MLA.mla_init(generator, cfg.mla, dt, device)
        else:
            p["attn"] = L.gqa_init(generator, cfg.attn_cfg(), dt, device)
        if cfg.moe:
            p["ffn"] = MOE.moe_init(generator, cfg.d_model, cfg.moe, dt,
                                    device)
        else:
            p["ffn"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt,
                                     device)
        return p
    layers = _stacked(layer, cfg.n_layers)
    return TransformerParams(
        L.embedding_init(generator, cfg.vocab, cfg.d_model, dt, device),
        layers, L.rmsnorm_init(cfg.d_model, device), trainable)


def _tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 ones too, as ``ml_dtypes`` arrays) -> tensor."""
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_reference(cfg: TransformerConfig, tree: dict,
                          device=None, trainable: bool = False
                          ) -> TransformerParams:
    """The reference's parameter tree (``repro.models.transformer.
    init_params``), its leaves as numpy arrays, as port parameters: every
    array keeps its shape (``layers`` stacked) and layout."""

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, device)

    n = np.asarray(tree["layers"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"the tree has {n} layers, the config "
                         f"{cfg.n_layers}")
    return TransformerParams(conv(tree["embed"]), conv(tree["layers"]),
                             conv(tree["final_norm"]), trainable)


def params_to_reference(params: TransformerParams) -> dict:
    """The inverse of ``params_from_reference``: the tree as nested dicts of
    numpy arrays in the reference's layout (``layers`` stacked).  A
    bfloat16 leaf comes back as float32 holding the same values (numpy has
    no bfloat16; ``astype`` to it is exact)."""
    def conv(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().to("cpu")
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return {k: conv(t[k]) for k in t.keys()}
    return conv(params)


# --------------------------------------------------------------------------
# forward (a loop over the layers)
# --------------------------------------------------------------------------

def _attend(cfg, lp, xn, positions, kv_cache=None, cache_length=None,
            training: bool = False):
    if cfg.attn_type == "mla":
        if kv_cache is not None and xn.shape[1] == 1:
            return MLA.mla_attend_decode(lp["attn"], cfg.mla, xn, positions,
                                         kv_cache, cache_length)
        return MLA.mla_attend_prefill(lp["attn"], cfg.mla, xn, positions,
                                      chunk_q=cfg.chunk_q,
                                      chunk_k=cfg.chunk_k, training=training,
                                      flash_bwd=cfg.flash_bwd)
    return L.gqa_attend(lp["attn"], cfg.attn_cfg(), xn, positions,
                        kv_cache=kv_cache, cache_length=cache_length,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k,
                        training=training, flash_bwd=cfg.flash_bwd)


def _positions(B: int, Lq: int, device) -> torch.Tensor:
    return torch.arange(Lq, dtype=torch.int32, device=device)[None].expand(
        B, Lq)


def _ffn(cfg, lp, x):
    """The layer's FFN on the residual stream x (B, L, d): (y, aux), aux
    None without MoE; MoE runs over the flattened (B·L, d) tokens."""
    xn = L.rmsnorm(lp["ln2"], x)
    if not cfg.moe:
        return L.swiglu(lp["ffn"], xn), None
    B, Lq, d = x.shape
    y, aux = MOE.moe_apply(lp["ffn"], cfg.moe, xn.reshape(B * Lq, d))
    return y.reshape(B, Lq, d), aux


def _layer_fwd(cfg, lp, x, positions):
    """One layer of the training route: (x, the layer's aux loss or
    None)."""
    h, _ = _attend(cfg, lp, L.rmsnorm(lp["ln1"], x), positions,
                   training=True)
    x = x + h
    y, aux = _ffn(cfg, lp, x)
    return x + y, aux


def forward(params: TransformerParams, cfg: TransformerConfig, tokens):
    """tokens (B, L) -> logits (B, L, vocab), aux loss (float32: the MoE
    layers' sum in layer order; 0 without MoE).  The training route:
    ``chunked_attention`` on every device; with ``remat`` (and grad mode
    on) each layer's activations are recomputed in the backward.  On a
    ``Placed`` tree, in any layout, the sharded training route
    (``spmd.forward``)."""
    if not isinstance(params, TransformerParams):
        from repro_torch.models import spmd
        return spmd.forward(params, cfg, tokens)
    B, Lq = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = _positions(B, Lq, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.layer_views():
        if remat:
            x, a = checkpoint(_layer_fwd, cfg, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, lp, x, positions)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embed"], x), aux


def train_step_loss(params: TransformerParams, cfg: TransformerConfig,
                    batch: dict):
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]``, plus the aux loss.  On a ``Placed`` tree (the
    storage layout of a train cell), the sharded route's vocab-parallel
    loss (``spmd.train_step_loss``)."""
    if not isinstance(params, TransformerParams):
        from repro_torch.models import spmd
        return spmd.train_step_loss(params, cfg, batch)
    logits, aux = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"]) + aux


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def make_empty_cache(cfg: TransformerConfig, batch: int, max_len: int,
                     device=None) -> dict:
    if cfg.attn_type == "mla":
        m, dt = cfg.mla, cfg.torch_dtype
        return {"c_kv": torch.zeros((cfg.n_layers, batch, max_len,
                                     m.kv_lora_rank), dtype=dt, device=device),
                "k_rope": torch.zeros((cfg.n_layers, batch, max_len,
                                       m.qk_rope_dim), dtype=dt,
                                      device=device)}
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def prefill(params: TransformerParams, cfg: TransformerConfig, tokens):
    """tokens (B, L) -> (last-position logits (B, vocab), caches filled to
    L: GQA's {"k", "v"} of shape (n_layers, B, Hkv, L, Dh), MLA's
    {"c_kv", "k_rope"} of (n_layers, B, L, r) / (n_layers, B, L, dr)).  On
    CUDA tensors each layer's attention is one launch of the attention
    kernel.  On a ``Placed`` tree, the sharded route (``spmd.prefill``),
    whose caches come back placed by ``lm_cache_spec``."""
    if not isinstance(params, TransformerParams):
        from repro_torch.models import spmd
        return spmd.prefill(params, cfg, tokens)
    B, Lq = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = _positions(B, Lq, x.device)
    ks, vs = [], []
    for lp in params.layer_views():
        h, (k, v) = _attend(cfg, lp, L.rmsnorm(lp["ln1"], x), positions)
        x = x + h
        x = x + _ffn(cfg, lp, x)[0]
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(params["final_norm"], x[:, -1:])
    logits = L.unembed(params["embed"], x)[:, 0]
    keys = ("c_kv", "k_rope") if cfg.attn_type == "mla" else ("k", "v")
    return logits, {keys[0]: torch.stack(ks), keys[1]: torch.stack(vs)}


def decode_step(params: TransformerParams, cfg: TransformerConfig, token,
                cache: dict, length):
    """token (B,) int; cache dict of (n_layers, B, ...) (``make_empty_
    cache``); length (B,) current valid cache entries.  Returns (logits (B,
    vocab), cache) — the step's K / V (MLA: latents) are written into
    ``cache`` in place at ``length``.  On a ``Placed`` tree and cache, the
    sharded route (``spmd.decode_step``)."""
    if not isinstance(params, TransformerParams):
        from repro_torch.models import spmd
        return spmd.decode_step(params, cfg, token, cache, length)
    x = L.embed(params["embed"], token[:, None])
    positions = length[:, None]
    mla = cfg.attn_type == "mla"
    keys = ("c_kv", "k_rope") if mla else ("k", "v")
    for i, lp in enumerate(params.layer_views()):
        bufs = (cache[keys[0]][i], cache[keys[1]][i])
        xn = L.rmsnorm(lp["ln1"], x)
        if cfg.decode_write_then_attend:
            h = _write_then_attend(cfg, lp, xn, positions, bufs, length)
        else:
            h, new = _attend(cfg, lp, xn, positions, kv_cache=bufs,
                             cache_length=length)
        x = x + h
        x = x + _ffn(cfg, lp, x)[0]
        if not cfg.decode_write_then_attend:
            _write_step(cfg, bufs, new, length)
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embed"], x)[:, 0], cache


def _write_step(cfg, bufs, new, length) -> None:
    """Write a step's K / V ((B, Hkv, 1, Dh) each) or latents ((B, 1, r)
    each) into a layer's cache buffers at ``length``."""
    for buf, val in zip(bufs, new):
        if cfg.attn_type == "mla":  # (B, 1, r) -> written at [b, length[b]]
            _write_at(buf, val[:, 0], length, axis=1)
        else:           # (B, Hkv, 1, Dh) -> written at [b, :, length[b]]
            _write_at(buf, val[:, :, 0], length, axis=2)


def _write_then_attend(cfg, lp, xn, positions, bufs, length):
    """The reference's ``body_write_then_attend`` on one device: this step's
    K / V (latents) written at ``length`` first, then attention over the
    cache as written, ``length + 1`` slots visible."""
    if cfg.attn_type == "mla":
        _write_step(cfg, bufs, MLA.mla_latents(lp["attn"], cfg.mla, xn,
                                               positions), length)
        return MLA.mla_attend_decode(lp["attn"], cfg.mla, xn, positions,
                                     bufs, length + 1, prewritten=True)[0]
    acfg = cfg.attn_cfg()
    q, k, v = L.gqa_project_qkv(lp["attn"], acfg, xn, positions)
    _write_step(cfg, bufs, (k, v), length)
    o = L.decode_attention(q, bufs[0], bufs[1], length=length + 1,
                           extra_slot=False)
    o = o.transpose(1, 2).reshape(xn.shape[0], 1,
                                  acfg.n_heads * acfg.head_dim)
    return o @ lp["attn"]["wo"]


def _write_at(buf, val, length, axis: int):
    """Write val (B, ...) into buf (B, ..., S, ...) at index length[b]
    (clipped to [0, S - 1]), in place; returns buf.  The reference's
    version builds a new buffer by a one-hot select (a sharding choice)."""
    S = buf.shape[axis]
    idx = length.long().clamp(0, S - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf.movedim(axis, 1)[rows, idx] = val.to(buf.dtype)
    return buf
