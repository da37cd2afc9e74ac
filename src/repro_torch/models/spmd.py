"""The LM on a model mesh: the serving route, ``prefill`` and
``decode_step`` on a tree placed by ``launch.sharding.place(params, mesh,
lm_param_spec_tp)``, and the training route, ``forward`` and
``train_step_loss`` on a tree stored by ``lm_param_spec``.

The reference runs these functions under GSPMD: the same program, its
arrays laid out by the sharding rules, the compiler inserting the
collectives.  The port runs them SPMD as ``core/distributed.py`` runs the
coloring engines: a host loop over the mesh positions, each computing on
its own blocks on its own device, and explicit collectives
(``core.mesh.psum`` / ``all_gather_groups``) where the blocks meet.  Every
value equals the reference's, which computes the same function unsharded,
up to the order of float sums (tensor-parallel partial sums, the decode's
log-sum-exp merge).

Layout, from ``lm_param_spec_tp`` (``model`` below is whatever axes the
sanitized spec names):

* Embedding: vocab rows over ``model``: a masked lookup of the shard's
  rows, then ``psum``.  Logits: each shard's vocab columns, gathered.
* Attention: ``wq`` / ``wk`` / ``wv`` split by columns, ``wo`` by rows, its
  partial products ``psum``-ed.  In prefill a shard computes its own whole
  heads, one attention launch (B5 on the card) on them.  Where the split
  cuts a head (the heads do not divide over ``model``), the weight is
  gathered first (a collective) and the shard computes every query head,
  or every K / V head, itself: no split head is ever computed.
* FFN: SwiGLU's gate / up by columns, down by rows, one ``psum``.  MoE
  (``moe_apply_sharded``): experts over ``model``, with
  ``ep_axes=("model", "data")`` the dispatch buffer's capacity slots over
  ``data`` too.
* Batch: the tokens' rows over the data axes (``lm_batch_spec``).
* Caches: ``lm_cache_spec``: sequence over ``model`` (every axis when the
  batch is smaller than the data axes).  ``prefill`` gathers each layer's
  K / V heads and keeps the shard's sequence block (a reshard from heads to
  sequence).  ``decode_step`` computes q and the step's K / V for every
  head (its projections' columns gathered: "replicated"), writes K / V
  into the shard that owns slot ``length[b]``, and attends by
  flash-decoding (``layers.decode_attention(..., seq_axis=)``).  With
  ``decode_write_then_attend`` the write comes first; without, the step's
  own K / V join the merge as one more block and the write comes after.

MLA (``_mla_*``): ``lm_param_spec_tp`` splits the three latent projections
``w_dq`` / ``w_dkv`` / ``w_kr`` by their output columns, and their outputs
go through an rmsnorm over the whole rank or the rope over the whole of dr,
so each position gathers the products' columns first.  ``w_uq`` /
``w_uk`` / ``w_uv`` are per-head column blocks: a position computes its own
heads (in prefill one attention launch on them, B5 at head dim dn + dr on
the card, V zero-padded), or every head from the gathered weights where the
split would cut a head.  ``w_o``'s path has no ``wo``, so it is split by its
output columns (d): the heads' outputs are gathered, each position takes
its column block of the product, and the blocks are gathered.  The latent
cache holds its sequence at dim 2; ``prefill`` keeps each position's
sequence block of the whole latents, and ``decode_step`` writes the step's
latents (computed whole on every position) into the owning block and runs
the absorbed decode by blocks: the softmax's max and sum merged by
log-sum-exp first, so that each block's probabilities are normalised
before the reference's cast, then the blocks' ``o_c`` summed
(``models/mla.py``).

Logits come back as one (B, vocab) tensor on the first shard's device (a
fetch to the caller, not counted); caches as a ``Placed``.

Training (the reference's ``_lm_train_cell`` loss, ``launch/cells.py``
takes the step): the stored tree goes to the compute layout by
``launch.sharding.reshard`` — the whole tree at the start, or with
``fsdp_inner`` each layer inside its body, which ``remat`` wraps in
``torch.utils.checkpoint`` so the gathered weights are freed and gathered
again in the backward.  Attention is the training attention
(``chunked_attention``, ``flash_bwd`` as configured), never the
forward-only kernel.  With ``act_shard`` the residual stream is held as
sequence blocks over ``model``, all-gathered before a layer's products,
and the ``wo`` / ``w_down`` partial sums are ``psum_scatter``-ed.  MoE
adds the switch aux loss over the global tokens.  The loss is
vocab-parallel: a shard's logits of its vocab block give a log-sum-exp,
merged by one gather of (B_loc, L) floats; the label's logit is a masked
pick, ``psum``-ed; so no position holds (B, L, vocab) logits.  Every
position ends with the same scalar and the backward starts from the first
position's, so the global loss counts once; autograd takes it through the
collectives to every distinct stored block.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mesh as M
from repro_torch.core.mesh import Sharded
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.scatter import gather


def _path(*keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _layer_views(t, n: int) -> list:
    """Per layer, its views of a tree of stacked leaves: one ``unbind`` a
    leaf (under autograd one node, whose backward stacks the layers'
    gradients, not one full-size scatter a layer)."""
    if isinstance(t, torch.Tensor):
        return t.unbind(0)
    parts = {k: _layer_views(v, n) for k, v in t.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class _Run:
    """One call's view of a placed tree: blocks by position and layer, and
    the axes each leaf is split over."""

    def __init__(self, placed: SH.Placed, cfg=None):
        self.p, self.cfg, self.mesh = placed, cfg, placed.mesh
        self.positions = range(self.mesh.size)
        # every leaf under "layers" is stacked on the layer axis
        n = next((s[0] for p, s in placed.shapes.items()
                  if p.startswith("['layers']")), 0)
        self.n_layers = n
        self.views = [_layer_views(sh["layers"], n) if n else []
                      for sh in placed.shards]

    def leaf(self, pos: int, *keys):
        t = self.p.shards[pos]
        for k in keys:
            t = t[k]
        return t

    def layer(self, pos: int, i: int, *keys):
        t = self.views[pos][i]
        for k in keys:
            t = t[k]
        return t

    def split(self, keys, dim: int) -> tuple:
        return self.p.split(_path(*keys), dim)

    def range(self, keys, dim: int, pos: int) -> tuple:
        return self.p.range(_path(*keys), dim, pos)


def _batch_rows(mesh, x, spec) -> list:
    """Per position, its rows of ``x`` (a global tensor, split on dim 0 by
    the sanitized ``spec``, or a ``Placed`` tensor already split)."""
    if isinstance(x, SH.Placed):
        return list(x.shards)
    spec = SH.sanitize_spec(spec, tuple(x.shape), mesh)
    return [x[slice(*SH.block_range(mesh, spec, tuple(x.shape), 0, pos))].to(
        mesh.devices[pos]) for pos in range(mesh.size)]


def _assemble(mesh, blocks, spec, shape):
    """The global tensor of per-position row blocks, on the first shard's
    device."""
    spec = SH.sanitize_spec(spec, shape, mesh)
    out = torch.empty(shape, dtype=blocks[0].dtype, device=mesh.devices[0])
    for pos, b in enumerate(blocks):
        out[slice(*SH.block_range(mesh, spec, shape, 0, pos))] = b.to(
            out.device)
    return out


# --------------------------------------------------------------------------
# the tensor-parallel pieces
# --------------------------------------------------------------------------

def _embed(run: _Run, toks: list, seq_axes=()) -> list:
    keys = ("embed", "table")
    axes = run.split(keys, 0)
    out = []
    for pos in run.positions:
        tab = run.leaf(pos, *keys)
        t = toks[pos].long() - run.range(keys, 0, pos)[0]
        hit = (t >= 0) & (t < tab.shape[0])
        out.append(tab[t.clamp(0, tab.shape[0] - 1)]
                   * hit[..., None].to(tab.dtype))
    return _reduce(run.mesh, axes, out, seq_axes)


def _reduce(mesh, axes, parts: list, seq_axes=()) -> list:
    """The sum over ``axes`` of per-position partial results (B, L, ...):
    whole (``psum``), or with ``act_shard``'s sequence split over
    ``seq_axes`` each position's sequence block — ``psum_scatter`` where the
    two axes agree, else the sum cut."""
    if not seq_axes:
        return M.psum(mesh, axes, parts)
    if tuple(axes) == tuple(seq_axes):
        return M.psum_scatter(mesh, axes, parts, 1)
    return [_seq_block(mesh, seq_axes, t, pos)
            for pos, t in enumerate(M.psum(mesh, axes, parts))]


def _seq_block(mesh, seq_axes, x, pos: int):
    """Position ``pos``'s block of the sequence (dim 1) of x."""
    n = len(mesh.groups(seq_axes)[0])
    blk = x.shape[1] // n
    return x.narrow(1, mesh.group_index(pos, seq_axes) * blk, blk)


def _seq_gather(mesh, seq_axes, xs: list) -> list:
    """The whole sequence from the positions' blocks (B, L / n, ...): one
    all-gather over ``seq_axes`` (its backward the reduce-scatter)."""
    if not seq_axes:
        return xs
    return [g.movedim(0, 1).reshape(g.shape[1], -1, *g.shape[3:])
            for g in M.all_gather_groups(mesh, seq_axes, xs)]


def _unembed(run: _Run, xs: list) -> list:
    keys = ("embed", "table")
    part = [x @ run.leaf(pos, *keys).T.to(x.dtype)
            for pos, x in enumerate(xs)]
    return _concat_gathered(run.mesh, run.split(keys, 0), part)


def _concat_gathered(mesh, axes, parts: list) -> list:
    """Column blocks (..., c) a position -> (..., n·c) in group order."""
    if not axes:
        return parts
    return [g.movedim(0, -2).reshape(*g.shape[1:-1], -1)
            for g in M.all_gather_groups(mesh, axes, parts)]


def _cols_full(run: _Run, i: int, keys_list, xs: list) -> list:
    """Per position, ``[x @ w for w in keys_list]`` with every column: each
    shard's column blocks, gathered over each projection's own split axes
    (one gather for the projections that share them: ``wq`` may be split
    where ``wk`` / ``wv`` are not, when only the query heads divide)."""
    by_axes = {}
    for j, k in enumerate(keys_list):
        by_axes.setdefault(run.split(("layers",) + k, 2), []).append(j)
    out = [[None] * len(keys_list) for _ in run.positions]
    for axes, js in by_axes.items():
        widths = [run.layer(0, i, *keys_list[j]).shape[-1] for j in js]
        loc = [torch.cat([x @ run.layer(pos, i, *keys_list[j]) for j in js],
                         -1) for pos, x in enumerate(xs)]
        if axes:
            parts = [[t.movedim(0, -2).reshape(*t.shape[1:-1], -1)
                      for t in g.split(widths, -1)]
                     for g in M.all_gather_groups(run.mesh, axes, loc)]
        else:
            parts = [t.split(widths, -1) for t in loc]
        for pos, ts in enumerate(parts):
            for j, t in zip(js, ts):
                out[pos][j] = t
    return out


def _weight_full(run: _Run, i: int, keys) -> list:
    """Per position, layer ``i``'s whole (d_in, d_out) weight: its column
    blocks gathered (one collective) where the columns are split."""
    keys = ("layers",) + tuple(keys)
    axes = run.split(keys, 2)
    loc = [run.layer(pos, i, *keys[1:]) for pos in run.positions]
    if not axes:
        return loc
    return [g.permute(1, 0, 2).reshape(g.shape[1], -1)
            for g in M.all_gather_groups(run.mesh, axes, loc)]


def _rows(run: _Run, i: int, keys, hs: list, own: bool,
          seq_axes=()) -> list:
    """``h @ w`` for a weight split by rows: each shard's rows of h (all of
    h where ``own``) times its block, summed over the split axes (each
    position's sequence block of the sum with ``seq_axes``: ``_reduce``)."""
    keys = ("layers",) + tuple(keys)
    axes = run.split(keys, 1)
    out = []
    for pos, h in enumerate(hs):
        if axes and not own:
            h = h[..., slice(*run.range(keys, 1, pos))]
        out.append(h @ run.layer(pos, i, *keys[1:]))
    return _reduce(run.mesh, axes, out, seq_axes)


def _swiglu(run: _Run, i: int, keys, xs: list, seq_axes=()) -> list:
    """Megatron's MLP: gate / up by columns, down by rows, one psum (one
    psum_scatter with ``act_shard``)."""
    hs = [F.silu(x @ run.layer(pos, i, *keys, "w_gate"))
          * (x @ run.layer(pos, i, *keys, "w_up"))
          for pos, x in enumerate(xs)]
    return _rows(run, i, tuple(keys) + ("w_down",), hs, own=True,
                 seq_axes=seq_axes)


def _ffn(run: _Run, i: int, xs: list, tok_axes, seq_axes=(),
         aux_out: list = None) -> list:
    """Layer ``i``'s FFN (ln2, then SwiGLU or MoE) on per position its rows
    of the stream, or with ``seq_axes`` (``act_shard``) its sequence block,
    gathered first and its block of the output kept; ``aux_out``: as
    ``_moe``'s."""
    cfg, mesh = run.cfg, run.mesh
    xn = [L.rmsnorm(run.layer(pos, i, "ln2"), x)
          for pos, x in enumerate(_seq_gather(mesh, seq_axes, xs))]
    if not cfg.moe:
        return _swiglu(run, i, ("ffn",), xn, seq_axes)
    flat = [x.reshape(-1, x.shape[-1]) for x in xn]
    ys = [y.reshape(x.shape) for y, x in zip(
        _moe(run, cfg.moe, i, flat, tok_axes, aux_out)[0], xn)]
    if seq_axes:
        ys = [_seq_block(mesh, seq_axes, y, pos) for pos, y in enumerate(ys)]
    return ys


# --------------------------------------------------------------------------
# MoE: experts over model, capacity over data
# --------------------------------------------------------------------------

def moe_apply_sharded(placed: SH.Placed, cfg, i: int, xs: list,
                      tok_axes=()) -> tuple:
    """``moe.moe_apply`` of layer ``i`` (without the aux loss) on a placed
    tree whose ``['layers']['ffn']`` is a MoE.  ``xs``: per position its
    tokens (T_loc, d), split over ``tok_axes`` in token order (the
    reference's flattened batch) and the same across the other axes.
    Returns (per position its tokens' output, per position (eidx, pos,
    keep) of its tokens).

    The capacity rank is the reference's: an exclusive count over every
    (token, choice) pair in global token order, so a shard's pairs start
    after the earlier shards' pairs of the same expert (their per-expert
    counts gathered); ``cap`` comes from the global token count, and the
    same pairs drop.  Dispatch: every shard gathers its token group's
    tokens and routes (two gathers) and fills its block of the (E, cap, d)
    buffer — its experts (``model``) and, with ``ep_axes``, its capacity
    slots (``data``); combine: each shard's outputs of the pairs it holds,
    zeros elsewhere, summed over the buffer's axes (exact: one non-zero a
    pair), then the reference's weighted sum over the k choices."""
    return _moe(_Run(placed), cfg, i, xs, tok_axes)


def _moe(run: _Run, cfg, i: int, xs: list, tok_axes,
         aux_out: list = None) -> tuple:
    """``moe_apply_sharded``; with ``aux_out`` (a list) also the reference's
    switch aux loss, one float32 scalar a position appended to it: the
    routing probabilities and first-choice counts summed over the
    position's tokens, ``psum``-ed over ``tok_axes``, each divided by the
    global token count."""
    ep = tuple(cfg.ep_axes) if cfg.ep_axes is not None else None
    if ep not in (None, ("model", "data")):
        raise NotImplementedError(
            f"MoEConfig.ep_axes={cfg.ep_axes!r}: the sharded MoE runs "
            f"experts over 'model' and capacity over 'data' "
            f"(('model', 'data'), what the reference's cells set) or no "
            f"capacity split (None)")
    mesh = run.mesh
    E, k = cfg.e_pad, cfg.top_k
    fk = ("layers", "ffn")
    routes = [MOE.top_k(run.layer(pos, i, "ffn"), cfg, x)
              for pos, x in enumerate(xs)]
    ranks = [MOE.rank(r[2], E) for r in routes]
    pos_g = [p for p, _ in ranks]
    n_tok = len(mesh.groups(tok_axes)[0])
    T_loc, d = xs[0].shape
    if n_tok > 1:       # after the earlier token shards' pairs
        counts = M.all_gather_groups(mesh, tok_axes, [c for _, c in ranks])
        pos_g = [p + counts[pos][:mesh.group_index(pos, tok_axes)].sum(0)[
            routes[pos][2]] for pos, p in enumerate(pos_g)]
    cap = MOE.capacity(cfg, T_loc * n_tok)
    keep = [p < cap for p in pos_g]
    route = [torch.stack([r[2], p, kp.long()], -1)
             for r, p, kp in zip(routes, pos_g, keep)]
    if n_tok > 1:
        x_all = [g.reshape(-1, d)
                 for g in M.all_gather_groups(mesh, tok_axes, xs)]
        r_all = [g.reshape(-1, k, 3)
                 for g in M.all_gather_groups(mesh, tok_axes, route)]
    else:
        x_all, r_all = list(xs), route
    e_axes = run.split(fk + ("w_gate",), 1)
    c_axes = ("data",) if ep and "data" in mesh.axis_names else ()
    n_c = len(mesh.groups(c_axes)[0])
    c_blk = -(-cap // n_c)
    parts = []
    for pos in run.positions:
        e0, e1 = run.range(fk + ("w_gate",), 1, pos)
        c0 = mesh.group_index(pos, c_axes) * c_blk
        c1 = min(cap, c0 + c_blk)
        e, p, kp = r_all[pos].unbind(-1)
        sel = ((kp > 0) & (e >= e0) & (e < e1) & (p >= c0)
               & (p < c1)).reshape(-1)
        C = max(c1 - c0, 1)
        slot = ((e - e0) * C + (p - c0)).reshape(-1)
        # a pair the shard does not hold goes to a row of its own past the
        # buffer: every index distinct, so a plain (deterministic) write,
        # not an accumulating one that serialises a shared dummy row
        spare = (e1 - e0) * C + torch.arange(sel.numel(), device=e.device)
        idx = torch.where(sel, slot, spare)
        xa = x_all[pos]
        rows = xa.new_zeros(((e1 - e0) * C + sel.numel(), d)).index_put_(
            (idx,), xa.repeat_interleave(k, dim=0))
        buf = rows[:(e1 - e0) * C].view(e1 - e0, C, d)
        lp = run.layer(pos, i, "ffn")
        h = F.silu(torch.bmm(buf, lp["w_gate"])) * torch.bmm(buf, lp["w_up"])
        y = torch.bmm(h, lp["w_down"])
        parts.append((gather(y.reshape(-1, d), torch.where(sel, slot, 0))
                      * sel[:, None].to(y.dtype)).reshape(-1, k, d))
    out_k = M.psum(mesh, e_axes + c_axes, parts)
    outs = []
    for pos in run.positions:
        t0 = mesh.group_index(pos, tok_axes) * T_loc
        ok = out_k[pos][t0:t0 + T_loc]
        w = (routes[pos][1] * keep[pos])[..., None].to(ok.dtype)
        outs.append((ok * w).sum(dim=1))
    if cfg.n_shared:
        sh = _swiglu(run, i, ("ffn", "shared"), xs)
        outs = [o + s for o, s in zip(outs, sh)]
    if aux_out is not None:
        sums = M.psum(mesh, tok_axes,
                      [MOE.router_sums(cfg, r[0], r[2]) for r in routes])
        aux_out.extend(MOE.switch_aux(cfg, t, T_loc * n_tok) for t in sums)
    return outs, [(r[2], p, kp) for r, p, kp in zip(routes, pos_g, keep)]


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _head_plan(run: _Run):
    """(own_q, own_kv, per position (q heads [h0, h1), the K / V heads its
    query heads read, as indices into the heads it computes, or None for
    its own block))."""
    cfg = run.cfg
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    q_axes = run.split(("layers", "attn", "wq"), 2)
    kv_axes = run.split(("layers", "attn", "wk"), 2)
    n_q = len(run.mesh.groups(q_axes)[0])
    n_kv = len(run.mesh.groups(kv_axes)[0])
    own_q = bool(q_axes) and H % n_q == 0
    own_kv = (own_q and kv_axes == q_axes and Hkv % n_kv == 0)
    plan = []
    for pos in run.positions:
        if own_q:
            c0, c1 = run.range(("layers", "attn", "wq"), 2, pos)
            h0, h1 = c0 // Dh, c1 // Dh
        else:
            h0, h1 = 0, H
        if own_kv:
            kv = None
        elif h0 % G == 0 and (h1 - h0) % G == 0:
            kv = list(range(h0 // G, h1 // G))
        elif h0 // G == (h1 - 1) // G:
            kv = [h0 // G]
        else:                       # a group cut: K / V a query head
            kv = [h // G for h in range(h0, h1)]
        plan.append(((h0, h1), kv))
    return own_q, own_kv, plan


def _project(run: _Run, i: int, xn: list, positions: list, plan) -> list:
    """One layer's q / k / v heads a position: (q: its query heads; k, v:
    the K / V heads it computes; ka, va: those its query heads read)."""
    cfg = run.cfg
    acfg = cfg.attn_cfg()
    own_q, own_kv, heads = plan
    a = ("attn",)
    wq = (None if own_q else _weight_full(run, i, a + ("wq",)))
    wkv = (None if own_kv else (_weight_full(run, i, a + ("wk",)),
                                _weight_full(run, i, a + ("wv",))))
    out = []
    for pos, x in enumerate(xn):
        lp = run.layer(pos, i, "attn")
        q_lin = x @ (lp["wq"] if own_q else wq[pos])
        if own_kv:
            k_lin, v_lin = x @ lp["wk"], x @ lp["wv"]
        else:
            k_lin, v_lin = x @ wkv[0][pos], x @ wkv[1][pos]
        q, k, v = L.gqa_heads(lp, acfg, q_lin, k_lin, v_lin, positions[pos])
        kv_idx = heads[pos][1]
        if kv_idx is not None:
            idx = torch.tensor(kv_idx, device=k.device)
            ka, va = k.index_select(1, idx), v.index_select(1, idx)
        else:
            ka, va = k, v
        out.append((q, k, v, ka, va))
    return out


def _merge_heads(o):
    """(B, H, L, Dh) -> (B, L, H·Dh)."""
    B, _, Lq, _ = o.shape
    return o.transpose(1, 2).reshape(B, Lq, -1)


# --------------------------------------------------------------------------
# MLA: latent projections split by columns, per-head blocks, w_o by columns
# --------------------------------------------------------------------------

_MLA_HEADS = ("w_uq", "w_uk", "w_uv")


def _mla_plan(run: _Run) -> tuple:
    """(the axes the heads are split over, or () where a position computes
    every head; per position its heads [h0, h1)).  A position owns whole
    heads when ``w_uq`` / ``w_uk`` / ``w_uv`` are split over the same axes
    and the heads divide over them; otherwise the split would cut a head
    and the weights are gathered (``_mla_weights``)."""
    H, dn = run.cfg.mla.n_heads, run.cfg.mla.qk_nope_dim
    axes = {run.split(("layers", "attn", k), 2) for k in _MLA_HEADS}
    if len(axes) == 1:
        ax = axes.pop()
        if ax and H % len(run.mesh.groups(ax)[0]) == 0:
            return ax, [tuple(c // dn for c in run.range(
                ("layers", "attn", "w_uk"), 2, pos)) for pos in run.positions]
    return (), [(0, H)] * run.mesh.size


def _mla_weights(run: _Run, i: int, plan) -> list:
    """Per position layer ``i``'s ``w_uq`` / ``w_uk`` / ``w_uv`` for the heads
    it computes: its own column blocks, or every column (gathered where
    split)."""
    if plan[0]:
        return [{k: run.layer(pos, i, "attn", k) for k in _MLA_HEADS}
                for pos in run.positions]
    full = {k: _weight_full(run, i, ("attn", k)) for k in _MLA_HEADS}
    return [{k: full[k][pos] for k in _MLA_HEADS} for pos in run.positions]


def _mla_latents(run: _Run, i: int, xn: list, positions: list) -> list:
    """Per position (c_q, c_kv, k_r) of its rows, each whole: ``w_dq``,
    ``w_dkv`` and ``w_kr`` are split by their output columns, and the norms
    over the whole rank and the rope over the whole of dr need every
    column, so the products are gathered first (one gather for the
    projections that share their axes)."""
    m = run.cfg.mla
    a = ("attn",)
    lin = _cols_full(run, i, [a + ("w_dq",), a + ("w_dkv",), a + ("w_kr",)],
                     xn)
    out = []
    for pos, (cq, ckv, kr) in enumerate(lin):
        lp = run.layer(pos, i, "attn")
        out.append((L.rmsnorm(lp["q_norm"], cq),
                    L.rmsnorm(lp["kv_norm"], ckv),
                    L.rope(kr, positions[pos], m.rope_theta)))
    return out


def _mla_attention(run: _Run, i: int, xn: list, positions: list, plan,
                   training: bool) -> tuple:
    """One layer's materialised MLA on each position's heads: (per position
    its heads' output (B, L, h·dv), per position (c_q, c_kv, k_r)).  One
    attention call a position: ``chunked_attention`` when ``training``,
    else ``prefill_attention`` (B5 on the card, at head dim dn + dr)."""
    cfg = run.cfg
    m = cfg.mla
    lat = _mla_latents(run, i, xn, positions)
    ws = _mla_weights(run, i, plan)
    hs = []
    for pos, (c_q, c_kv, k_r) in enumerate(lat):
        w = ws[pos]
        q_n, q_r = MLA.head_queries(m, c_q, w["w_uq"], positions[pos])
        q, k, vp = MLA.head_qkv(m, q_n, q_r, c_kv, k_r, w["w_uk"],
                                w["w_uv"])
        attend = (L.chunked_attention if training else L.prefill_attention)
        kw = {"flash_bwd": cfg.flash_bwd} if training else {}
        o = attend(q, k, vp, causal=True, chunk_q=cfg.chunk_q,
                   chunk_k=cfg.chunk_k, **kw)
        hs.append(_merge_heads(o[..., :m.v_head_dim]))
    return hs, lat


def _mla_out(run: _Run, i: int, hs: list, plan, seq_axes=()) -> list:
    """``o @ w_o`` with ``w_o`` split by its output columns (d): the heads'
    outputs gathered over the head axes (every head, in order), each
    position's column block of the product, the blocks gathered; with
    ``seq_axes`` (``act_shard``) each position keeps its sequence block."""
    mesh = run.mesh
    full = _concat_gathered(mesh, plan[0], hs)
    keys = ("layers", "attn", "w_o")
    parts = [h @ run.layer(pos, i, *keys[1:]) for pos, h in enumerate(full)]
    ys = _concat_gathered(mesh, run.split(keys, 2), parts)
    if seq_axes:
        ys = [_seq_block(mesh, seq_axes, y, pos) for pos, y in enumerate(ys)]
    return ys


def _mla_decode(run: _Run, i: int, xn: list, positions: list, lens: list,
                bufs: list, s0: list, S: int, seq_axes, plan) -> list:
    """One layer's absorbed decode on the sequence-sharded latent cache:
    per position its heads' (B, 1, h·dv) before ``w_o``.  The step's
    latents are computed whole on every position (``_mla_latents``), its
    query in latent space on each position's heads and gathered over the
    head axes, so that every position scores every head against its block
    of slots.  One gather of the blocks' softmax statistics gives the
    global max and sum, each block's probabilities are normalised and cast
    as the reference casts them, and one ``psum`` adds the blocks' ``o_c``
    (``models/mla.py``).  With ``decode_write_then_attend`` the latents are
    written into the position that owns slot ``length`` first; without,
    they are one more block and written after."""
    cfg, mesh = run.cfg, run.mesh
    m = cfg.mla
    r = m.kv_lora_rank
    lat = _mla_latents(run, i, xn, positions)
    ws = _mla_weights(run, i, plan)
    qs = []
    for pos, (c_q, _, _) in enumerate(lat):
        q_c, q_r = MLA.absorbed_query(m, *MLA.head_queries(
            m, c_q, ws[pos]["w_uq"], positions[pos]), ws[pos]["w_uk"])
        qs.append(torch.cat([q_c, q_r], -1))
    if plan[0]:         # every head on every position, in head order
        qs = [g.movedim(0, 1).reshape(g.shape[1], -1, g.shape[-1])
              for g in M.all_gather_groups(mesh, plan[0], qs)]
    wta = cfg.decode_write_then_attend

    def write():
        for pos, (_, c_new, kr_new) in enumerate(lat):
            for buf, val in zip(bufs[pos], (c_new, kr_new)):
                _write_local(buf, val[:, 0], lens[pos], s0[pos], S, axis=1)

    if wta:
        write()
    new = None if wta else [
        (c_new.to(b[0].dtype), kr_new.to(b[1].dtype))
        for (_, c_new, kr_new), b in zip(lat, bufs)]
    o_c = MLA.sharded_o_c(m, mesh, seq_axes,
                          [(q[..., :r], q[..., r:]) for q in qs], bufs,
                          [n + 1 if wta else n for n in lens], s0, new)
    hs = []
    for pos, o in enumerate(o_c):
        h0, h1 = plan[1][pos]
        hs.append(MLA.absorbed_output(m, o.to(xn[pos].dtype)[:, h0:h1],
                                      ws[pos]["w_uv"]))
    if not wta:
        write()
    return hs


def _prefill_attention(run: _Run, i: int, xn: list, positions: list,
                       plan) -> tuple:
    """One layer's attention: (h per position, (k, v) per position with
    every K / V head of the shard's batch rows)."""
    cfg = run.cfg
    hs, kvs = [], []
    for q, k, v, ka, va in _project(run, i, xn, positions, plan):
        o = L.prefill_attention(q, ka, va, causal=True, chunk_q=cfg.chunk_q,
                                chunk_k=cfg.chunk_k)
        hs.append(_merge_heads(o))
        kvs.append(torch.stack([k, v]))
    a = ("attn",)
    h = _rows(run, i, a + ("wo",), hs, own=plan[0])
    if plan[1]:      # every K / V head, for the cache
        kv_axes = run.split(("layers",) + a + ("wk",), 2)
        kvs = [g.permute(1, 2, 0, 3, 4, 5).reshape(
            2, g.shape[2], -1, *g.shape[4:])
            for g in M.all_gather_groups(run.mesh, kv_axes, kvs)]
    return h, kvs


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _token_axes(mesh, spec, shape) -> tuple:
    """The axes the batch rows are split over, after sanitizing."""
    spec = SH.sanitize_spec(spec, shape, mesh)
    return SH.entry_axes(spec[0]) if spec else ()


def _cache_layout(cfg, n_layers: int, B: int, S: int) -> tuple:
    """(the cache's global shapes by key, the dimension of its sequence):
    GQA's {"k", "v"} of (n_layers, B, Hkv, S, Dh), sequence at dim 3; MLA's
    {"c_kv", "k_rope"} of (n_layers, B, S, r) / (n_layers, B, S, dr),
    sequence at dim 2."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {"c_kv": (n_layers, B, S, m.kv_lora_rank),
                "k_rope": (n_layers, B, S, m.qk_rope_dim)}, 2
    shape = (n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    return {"k": shape, "v": shape}, 3


def prefill(placed: SH.Placed, cfg, tokens):
    """tokens (B, L) -> (last-position logits (B, vocab), the caches placed
    by ``lm_cache_spec``: GQA's {"k", "v"} of global shape (n_layers, B,
    Hkv, L, Dh), MLA's {"c_kv", "k_rope"} of (n_layers, B, L, r / dr))."""
    run = _Run(placed, cfg)
    mesh = run.mesh
    mla = cfg.attn_type == "mla"
    bspec = SH.lm_batch_spec(mesh)
    B, Lq = (tokens.shapes[""] if isinstance(tokens, SH.Placed)
             else tuple(tokens.shape))
    tok_axes = _token_axes(mesh, bspec, (B, Lq))
    toks = _batch_rows(mesh, tokens, bspec)
    xs = _embed(run, toks)
    positions = [torch.arange(Lq, dtype=torch.int32, device=t.device)[
        None].expand(t.shape[0], Lq) for t in toks]
    plan = _mla_plan(run) if mla else _head_plan(run)
    n_layers = run.n_layers
    shapes, sdim = _cache_layout(cfg, n_layers, B, Lq)
    cspec = {k: SH.sanitize_spec(s, shapes[k], mesh) for k, s in
             SH.lm_cache_spec(mesh, cfg.attn_type, B, cfg.n_kv_heads).items()}
    first = next(iter(shapes))
    tspec = SH.sanitize_spec(bspec, (B, Lq), mesh)
    seq = []
    for pos in run.positions:
        b = SH.block_range(mesh, cspec[first], shapes[first], 1, pos)
        if b != SH.block_range(mesh, tspec, (B, Lq), 0, pos):
            raise ValueError(f"cache batch rows {b} differ from the tokens'")
        # the shard's sequence block of a layer's (B_loc, ...) tensor
        seq.append((slice(None),) * (sdim - 2) + (slice(*SH.block_range(
            mesh, cspec[first], shapes[first], sdim, pos)),))
    cache = [{k: [] for k in shapes} for _ in run.positions]
    for i in range(n_layers):
        xn = [L.rmsnorm(run.layer(pos, i, "ln1"), x)
              for pos, x in enumerate(xs)]
        if mla:
            hs, lat = _mla_attention(run, i, xn, positions, plan, False)
            h = _mla_out(run, i, hs, plan)
            kvs = [(c_kv, k_r) for _, c_kv, k_r in lat]
        else:
            h, kvs = _prefill_attention(run, i, xn, positions, plan)
        xs = [x + hh for x, hh in zip(xs, h)]
        xs = [x + y for x, y in zip(xs, _ffn(run, i, xs, tok_axes))]
        for pos, kv in enumerate(kvs):     # the shard's sequence block
            for key, t in zip(shapes, kv):
                cache[pos][key].append(t[(slice(None),) + seq[pos]])
    xs = [L.rmsnorm(run.leaf(pos, "final_norm"), x[:, -1:])
          for pos, x in enumerate(xs)]
    logits = [lg[:, 0] for lg in _unembed(run, xs)]
    caches = SH.Placed(
        mesh, {f"[{k!r}]": s for k, s in shapes.items()},
        {f"[{k!r}]": cspec[k] for k in shapes},
        tuple({k: torch.stack(v) for k, v in c.items()} for c in cache))
    return _assemble(mesh, logits, bspec, (B, placed.shapes[
        _path("embed", "table")][0])), caches


def _write_local(buf, val, length, s0: int, S: int, axis: int = 2) -> None:
    """Write val (B, ...) into a shard's block buf of slots s0 .. s0 + n - 1
    along ``axis`` (GQA's (B, Hkv, n, Dh): 2; MLA's (B, n, r): 1) at the
    global slot clip(length, 0, S - 1), in the rows whose slot the block
    holds (no host sync)."""
    n = buf.shape[axis]
    loc = length.long().clamp(0, S - 1) - s0
    own = (loc >= 0) & (loc < n)
    loc = loc.clamp(0, n - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    view = buf.movedim(axis, 1)
    own = own.reshape((-1,) + (1,) * (val.dim() - 1))
    view[rows, loc] = torch.where(own, val.to(buf.dtype), view[rows, loc])


def decode_step(placed: SH.Placed, cfg, token, cache: SH.Placed, length):
    """token (B,), cache placed by ``lm_cache_spec`` (``prefill``'s, or
    ``launch.cells``'), length (B,) -> (logits (B, vocab), cache), the
    step's K / V (MLA: latents) written into the cache's blocks in place."""
    run = _Run(placed, cfg)
    mesh = run.mesh
    mla = cfg.attn_type == "mla"
    B = token.shapes[""][0] if isinstance(token, SH.Placed) else \
        token.shape[0]
    b_axes = batch_axes(mesh)       # the reference's decode cell's rule
    bspec = SH.P(b_axes) if B >= int(np.prod([mesh.shape[a]
                                              for a in b_axes])) else SH.P()
    tok_axes = _token_axes(mesh, bspec, (B,))
    toks = _batch_rows(mesh, token, bspec)
    lens = _batch_rows(mesh, length, bspec)
    keys = ("c_kv", "k_rope") if mla else ("k", "v")
    key0 = f"[{keys[0]!r}]"
    sdim = 2 if mla else 3
    kshape = cache.shapes[key0]
    S = kshape[sdim]
    seq_axes = cache.split(key0, sdim)
    for pos in run.positions:
        b = cache.range(key0, 1, pos)
        rows = SH.block_range(mesh, SH.sanitize_spec(bspec, (B,), mesh),
                              (B,), 0, pos)
        if b != rows:
            raise ValueError(f"cache batch rows {b} differ from the "
                             f"tokens' {rows}")
    s0 = [cache.range(key0, sdim, pos)[0] for pos in run.positions]
    acfg = None if mla else cfg.attn_cfg()
    plan = _mla_plan(run) if mla else None
    xs = _embed(run, [t[:, None] for t in toks])
    positions = [ln[:, None] for ln in lens]
    for i in range(kshape[0]):
        xn = [L.rmsnorm(run.layer(pos, i, "ln1"), x)
              for pos, x in enumerate(xs)]
        bufs = [tuple(cache.shards[pos][k][i] for k in keys)
                for pos in run.positions]
        if mla:
            hs = _mla_decode(run, i, xn, positions, lens, bufs, s0, S,
                             seq_axes, plan)
            h = _mla_out(run, i, hs, plan)
        else:
            h = _gqa_decode(run, i, xn, positions, lens, bufs, s0, S,
                            seq_axes, acfg)
        xs = [x + hh for x, hh in zip(xs, h)]
        xs = [x + y for x, y in zip(xs, _ffn(run, i, xs, tok_axes))]
    xs = [L.rmsnorm(run.leaf(pos, "final_norm"), x)
          for pos, x in enumerate(xs)]
    logits = [lg[:, 0] for lg in _unembed(run, xs)]
    return _assemble(mesh, logits, bspec, (B, placed.shapes[
        _path("embed", "table")][0])), cache


def _gqa_decode(run: _Run, i: int, xn: list, positions: list, lens: list,
                bufs: list, s0: list, S: int, seq_axes, acfg) -> list:
    """One layer's GQA decode on the sequence-sharded K / V cache: per
    position the attention's output after ``wo``.  q and the step's K / V
    for every head (their projections' columns gathered), the K / V
    written into the shard that owns slot ``length``, flash-decoding over
    the blocks (``layers.decode_attention(..., seq_axis=)``); without
    ``decode_write_then_attend`` the step's own K / V join the merge as one
    more block and are written after."""
    cfg, mesh = run.cfg, run.mesh
    a = ("attn",)
    lin = _cols_full(run, i, [a + ("wq",), a + ("wk",), a + ("wv",)], xn)
    qkv = [L.gqa_heads(run.layer(pos, i, "attn"), acfg, *lin[pos],
                       positions[pos]) for pos in run.positions]
    kb = [b[0] for b in bufs]
    vb = [b[1] for b in bufs]

    def write():
        for pos, (q, k, v) in enumerate(qkv):
            _write_local(kb[pos], k[:, :, 0], lens[pos], s0[pos], S)
            _write_local(vb[pos], v[:, :, 0], lens[pos], s0[pos], S)

    if cfg.decode_write_then_attend:
        write()
        o = L.decode_attention(
            Sharded(mesh, tuple(q for q, _, _ in qkv)),
            Sharded(mesh, tuple(kb)), Sharded(mesh, tuple(vb)),
            Sharded(mesh, tuple(ln + 1 for ln in lens)),
            seq_axis=seq_axes, extra_slot=False).blocks
    else:           # the step's own K / V: one more block of the merge
        parts = [L.decode_partial(qkv[pos][0], kb[pos], vb[pos],
                                  lens[pos], s0[pos], S, False)
                 for pos in run.positions]
        o = []
        for pos, g in enumerate(M.all_gather_groups(mesh, seq_axes, parts)):
            q, k, v = qkv[pos]
            own = L.decode_partial(q, k, v, None, 0, 1, False)
            o.append(L.merge_partials(torch.cat([g, own[None]]), q.dtype))
        write()
    hs = [t.transpose(1, 2).reshape(t.shape[0], 1, -1) for t in o]
    return _rows(run, i, a + ("wo",), hs, own=False)


# --------------------------------------------------------------------------
# the training route
# --------------------------------------------------------------------------

IGNORE_ID = -1          # L.cross_entropy's ignored label


def _train_layer(run: _Run, i: int, xs: list, aux: list, positions: list,
                 tok_axes, seq_axes) -> tuple:
    """One layer of the training route: (xs, aux) after it.  ``xs``: per
    position its rows of the residual stream (B_loc, L, d), or with
    ``seq_axes`` (``act_shard``) its sequence block, all-gathered before
    the layer's products; ``aux``: per position the MoE aux loss so far."""
    cfg, mesh = run.cfg, run.mesh
    xn = [L.rmsnorm(run.layer(pos, i, "ln1"), x)
          for pos, x in enumerate(_seq_gather(mesh, seq_axes, xs))]
    if cfg.attn_type == "mla":
        plan = _mla_plan(run)
        hs, _ = _mla_attention(run, i, xn, positions, plan, True)
        h = _mla_out(run, i, hs, plan, seq_axes)
    else:
        plan = _head_plan(run)
        hs = [_merge_heads(L.chunked_attention(
            q, ka, va, causal=True, chunk_q=cfg.chunk_q,
            chunk_k=cfg.chunk_k, flash_bwd=cfg.flash_bwd))
            for q, _, _, ka, va in _project(run, i, xn, positions, plan)]
        h = _rows(run, i, ("attn", "wo"), hs, own=plan[0],
                  seq_axes=seq_axes)
    xs = [x + t for x, t in zip(xs, h)]
    got = []
    ys = _ffn(run, i, xs, tok_axes, seq_axes, aux_out=got)
    if got:
        aux = [a + g for a, g in zip(aux, got)]
    return [x + y for x, y in zip(xs, ys)], aux


def _trunk(placed: SH.Placed, cfg, tokens) -> tuple:
    """Embedding, the layers and the final norm of the training route on a
    tree placed in any layout (the storage one, ``lm_param_spec``):
    (the run over the compute layout's embedding, per position its rows of
    the final normed stream (B_loc, L, d), per position the aux loss, the
    batch spec, the token axes)."""
    mesh = placed.mesh
    bspec = SH.lm_batch_spec(mesh)
    B, Lq = (tokens.shapes[""] if isinstance(tokens, SH.Placed)
             else tuple(tokens.shape))
    tok_axes = _token_axes(mesh, bspec, (B, Lq))
    seq_axes = ()
    if cfg.act_shard and "model" in mesh.axis_names:
        spec = SH.sanitize_spec(SH.P(None, "model"), (B, Lq), mesh)
        seq_axes = SH.entry_axes(spec[1]) if len(spec) > 1 else ()
    rule = SH.lm_param_spec_tp
    if cfg.fsdp_inner:      # the layers are gathered inside their bodies
        top = _Run(SH.reshard(SH.subtree(placed, ("embed", "final_norm")),
                              mesh, rule), cfg)
    else:                   # the whole tree at step start
        top = _Run(SH.reshard(placed, mesh, rule), cfg)
    toks = _batch_rows(mesh, tokens, bspec)
    xs = _embed(top, toks, seq_axes)
    positions = [torch.arange(Lq, dtype=torch.int32, device=t.device)[
        None].expand(t.shape[0], Lq) for t in toks]
    aux = [torch.zeros((), dtype=torch.float32, device=d)
           for d in mesh.devices]
    remat = cfg.remat and torch.is_grad_enabled()
    stored = SH.layers(placed) if cfg.fsdp_inner else None
    for i in range(placed.shapes["['layers']['ln1']['scale']"][0]):
        def body(xs, aux, i=i):
            if cfg.fsdp_inner:
                run = _Run(SH.reshard(stored[i], mesh, rule), cfg)
                return _train_layer(run, 0, xs, aux, positions, tok_axes,
                                    seq_axes)
            return _train_layer(top, i, xs, aux, positions, tok_axes,
                                seq_axes)
        if remat:
            xs, aux = checkpoint(body, xs, aux, use_reentrant=False)
        else:
            xs, aux = body(xs, aux)
    xs = [L.rmsnorm(top.leaf(pos, "final_norm"), x) for pos, x in
          enumerate(_seq_gather(mesh, seq_axes, xs))]
    return top, xs, aux, bspec, tok_axes


def forward(placed: SH.Placed, cfg, tokens) -> tuple:
    """tokens (B, L) -> (logits (B, L, vocab) on the first shard's device,
    the aux loss): ``transformer.forward`` on a placed tree, through the
    training route (``chunked_attention``, ``fsdp_inner``, ``act_shard``,
    ``remat``).  The logits are gathered whole (a fetch for a caller);
    ``train_step_loss`` never holds them."""
    top, xs, aux, bspec, _ = _trunk(placed, cfg, tokens)
    B, Lq = (tokens.shapes[""] if isinstance(tokens, SH.Placed)
             else tuple(tokens.shape))
    V = top.p.shapes[_path("embed", "table")][0]
    return _assemble(placed.mesh, _unembed(top, xs), bspec, (B, Lq, V)), \
        aux[0]


def _cross_entropy(run: _Run, xs: list, labels: list, tok_axes) -> list:
    """``L.cross_entropy`` of the logits ``x @ tableᵀ``, vocab-parallel:
    each position's float32 logits of its vocab block give its
    log-sum-exp, merged over the vocab axes by one gather of (B_loc, L)
    floats and a log-sum-exp; the label's logit is a masked local pick,
    ``psum``-ed; the summed NLL and the label count are ``psum``-ed over
    the token axes.  Per position the same float32 mean (labels clipped at
    0, ``IGNORE_ID`` masked)."""
    keys = ("embed", "table")
    mesh = run.mesh
    axes = run.split(keys, 0)
    lse, pick = [], []
    for pos, x in enumerate(xs):
        tab = run.leaf(pos, *keys)
        logits = (x @ tab.T.to(x.dtype)).float()
        lab = labels[pos].long().clamp(min=0) - run.range(keys, 0, pos)[0]
        hit = (lab >= 0) & (lab < tab.shape[0])
        ll = torch.take_along_dim(
            logits, lab.clamp(0, tab.shape[0] - 1)[..., None], -1)[..., 0]
        lse.append(torch.logsumexp(logits, -1))
        pick.append(ll * hit)
    if axes:
        lse = [torch.logsumexp(g, 0)
               for g in M.all_gather_groups(mesh, axes, lse)]
    pick = M.psum(mesh, axes, pick)
    parts = []
    for pos, lab in enumerate(labels):
        mask = lab != IGNORE_ID
        parts.append(torch.stack([((lse[pos] - pick[pos]) * mask).sum(),
                                  mask.sum().float()]))
    return [t[0] / t[1].clamp(min=1) for t in M.psum(mesh, tok_axes, parts)]


def train_step_loss(placed: SH.Placed, cfg, batch: dict):
    """``transformer.train_step_loss`` on a placed tree: the mean next-token
    cross entropy of ``batch["tokens"]`` against ``batch["labels"]`` (each
    (B, L), global or placed by ``lm_batch_spec``) plus the aux loss, as
    ONE float32 scalar on the first shard's device — the first position's
    copy, so a backward from it counts the global loss once.  Its gradient
    reaches every distinct block of ``placed`` (``launch.sharding.
    distinct``)."""
    top, xs, aux, bspec, tok_axes = _trunk(placed, cfg, batch["tokens"])
    labels = _batch_rows(placed.mesh, batch["labels"], bspec)
    return _cross_entropy(top, xs, labels, tok_axes)[0] + aux[0]
