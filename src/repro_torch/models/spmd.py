"""The LM's sharded serving route: ``prefill`` and ``decode_step`` on a tree
placed by ``launch.sharding.place(params, mesh, lm_param_spec_tp)``.

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

Logits come back as one (B, vocab) tensor on the first shard's device (a
fetch to the caller, not counted); caches as a ``Placed``.  MLA on a mesh
raises (ROADMAP A.7.3).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import mesh as M
from repro_torch.core.mesh import Sharded
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.scatter import gather


def _path(*keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _views(t, i: int):
    """Layer ``i``'s views of a tree of stacked leaves."""
    if isinstance(t, torch.Tensor):
        return t[i]
    return {k: _views(v, i) for k, v in t.items()}


class _Run:
    """One call's view of a placed tree: blocks by position and layer, and
    the axes each leaf is split over."""

    def __init__(self, placed: SH.Placed, cfg=None):
        if cfg is not None and cfg.attn_type == "mla":
            raise NotImplementedError(
                f"{cfg.name}: MLA under a mesh is not ported yet (ROADMAP "
                f"A.7.3)")
        self.p, self.cfg, self.mesh = placed, cfg, placed.mesh
        self.positions = range(self.mesh.size)
        # every leaf under "layers" is stacked on the layer axis
        n = next(s[0] for p, s in placed.shapes.items()
                 if p.startswith("['layers']"))
        self.n_layers = n
        self.views = [[_views(sh["layers"], i) for i in range(n)]
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

def _embed(run: _Run, toks: list) -> list:
    keys = ("embed", "table")
    axes = run.split(keys, 0)
    out = []
    for pos in run.positions:
        tab = run.leaf(pos, *keys)
        t = toks[pos].long() - run.range(keys, 0, pos)[0]
        hit = (t >= 0) & (t < tab.shape[0])
        out.append(tab[t.clamp(0, tab.shape[0] - 1)]
                   * hit[..., None].to(tab.dtype))
    return M.psum(run.mesh, axes, out)


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
    shard's column blocks, one gather over their common axes."""
    axes = {run.split(("layers",) + k, 2) for k in keys_list}
    if len(axes) != 1:
        raise ValueError(f"{keys_list} are split over different axes {axes}")
    axes = axes.pop()
    widths = [run.layer(0, i, *k).shape[-1] for k in keys_list]
    loc = [torch.cat([x @ run.layer(pos, i, *k) for k in keys_list], -1)
           for pos, x in enumerate(xs)]
    if not axes:
        return [list(t.split(widths, -1)) for t in loc]
    out = []
    for g in M.all_gather_groups(run.mesh, axes, loc):
        out.append([t.movedim(0, -2).reshape(*t.shape[1:-1], -1)
                    for t in g.split(widths, -1)])
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


def _rows(run: _Run, i: int, keys, hs: list, own: bool) -> list:
    """``h @ w`` for a weight split by rows: each shard's rows of h (all of
    h where ``own``) times its block, summed over the split axes."""
    keys = ("layers",) + tuple(keys)
    axes = run.split(keys, 1)
    out = []
    for pos, h in enumerate(hs):
        if axes and not own:
            h = h[..., slice(*run.range(keys, 1, pos))]
        out.append(h @ run.layer(pos, i, *keys[1:]))
    return M.psum(run.mesh, axes, out)


def _swiglu(run: _Run, i: int, keys, xs: list) -> list:
    """Megatron's MLP: gate / up by columns, down by rows, one psum."""
    hs = [F.silu(x @ run.layer(pos, i, *keys, "w_gate"))
          * (x @ run.layer(pos, i, *keys, "w_up"))
          for pos, x in enumerate(xs)]
    return _rows(run, i, tuple(keys) + ("w_down",), hs, own=True)


def _ffn(run: _Run, i: int, xs: list, tok_axes) -> list:
    cfg = run.cfg
    xn = [L.rmsnorm(run.layer(pos, i, "ln2"), x) for pos, x in enumerate(xs)]
    if not cfg.moe:
        return _swiglu(run, i, ("ffn",), xn)
    flat = [x.reshape(-1, x.shape[-1]) for x in xn]
    ys = _moe(run, cfg.moe, i, flat, tok_axes)[0]
    return [y.reshape(x.shape) for y, x in zip(ys, xs)]


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


def _moe(run: _Run, cfg, i: int, xs: list, tok_axes) -> tuple:
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


def _prefill_attention(run: _Run, i: int, xn: list, positions: list,
                       plan) -> tuple:
    """One layer's attention: (h per position, (k, v) per position with
    every K / V head of the shard's batch rows)."""
    cfg = run.cfg
    acfg = cfg.attn_cfg()
    own_q, own_kv, heads = plan
    a = ("attn",)
    wq = (None if own_q else _weight_full(run, i, a + ("wq",)))
    wkv = (None if own_kv else
           (_weight_full(run, i, a + ("wk",)), _weight_full(run, i, a + ("wv",))))
    hs, kvs = [], []
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
        o = L.prefill_attention(q, ka, va, causal=True, chunk_q=cfg.chunk_q,
                                chunk_k=cfg.chunk_k)
        B, _, Lq, _ = o.shape
        hs.append(o.transpose(1, 2).reshape(B, Lq, -1))
        kvs.append(torch.stack([k, v]))
    h = _rows(run, i, a + ("wo",), hs, own=own_q)
    if own_kv:       # every K / V head, for the cache
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


def prefill(placed: SH.Placed, cfg, tokens):
    """tokens (B, L) -> (last-position logits (B, vocab), the caches placed
    by ``lm_cache_spec``: GQA's {"k", "v"} of global shape (n_layers, B,
    Hkv, L, Dh))."""
    run = _Run(placed, cfg)
    mesh = run.mesh
    bspec = SH.lm_batch_spec(mesh)
    B, Lq = (tokens.shapes[""] if isinstance(tokens, SH.Placed)
             else tuple(tokens.shape))
    tok_axes = _token_axes(mesh, bspec, (B, Lq))
    toks = _batch_rows(mesh, tokens, bspec)
    xs = _embed(run, toks)
    positions = [torch.arange(Lq, dtype=torch.int32, device=t.device)[
        None].expand(t.shape[0], Lq) for t in toks]
    plan = _head_plan(run)
    n_layers = run.n_layers
    shape = (n_layers, B, cfg.n_kv_heads, Lq, cfg.head_dim)
    cspec = {k: SH.sanitize_spec(s, shape, mesh) for k, s in
             SH.lm_cache_spec(mesh, cfg.attn_type, B, cfg.n_kv_heads).items()}
    tspec = SH.sanitize_spec(bspec, (B, Lq), mesh)
    seq = []
    for pos in run.positions:
        b = SH.block_range(mesh, cspec["k"], shape, 1, pos)
        if b != SH.block_range(mesh, tspec, (B, Lq), 0, pos):
            raise ValueError(f"cache batch rows {b} differ from the tokens'")
        seq.append(slice(*SH.block_range(mesh, cspec["k"], shape, 3, pos)))
    cache = [([], []) for _ in run.positions]
    for i in range(n_layers):
        xn = [L.rmsnorm(run.layer(pos, i, "ln1"), x)
              for pos, x in enumerate(xs)]
        h, kvs = _prefill_attention(run, i, xn, positions, plan)
        xs = [x + hh for x, hh in zip(xs, h)]
        xs = [x + y for x, y in zip(xs, _ffn(run, i, xs, tok_axes))]
        for pos, kv in enumerate(kvs):     # the shard's sequence block
            cache[pos][0].append(kv[0][:, :, seq[pos]])
            cache[pos][1].append(kv[1][:, :, seq[pos]])
    xs = [L.rmsnorm(run.leaf(pos, "final_norm"), x[:, -1:])
          for pos, x in enumerate(xs)]
    logits = [lg[:, 0] for lg in _unembed(run, xs)]
    caches = SH.Placed(
        mesh, {"['k']": shape, "['v']": shape},
        {"['k']": cspec["k"], "['v']": cspec["v"]},
        tuple({"k": torch.stack(k), "v": torch.stack(v)} for k, v in cache))
    return _assemble(mesh, logits, bspec, (B, placed.shapes[
        _path("embed", "table")][0])), caches


def _write_local(buf, val, length, s0: int, S: int) -> None:
    """Write val (B, Hkv, Dh) into a shard's block buf (B, Hkv, n, Dh) of
    slots s0 .. s0 + n - 1 at the global slot clip(length, 0, S - 1), in
    the rows whose slot the block holds (no host sync)."""
    n = buf.shape[2]
    loc = length.long().clamp(0, S - 1) - s0
    own = (loc >= 0) & (loc < n)
    loc = loc.clamp(0, n - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    view = buf.movedim(2, 1)
    view[rows, loc] = torch.where(own[:, None, None], val.to(buf.dtype),
                                  view[rows, loc])


def decode_step(placed: SH.Placed, cfg, token, cache: SH.Placed, length):
    """token (B,), cache placed by ``lm_cache_spec`` (``prefill``'s, or
    ``launch.cells``'), length (B,) -> (logits (B, vocab), cache), the
    step's K / V written into the cache's blocks in place."""
    run = _Run(placed, cfg)
    mesh = run.mesh
    B = token.shapes[""][0] if isinstance(token, SH.Placed) else \
        token.shape[0]
    b_axes = batch_axes(mesh)       # the reference's decode cell's rule
    bspec = SH.P(b_axes) if B >= int(np.prod([mesh.shape[a]
                                              for a in b_axes])) else SH.P()
    tok_axes = _token_axes(mesh, bspec, (B,))
    toks = _batch_rows(mesh, token, bspec)
    lens = _batch_rows(mesh, length, bspec)
    kshape = cache.shapes["['k']"]
    S = kshape[3]
    seq_axes = cache.split("['k']", 3)
    for pos in run.positions:
        b = cache.range("['k']", 1, pos)
        rows = SH.block_range(mesh, SH.sanitize_spec(bspec, (B,), mesh),
                              (B,), 0, pos)
        if b != rows:
            raise ValueError(f"cache batch rows {b} differ from the "
                             f"tokens' {rows}")
    acfg = cfg.attn_cfg()
    xs = _embed(run, [t[:, None] for t in toks])
    positions = [ln[:, None] for ln in lens]
    a = ("attn",)
    for i in range(kshape[0]):
        xn = [L.rmsnorm(run.layer(pos, i, "ln1"), x)
              for pos, x in enumerate(xs)]
        lin = _cols_full(run, i, [a + ("wq",), a + ("wk",), a + ("wv",)], xn)
        qkv = [L.gqa_heads(run.layer(pos, i, "attn"), acfg, *lin[pos],
                           positions[pos]) for pos in run.positions]
        kb = [cache.shards[pos]["k"][i] for pos in run.positions]
        vb = [cache.shards[pos]["v"][i] for pos in run.positions]
        s0 = [cache.range("['k']", 3, pos)[0] for pos in run.positions]
        if cfg.decode_write_then_attend:
            for pos, (q, k, v) in enumerate(qkv):
                _write_local(kb[pos], k[:, :, 0], lens[pos], s0[pos], S)
                _write_local(vb[pos], v[:, :, 0], lens[pos], s0[pos], S)
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
            for pos, g in enumerate(M.all_gather_groups(mesh, seq_axes,
                                                        parts)):
                q, k, v = qkv[pos]
                own = L.decode_partial(q, k, v, None, 0, 1, False)
                o.append(L.merge_partials(torch.cat([g, own[None]]),
                                          q.dtype))
            for pos, (q, k, v) in enumerate(qkv):
                _write_local(kb[pos], k[:, :, 0], lens[pos], s0[pos], S)
                _write_local(vb[pos], v[:, :, 0], lens[pos], s0[pos], S)
        hs = [t.transpose(1, 2).reshape(t.shape[0], 1, -1) for t in o]
        h = _rows(run, i, a + ("wo",), hs, own=False)
        xs = [x + hh for x, hh in zip(xs, h)]
        xs = [x + y for x, y in zip(xs, _ffn(run, i, xs, tok_axes))]
    xs = [L.rmsnorm(run.leaf(pos, "final_norm"), x)
          for pos, x in enumerate(xs)]
    logits = [lg[:, 0] for lg in _unembed(run, xs)]
    return _assemble(mesh, logits, bspec, (B, placed.shapes[
        _path("embed", "table")][0])), cache
