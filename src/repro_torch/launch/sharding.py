"""Logical sharding rules (parameter path -> ``P``, per family) and the
placement that applies them: the port's counterpart of the reference's
``launch/sharding.py`` with ``NamedSharding`` / ``tree_shardings``.

The rules are the reference's, path for path (the paths are
``repro_torch.tree.flatten_with_paths``'s, the reference's ``keystr``
strings):

* LM storage (``lm_param_spec``): the last dim over ``model`` (TP), the one
  before over ``data`` (FSDP); embedding (vocab, d) -> (model, data); MoE
  expert stacks (L, E, d, f) -> experts over ``model``, d over ``data``.
* LM compute (``lm_param_spec_tp``): pure TP, what serving runs under —
  up / in projections split by columns, ``wo`` / ``w_down`` by rows, the
  embedding by vocab rows, experts over ``model``, the router and the
  norms replicated.
* GNN: replicated; edge arrays over every mesh axis.  RecSys: tables
  row-sharded over ``model``, the MLP TP over ``model``.
* The ``pod`` axis never shards parameters.

``P`` is a tuple of per-dimension entries (None, an axis name, or a tuple
of names), normalised as JAX's ``PartitionSpec`` normalises them: a one-name
tuple is the name, an empty one None.  ``sanitize_spec`` drops assignments
that do not divide a dimension (it reads only ``mesh.shape``).

``place(tree, mesh, rule)`` is the placement: every leaf is cut into one
block a mesh position by its sanitized spec (a dimension assigned axes
``(a, b)`` is cut into ``|a|·|b|`` even blocks, row-major over the axes),
each block a contiguous tensor on its position's device.  A leaf a position
shares with another position on the same device (every replicated leaf,
and a leaf split over some axes only) is one tensor there, not a copy a
position.  The result is a ``Placed``: the global shapes, the specs, and a
tree of blocks a position, which the sharded LM (``models/spmd.py``) runs
on.

Training stores the tree by ``lm_param_spec`` and computes on
``lm_param_spec_tp``: ``reshard`` moves a ``Placed`` from one layout to
the other (the reference's ``with_sharding_constraint``), differentiably,
so the gradient comes back to storage as a reduce-scatter.  ``distinct``
lists the tree's blocks once each (a block positions share on one device
is one), the unit ``trainable`` makes an autograd leaf of and the
optimizer updates; ``with_blocks`` rebuilds a tree around new ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import mesh as M
from repro_torch.core.mesh import Mesh
from repro_torch.launch.mesh import batch_axes


class P(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, trailing
    dimensions unassigned."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def entry_axes(entry) -> tuple:
    """The axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop axis assignments that do not divide a dimension evenly.

    For a dim assigned a tuple of axes, trailing axes are dropped first
    (e.g. 1M rows over ('data','model')=256 -> ('data',)=16 when 1M % 256).
    Published configs have non-round dims (minicpm3 vocab=73448, DCN
    d_x0=429)."""
    if spec is None:
        return P()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries):
        axes = list(entry_axes(ent))
        while axes:
            if dim % int(np.prod([mesh.shape[a] for a in axes])) == 0:
                break
            axes.pop()
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes
                                                      else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------

def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def lm_param_spec(path: str, leaf) -> P:
    """STORAGE sharding: FSDP over ``data`` x TP over ``model``."""
    nd = _ndim(leaf)
    if "embed" in path and nd == 2:               # (vocab, d)
        return P("model", "data")
    if "['layers']" in path:
        if nd == 4:                               # (L, E, d, f) MoE experts
            return P(None, "model", "data", None)
        if nd == 3:                               # (L, d_in, d_out)
            return P(None, "data", "model")
        return P()                                # (L, d) norms etc.
    return P()


def lm_param_spec_tp(path: str, leaf) -> P:
    """COMPUTE sharding: pure TP, what serving runs under.  Contraction
    dims of the up projections are never sharded; down / out projections
    (``w_down``, ``wo``) contract on dim -2 and split there."""
    nd = _ndim(leaf)
    if "embed" in path and nd == 2:               # (vocab, d) vocab-sharded
        return P("model", None)
    if "['layers']" in path:
        down = ("w_down" in path) or ("wo" in path)
        if nd == 4:                               # (L, E, d, f): EP over E
            return P(None, "model", None, None)
        if nd == 3:
            if "router" in path:
                return P()
            return P(None, "model", None) if down else P(None, None, "model")
        return P()
    return P()


def lm_batch_spec(mesh) -> P:
    return P(batch_axes(mesh))


def lm_cache_spec(mesh, attn_type: str, batch: int, n_kv: int) -> dict:
    """Decode-cache specs.  The sequence dim shards over ``model``
    (flash-decoding's partial softmax), the batch over the data axes —
    unless the batch is smaller than the data axes, then the sequence takes
    every axis."""
    b_axes = batch_axes(mesh)
    b_size = int(np.prod([mesh.shape[a] for a in b_axes]))
    if batch >= b_size:
        seq_axes, bat = ("model",), b_axes
    else:                                          # long_500k: batch=1
        seq_axes, bat = b_axes + ("model",), ()
    if attn_type == "mla":
        return {"c_kv": P(None, bat or None, seq_axes, None),
                "k_rope": P(None, bat or None, seq_axes, None)}
    return {"k": P(None, bat or None, None, seq_axes, None),
            "v": P(None, bat or None, None, seq_axes, None)}


# --------------------------------------------------------------------------
# GNN, RecSys
# --------------------------------------------------------------------------

def gnn_param_spec(path: str, leaf) -> P:
    return P()                                     # replicated (small)


def gnn_edge_spec(mesh) -> P:
    """Edges shard over the whole mesh (graph parallelism)."""
    return P(tuple(mesh.axis_names))


def recsys_param_spec(path: str, leaf) -> P:
    nd = _ndim(leaf)
    if "tables" in path and nd == 2:               # (V, embed_dim)
        return P("model", None)
    if "mlp_w" in path and nd == 2:                # (d_in, d_h) TP
        return P(None, "model")
    return P()


PARAM_RULES = {"lm": lm_param_spec, "gnn": gnn_param_spec,
               "recsys": recsys_param_spec}


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def block_range(mesh: Mesh, spec: P, shape, dim: int, pos: int) -> tuple:
    """[start, stop) of mesh position ``pos``'s block along ``dim`` of a
    leaf of ``shape`` placed by the sanitized ``spec``."""
    axes = entry_axes(spec[dim]) if dim < len(spec) else ()
    if not axes:
        return 0, shape[dim]
    n = int(np.prod([mesh.shape[a] for a in axes]))
    size = shape[dim] // n
    i = mesh.group_index(pos, axes)
    return i * size, (i + 1) * size


def block_key(mesh: Mesh, spec: P, pos: int) -> tuple:
    """Positions with one key on one device hold the same block."""
    return tuple(mesh.group_index(pos, entry_axes(e)) for e in spec)


@dataclasses.dataclass
class Placed:
    """A tree placed on a mesh.  ``shapes`` / ``specs``: each leaf's global
    shape and sanitized spec by path; ``shards``: per mesh position, the
    tree (nested dicts and lists) of its blocks."""

    mesh: Mesh
    shapes: dict
    specs: dict
    shards: tuple

    def split(self, path: str, dim: int) -> tuple:
        """The axes leaf ``path``'s dimension ``dim`` is split over."""
        spec = self.specs[path]
        return entry_axes(spec[dim]) if dim < len(spec) else ()

    def range(self, path: str, dim: int, pos: int) -> tuple:
        return block_range(self.mesh, self.specs[path], self.shapes[path],
                           dim, pos)

    def bytes_per_shard(self) -> list:
        """Bytes of each position's blocks (a shared block counted for
        every position that holds it)."""
        return [sum(t.numel() * t.element_size() for t in T.leaves(s))
                for s in self.shards]

    def gather(self, path: str) -> torch.Tensor:
        """The global leaf, assembled from the blocks on the first shard's
        device (a fetch to the caller, not a collective: done for no mesh
        position)."""
        shape, spec = self.shapes[path], self.specs[path]
        dev = self.mesh.devices[0]
        first = _leaf(self.shards[0], path)
        with M.outside():
            out = torch.empty(shape, dtype=first.dtype, device=dev)
            for pos in range(self.mesh.size):
                idx = tuple(slice(*block_range(self.mesh, spec, shape, d,
                                               pos))
                            for d in range(len(shape)))
                out[idx] = _leaf(self.shards[pos], path).to(dev)
        return out


def _leaf(tree, path: str):
    for p, leaf in T.flatten_with_paths(tree):
        if p == path:
            return leaf
    raise KeyError(path)


def _spec(rule, path: str, leaf, shape, mesh: Mesh) -> P:
    """``rule``'s sanitized spec for a leaf: a rule function, or a dict of
    specs by path or by top-level key."""
    if isinstance(rule, dict):
        raw = rule.get(path, rule.get(path[2:-2], P()))
    else:
        raw = rule(path, leaf)
    return sanitize_spec(raw, shape, mesh)


def place(tree, mesh: Mesh, rule) -> Placed:
    """Cut every leaf of ``tree`` (a ``TransformerParams``, a cache dict,
    any tree ``repro_torch.tree`` walks) into blocks by
    ``sanitize_spec(rule(path, leaf), leaf.shape, mesh)`` and put each on
    its position's device.  ``rule`` may also be a dict of specs by path or
    by top-level key (``lm_cache_spec``'s).  A block that is the whole leaf,
    or a contiguous slice of it, on the leaf's own device is a view of it,
    not a copy."""
    flat = T.flatten_with_paths(tree)
    shapes, specs, per_pos = {}, {}, [[] for _ in range(mesh.size)]
    for path, leaf in flat:
        spec = _spec(rule, path, leaf, tuple(leaf.shape), mesh)
        shapes[path], specs[path] = tuple(leaf.shape), spec
        made = {}
        for pos in M.positions(mesh.size):
            dev = mesh.devices[pos]
            key = (dev, block_key(mesh, spec, pos))
            if key not in made:
                idx = tuple(slice(*block_range(mesh, spec, leaf.shape, d,
                                               pos))
                            for d in range(leaf.dim()))
                made[key] = leaf.detach()[idx].to(dev).contiguous()
            per_pos[pos].append(made[key])
    shards = tuple(T.unflatten(tree, blocks) for blocks in per_pos)
    return Placed(mesh, shapes, specs, shards)


# --------------------------------------------------------------------------
# training on a placed tree: storage -> compute, distinct blocks
# --------------------------------------------------------------------------

def reshard(placed: Placed, mesh: Mesh, rule) -> Placed:
    """``placed`` (in practice the storage layout, ``lm_param_spec``) in the
    layout ``rule`` gives (``lm_param_spec_tp``): the reference's
    ``with_sharding_constraint`` from storage to compute.

    Leaf by leaf: the dimensions whose entry differs between the two specs
    are gathered over the axes their storage entry splits (one
    ``all_gather_groups``, counted), then every position keeps its compute
    block of them; a dimension whose entry is the same keeps its block, and
    one the storage holds whole is only cut.  So ``wo`` / ``w_down``, whose
    storage splits rows over ``data`` and columns over ``model`` and whose
    compute splits rows over ``model``, gather over both axes and are cut
    again, and a leaf whose specs agree moves nothing.  Differentiable (a
    stack and views): a storage block's gradient is the sum, over the
    gathering group, of the compute blocks' gradients that cover it, the
    reduce-scatter back to storage.  Positions on one device share the
    assembled leaf; the blocks cut from it are views."""
    flat = [T.flatten_with_paths(s) for s in placed.shards]
    specs, per_pos = {}, [[] for _ in range(mesh.size)]
    for j, (path, first) in enumerate(flat[0]):
        shape, src = placed.shapes[path], placed.specs[path]
        dst = _spec(rule, path, first, shape, mesh)
        specs[path] = dst
        blocks = [f[j][1] for f in flat]
        for pos, b in M.each(_moved(mesh, blocks, shape, src, dst)):
            per_pos[pos].append(b)
    shards = tuple(T.unflatten(s, b) for s, b in zip(placed.shards, per_pos))
    return Placed(mesh, dict(placed.shapes), specs, shards)


def _moved(mesh: Mesh, blocks: list, shape, src: P, dst: P) -> list:
    """One leaf's blocks moved from spec ``src`` to spec ``dst``.  A spec
    names an axis once, so the axes gathered (the storage entries of the
    dimensions that differ) split no other dimension."""
    nd = len(shape)
    s_ax = [entry_axes(src[d]) if d < len(src) else () for d in range(nd)]
    moves = [s_ax[d] != (entry_axes(dst[d]) if d < len(dst) else ())
             for d in range(nd)]
    axes = [a for a in mesh.axis_names
            if any(a in s_ax[d] for d in range(nd) if moves[d])]
    full = list(blocks)
    if axes:
        order, grow = [], []
        for d in range(nd):
            if moves[d]:
                order += [axes.index(a) for a in s_ax[d]]
            order.append(len(axes) + d)
            grow.append(int(np.prod([mesh.shape[a] for a in s_ax[d]]))
                        if moves[d] else 1)
        assembled = {}
        for pos, g in M.each(M.all_gather_groups(mesh, axes, blocks)):
            if id(g) not in assembled:
                assembled[id(g)] = g.reshape(
                    [mesh.shape[a] for a in axes] + list(g.shape[1:])
                ).permute(order).reshape(
                    [g.shape[1 + d] * grow[d] for d in range(nd)])
            full[pos] = assembled[id(g)]
    out, made = [], {}
    for pos, t in M.each(full):
        key = (id(t), block_key(mesh, dst, pos))
        if key not in made:
            # a dimension gathered, or held whole, is cut to the position's
            # compute block; one that does not move keeps its block
            cut = [block_range(mesh, dst, shape, d, pos)
                   if moves[d] or not s_ax[d] else None for d in range(nd)]
            if all(c is None or c == (0, shape[d])
                   for d, c in enumerate(cut)):
                made[key] = t
            else:
                made[key] = t[tuple(slice(*c) if c else slice(None)
                                    for c in cut)]
        out.append(made[key])
    return out


def distinct(placed: Placed) -> list:
    """The tree's distinct blocks, each once: ``[(path, block)]`` leaf by
    leaf, positions in order within a leaf.  A block positions share (one
    tensor on one device) is one entry: the unit the optimizer updates and
    a gradient is taken for."""
    seen, out = set(), []
    flat = [T.flatten_with_paths(s) for s in placed.shards]
    for j in range(len(flat[0])):
        for f in flat:
            path, b = f[j]
            if id(b) not in seen:
                seen.add(id(b))
                out.append((path, b))
    return out


def with_blocks(placed: Placed, blocks: list) -> Placed:
    """``placed`` with its distinct blocks (``distinct``'s order) replaced by
    ``blocks``: the same shapes, specs and sharing."""
    new = {id(b): n for (_, b), n in zip(distinct(placed), blocks,
                                          strict=True)}
    shards = tuple(T.unflatten(s, [new[id(b)] for b in T.leaves(s)])
                   for s in placed.shards)
    return Placed(placed.mesh, dict(placed.shapes), dict(placed.specs),
                  shards)


def trainable(placed: Placed) -> Placed:
    """A copy of ``placed`` whose distinct blocks are autograd leaves
    (``requires_grad``), one a distinct block: positions that share a block
    share the leaf, so its gradient sums every position's use.  Copies, so
    that training never writes into the tensors ``placed`` viewed."""
    return with_blocks(placed, [b.detach().clone().requires_grad_(True)
                                for _, b in distinct(placed)])


def subtree(placed: Placed, keys) -> Placed:
    """The leaves under the top-level ``keys``, placed as they are."""
    pre = tuple(f"[{k!r}]" for k in keys)
    return Placed(placed.mesh,
                  {p: s for p, s in placed.shapes.items()
                   if p.startswith(pre)},
                  {p: s for p, s in placed.specs.items()
                   if p.startswith(pre)},
                  tuple({k: s[k] for k in keys} for s in placed.shards))


def layers(placed: Placed) -> list:
    """The stacked ``['layers']`` leaves a layer at a time: one ``Placed``
    a layer, each leaf kept stacked as a (1, ...) view, with the same specs
    (a spec never splits the layer axis).  Each distinct block is unbound
    once, so autograd sees one node a block whose backward stacks the
    layers' gradients (a slice a layer would scatter each layer's gradient
    into a zero tensor of the whole stack); a shared block's views are
    shared too."""
    sub = subtree(placed, ("layers",))
    n = next(iter(sub.shapes.values()))[0]
    views = {id(b): [v[None] for v in b.unbind(0)]
             for _, b in distinct(sub)}
    shapes = {p: (1,) + tuple(s[1:]) for p, s in sub.shapes.items()}
    return [Placed(placed.mesh, shapes, sub.specs,
                   tuple(T.unflatten(s, [views[id(b)][i]
                                         for b in T.leaves(s)])
                         for s in sub.shards))
            for i in range(n)]
