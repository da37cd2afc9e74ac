"""A step's work, counted as it runs: the port's counterpart of the
reference's ``launch/hlo_cost.py``.

The reference walks the compiled HLO of one device's SPMD program.  The port
compiles nothing: ``StepCost`` is a ``TorchDispatchMode`` that sees every
aten op a step runs — on meta tensors (the dry run: nothing is computed or
allocated) or on real ones — and counts what ``hlo_cost.py:1-24`` defines:

  flops        2 * result elements * K for every matmul-class op (``mm``,
               ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``: what
               ``einsum`` / ``matmul`` / ``linear`` reach) and convolution,
               forward and backward; elementwise work is not counted.  A
               hand-written kernel's call adds its ``kernels/cost.py`` work
               (on meta the wrapper computes nothing and reports it).
  bytes        every op's tensor inputs and outputs at their bytes; views
               cost nothing.  Eager ops are not fused, so this is the
               traffic an eager step moves: an upper bound on a fused
               program's (the reference bills fusion boundaries only).
  collectives  ``core/mesh.py``'s ``all_gather`` / ``all_gather_groups``
               (all-gather), ``psum`` (all-reduce) and ``psum_scatter``
               (reduce-scatter): kind, result bytes R and group size G a
               position, through ``analysis.parse_collectives``' ring
               factors.  The ops a collective runs (its stack, its sum)
               are the collective's, not ops; its R and operand bytes are
               added to the position's bytes, as the reference's walk adds
               a collective's result and operands.

Per position.  The reference reports one device's program.  The port's
sharded code visits every mesh position in one host loop, and a device
index cannot tell the positions apart (a meta tensor has none; on one card
all positions share it).  So each op is billed to the position it works
for: the position a ``core.mesh.positions`` / ``each`` loop has made
current; else the position that owns one of its inputs (an op's outputs
belong to the position it was billed to; a block of a placed argument
belongs to the position that holds it); else, where every input is shared
by several positions (a gathered stack, a replicated weight), the holders
in turn, one read of that storage each (a loop over the group reads it
once a position); else, for an op that reads no tensor, the position of the
op before it.  Work billed to no position (``core.mesh.outside``: the
prefill's logits fetch to the first shard) is reported on its own line.
Positions that share a device share what the port builds once a device (a
gathered stack, an assembled leaf): the first position to build it is
billed.  Results: position 0, the maximum over positions (``per_device``),
the mean and the total.  The forward's attribution is exact (the loops
name their positions); the backward's follows the tensors, and where a
gradient sums the contributions of several positions (a replicated
block's, a loss taken on one position) its ops go to one of them, so the
maximum overstates a position's share; on a mesh whose positions run the
same program the mean is the per-device figure, and ``analysis.analyze``
takes it.

Memory, with XLA's keys, a device as the positions' mean:
``argument_size_in_bytes`` (the positions' blocks of the arguments, a
shared block counted for each holder), ``output_size_in_bytes`` (their
blocks of the results), ``alias_size_in_bytes`` (results that are
arguments' storage: a train step's weights, updated in place),
``temp_size_in_bytes`` (the peak, over the step, of the bytes of the
storages it allocated and that were alive, summed over the positions,
less the results among them: each op output's storage counts from the op
until the storage dies) and ``peak_bytes_per_device`` (argument + output
+ temp - alias); beside them the highest position's own peak
(``peak_bytes_max_position``), which the backward's attribution can
inflate.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import mesh as M
from repro_torch.kernels import cost as KC
from repro_torch.launch.analysis import parse_collectives

OUTSIDE = M.OUTSIDE
_aten = torch.ops.aten
_EMPTY = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}


def _tensors(args, kwargs) -> list:
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


_MATMUL = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
           _aten.addmm: 1, _aten.baddbmm: 1, _aten.addmv: 1}
_CONV = (_aten.convolution, _aten.convolution_backward, _aten._convolution)
_FLOP_RULE: dict = {}


def op_flops(func, args, out) -> float:
    """2 * result elements * K for the matmul-class ops (K: the last dim of
    the left operand), the convolutions' count for those
    (``torch.utils.flop_counter``), 0 for the rest."""
    rule = _FLOP_RULE.get(func)
    if rule is None:
        p = func._overloadpacket
        rule = _FLOP_RULE[func] = (_MATMUL[p] if p in _MATMUL else
                                   "conv" if p in _CONV else -1)
    if rule == -1:
        return 0.0
    if rule == "conv":
        from torch.utils.flop_counter import flop_registry
        return float(flop_registry[func._overloadpacket](*args, out_val=out))
    return 2.0 * out.numel() * int(args[rule].shape[-1])


class StepCost(TorchDispatchMode):
    """Counts a step's work a mesh position at a time (module docstring).
    ``hold(args, mesh)`` names the arguments' owners first; ``result()``
    gives the totals."""

    def __init__(self, n_positions: int = 1):
        super().__init__()
        n = self.n = int(n_positions)
        self.flops = [0.0] * (n + 1)          # [n]: outside every position
        self.bytes = [0.0] * (n + 1)
        self.coll = [[] for _ in range(n)]    # (kind, R, G) a position
        self.kernels = {}                     # name -> calls / flops / bytes
        self.argument = [0] * n
        self.live = [0] * (n + 1)
        self.peak = [0] * (n + 1)
        self.sum_live = self.sum_peak = 0     # over every position at once
        self.ops = 0
        self._owner = {}      # storage -> position, or a tuple of holders
        self._new = {}        # storage the step allocated -> bytes
        self._reads = {}      # storage -> reads billed (shared storage)
        self._last = 0
        self._coll_kinds = []  # the collectives running (nested: psum's gather)
        self._outputs = None
        self._meta_cache = {}
        self._weak = set()    # storages owned through a gradient's chain
        self._stack_grads = {}  # a stack's gradient -> (row stride, positions)
        self._strong = True

    # -- attribution ---------------------------------------------------------

    def _where(self, ins) -> int:
        """The position an op on ``ins`` works for (module docstring);
        sets ``self._strong`` when that position is a loop's or an input
        made in one's (not one taken from a gradient's chain)."""
        self._strong = True
        p = M.current_position()
        if p is not None:
            return p
        if self.n == 1:
            return 0
        shared = weak = None
        for t in ins:
            key = _key(t)
            sg = self._stack_grads.get(key)
            if sg is not None:            # a row of a stack's gradient
                stride, positions = sg
                return positions[min(t.storage_offset() // max(stride, 1),
                                     len(positions) - 1)]
            o = self._owner.get(key)
            if isinstance(o, int) and o >= 0:
                if key not in self._weak:
                    return o
                if weak is None:
                    weak = o
            elif shared is None and isinstance(o, tuple):
                shared = key
        self._strong = False
        if weak is not None:
            return weak
        if shared is not None:
            holders = self._owner[shared]
            k = self._reads.get(shared, 0)
            self._reads[shared] = k + 1
            return holders[k % len(holders)]
        return self._last if not ins else OUTSIDE

    def _bill(self, pos: int, flops: float, nbytes: float) -> None:
        i = self.n if pos == OUTSIDE else pos
        self.flops[i] += flops
        self.bytes[i] += nbytes
        if pos != OUTSIDE:
            self._last = pos

    def _holders(self, owner) -> tuple:
        if isinstance(owner, tuple):
            return owner
        return (self.n if owner == OUTSIDE else owner,)

    def _allocated(self, t: torch.Tensor, owner,
                   counted: bool = True) -> None:
        key = _key(t)
        if key is None or key in self._owner:
            return                      # a view, an in-place result, an input
        st = t.untyped_storage()
        nb = int(st.nbytes()) if counted else 0
        self._owner[key] = owner
        if not self._strong:
            self._weak.add(key)
        self._new[key] = nb
        for i in self._holders(owner):
            self.live[i] += nb
            if self.live[i] > self.peak[i]:
                self.peak[i] = self.live[i]
            if i < self.n:
                self.sum_live += nb
        self.sum_peak = max(self.sum_peak, self.sum_live)
        weakref.finalize(st, self._freed, key, nb, owner)

    def _freed(self, key, nb: int, owner) -> None:
        if self._new.get(key) != nb or self._owner.get(key) != owner:
            return
        del self._new[key], self._owner[key]
        self._weak.discard(key)
        self._reads.pop(key, None)
        for i in self._holders(owner):
            self.live[i] -= nb
            if i < self.n:
                self.sum_live -= nb

    # -- the dispatch mode ---------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args, kwargs)
        if all(t.is_meta for t in ins) if ins else \
                str(kwargs.get("device")) == "meta":
            out = self._meta_call(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        outs = [t for t in outs if isinstance(t, torch.Tensor)]
        if self._coll_kinds:             # a collective's own stack or sum
            p = M.current_position()
            owner = p if p is not None else (M.current_group() or OUTSIDE)
            # a reduction's stack of the group's payloads is the port's way
            # to sum on one device; a device of the mesh holds the result
            # (a position's sum), not the stack
            counted = p is not None or self._coll_kinds[-1] == "all-gather"
            self._strong = True
            for t in outs:
                self._allocated(t, owner, counted)
            return out
        pos = self._where(ins)
        self.ops += 1
        if func.is_view or func in _EMPTY:
            nbytes = 0
        else:
            nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        self._bill(pos, op_flops(func, args, out) if outs else 0.0, nbytes)
        for t in outs:
            self._allocated(t, pos)
        return out

    # -- meta ops, from a cache ------------------------------------------------

    def _meta_call(self, func, args, kwargs):
        """``func`` on meta tensors.  PyTorch's meta kernels of elementwise
        ops are Python decompositions (about 0.5 ms an op), and the
        positions of a mesh run the same ops on the same shapes; so an op
        that returns new tensors is run once a signature (op, the inputs'
        shapes, strides and dtypes, the other arguments) and later calls
        get empty tensors of the outputs' shapes, strides and dtypes.  An
        in-place op returns the tensor it writes (a meta write changes
        nothing); views and everything else are run."""
        kind = _op_kind(func)
        if kind == "inplace":
            idx = _INPLACE[func]
            got = [args[i] if isinstance(i, int) else kwargs[i] for i in idx]
            return got[0] if len(got) == 1 else tuple(got)
        if kind != "functional":
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(kwargs))
            spec = self._meta_cache.get(key)
        except TypeError:                 # an unhashable argument
            return func(*args, **kwargs)
        if spec is None:
            out = func(*args, **kwargs)
            spec = _out_spec(out)
            if spec is not None:
                self._meta_cache[key] = spec
            return out
        if spec[0] == "T":
            return _empty(spec[1])
        return spec[0](_empty(x) for x in spec[1])

    # -- hooks of kernels/cost.py --------------------------------------------

    def kernel(self, name: str, flops: float, nbytes: float,
               inputs=()) -> None:
        pos = self._where(list(inputs))
        self._bill(pos, flops, nbytes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def collective_begin(self, kind: str, groups, payload_bytes,
                         result_bytes) -> None:
        self._coll_kinds.append(kind)
        for g in groups:
            for i in g:
                if i < self.n:
                    self.coll[i].append((kind, result_bytes[i], len(g)))
                    self.bytes[i] += result_bytes[i] + payload_bytes[i]

    def stack_grad(self, g: torch.Tensor, positions: tuple) -> None:
        """``g`` is the gradient of a stack of ``positions``' payloads: an
        op on its row j works for ``positions[j]``."""
        self._stack_grads[_key(g)] = (g.stride(0), positions)

    def collective_end(self) -> None:
        self._coll_kinds.pop()

    # -- arguments and results -----------------------------------------------

    def hold(self, tree, mesh=None) -> None:
        """Name the owners of a step's arguments: a ``Placed`` tree's or a
        ``Sharded``'s blocks belong to the positions that hold them, a list
        of one tree a position (the halo batch) to those positions, any
        other tensor to position 0."""
        per = _per_position(tree, self.n)
        holders = {}
        for pos, ts in enumerate(per):
            seen = set()
            for t in ts:
                key = _key(t)
                holders.setdefault(key, [])
                if pos not in holders[key]:
                    holders[key].append(pos)
                if (key, t.storage_offset(), tuple(t.shape)) not in seen:
                    seen.add((key, t.storage_offset(), tuple(t.shape)))
                    self.argument[pos] += t.nbytes
        for key, hs in holders.items():
            if key is not None:
                self._owner[key] = hs[0] if len(hs) == 1 else tuple(hs)

    def outputs(self, result) -> None:
        """Record the step's results (``output`` / ``alias`` / ``temp``)."""
        self._outputs = result

    def result(self) -> dict:
        n = self.n
        out_b, alias, new_b = [0] * n, [0] * n, [0] * n
        if self._outputs is not None:
            for pos, ts in enumerate(_per_position(self._outputs, n)):
                seen = set()
                for t in ts:
                    key = _key(t)
                    if (key, t.storage_offset(), tuple(t.shape)) in seen:
                        continue
                    seen.add((key, t.storage_offset(), tuple(t.shape)))
                    out_b[pos] += t.nbytes
                    if key in self._new:
                        new_b[pos] += t.nbytes
                    else:
                        alias[pos] += t.nbytes
        peaks = [self.argument[p] + out_b[p] - alias[p]
                 + max(0, self.peak[p] - new_b[p]) for p in range(n)]
        # a device's memory: the positions' mean, the step's allocations
        # summed over every position at once (free of which position a
        # backward op was billed to; on a mesh whose positions run one
        # program, each position's)
        temp = max(0, self.sum_peak - sum(new_b)) / n
        memory = {"argument_size_in_bytes": sum(self.argument) / n,
                  "output_size_in_bytes": sum(out_b) / n,
                  "temp_size_in_bytes": temp,
                  "alias_size_in_bytes": sum(alias) / n}
        memory["peak_bytes_per_device"] = (
            memory["argument_size_in_bytes"] + memory["output_size_in_bytes"]
            + temp - memory["alias_size_in_bytes"])
        top = max(range(n), key=lambda p: peaks[p])
        memory.update(peak_bytes_max_position=peaks[top], peak_position=top,
                      peak_bytes_position_0=peaks[0],
                      outside_peak_bytes=self.peak[n])
        colls = [parse_collectives(c) for c in self.coll]
        ctop = max(range(n), key=lambda p: colls[p]["total_bytes"])

        def split(v):
            return {"position_0": v[0], "per_device": max(v[:n]),
                    "mean": sum(v[:n]) / n, "total": sum(v[:n]),
                    "outside": v[n]}

        return {"n_positions": n, "ops": self.ops,
                "flops": split(self.flops), "bytes": split(self.bytes),
                "collectives": colls[ctop],
                "collectives_position": ctop,
                "collectives_position_0": colls[0],
                "kernels": self.kernels, "memory": memory}


_KINDS: dict = {}
_INPLACE: dict = {}


def _op_kind(func) -> str:
    """"functional" (returns new tensors), "inplace" (returns the tensors
    it writes, ``_INPLACE[func]`` their argument positions or names) or
    "call" (views, metadata changes, the rest)."""
    kind = _KINDS.get(func)
    if kind is not None:
        return kind
    schema = func._schema
    rets = schema.returns
    name = schema.name
    kind = "call"
    if func.is_view or not rets or "resize" in name or "set_" in name:
        pass
    elif all(r.alias_info is None for r in rets):
        kind = "functional" if all(str(r.type) in ("Tensor", "Tensor[]")
                                   for r in rets) else "call"
    elif all(r.alias_info is not None and r.alias_info.is_write
             for r in rets):
        idx = []
        for r in rets:
            for i, a in enumerate(schema.arguments):
                if a.alias_info is not None and \
                        a.alias_info.before_set == r.alias_info.before_set:
                    idx.append(a.name if a.kwarg_only else i)
                    break
        if len(idx) == len(rets):
            _INPLACE[func] = idx
            kind = "inplace"
    _KINDS[func] = kind
    return kind


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    hash(x)
    return x


def _out_spec(out):
    if isinstance(out, torch.Tensor):
        return ("T", (tuple(out.shape), out.stride(), out.dtype))
    if isinstance(out, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return (type(out), tuple((tuple(t.shape), t.stride(), t.dtype)
                                 for t in out))
    return None


def _empty(spec) -> torch.Tensor:
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _per_position(tree, n: int) -> list:
    """Per mesh position, the tensors of ``tree`` it holds."""
    from repro_torch.launch.sharding import Placed
    from repro_torch.tree import leaves
    per = [[] for _ in range(n)]

    def walk(x):
        if isinstance(x, Placed):
            for pos, sh in enumerate(x.shards):
                per[pos].extend(t for t in leaves(sh)
                                if isinstance(t, torch.Tensor))
        elif isinstance(x, M.Sharded):
            for pos, b in enumerate(x.blocks):
                per[pos].append(b)
        elif isinstance(x, torch.Tensor):
            per[0].append(x)
        elif isinstance(x, (list, tuple)) and n > 1 and len(x) == n and all(
                isinstance(s, dict) for s in x):
            for pos, sh in enumerate(x):
                per[pos].extend(t for t in leaves(sh)
                                if isinstance(t, torch.Tensor))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(tree)
    return per


def count_step(step, args, mesh=None) -> tuple:
    """Run ``step(*args)`` under a ``StepCost`` for ``mesh``'s positions;
    returns (the step's result, ``StepCost.result()``)."""
    n = mesh.size if mesh is not None else 1
    counter = StepCost(n)
    counter.hold(args, mesh)
    token = M._POSITION.set(None)
    try:
        with KC.listen(counter), counter:
            out = step(*args)
            counter.outputs(out)
    finally:
        M._POSITION.reset(token)
    return out, counter.result()
