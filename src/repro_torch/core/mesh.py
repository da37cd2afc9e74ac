"""A single-controller device mesh and its collectives (the port's
counterpart of ``jax.make_mesh`` / ``jax.sharding.Mesh`` and of
``jax.lax.all_gather`` / ``psum`` under ``shard_map``).

The reference runs one Python process over a list of devices: ``shard_map``
hands each shard its block of the inputs and the collectives join them.  The
port keeps that programming model.  A ``Mesh`` is a tuple of torch devices
laid out over named axes; the engines of ``core/distributed.py`` and
``dynamic/sharded.py`` loop over its shards on the host, each shard's
tensors living on its own device, and exchange with ``all_gather``.  On one
card the D shards share that card; on a host with several cards a mesh made
with ``devices=`` puts one shard on each, and the gather is a peer copy.
There is no process group: nothing here is ``torch.distributed``.

    mesh = make_mesh((4,), ("data",), device="cpu")     # tests
    mesh = make_mesh((4,), ("data",))                   # the CUDA device
    mesh.shape["data"]                                  # 4

The coloring engines shard over the whole mesh (``shard_devices``) and
gather with ``all_gather``; their ``psum`` is a gather of one scalar a
shard and a sum.  The sharded LM (``models/spmd.py``) works on groups: the
shards of one axis that share the other axes' coordinates (``groups``: the
``model`` shards of each ``data`` row), with ``all_gather_groups``,
``psum`` and ``psum_scatter`` run in every group at once; all three are
stacks, views and sums, so autograd runs through them (the backward of a
gather is a reduce-scatter, of a ``psum_scatter`` a gather, uncounted).
Every collective counts one in
``mesh.collectives`` and the payloads' bytes (all shards' payloads
together) in ``mesh.gathered_bytes`` (``obs.metrics``), so "RSOC: one
collective a round, CAT: two" is a number a caller reads.  While a cost
counter listens (``launch/cost.py``) each collective also reports its
kind, result bytes and group size a position (``kernels/cost.py``), and
``positions`` / ``each`` loops name the position a loop body works for.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import cost
from repro_torch.obs import metrics as obs_metrics

# the mesh position whose work runs now (None: no position's), and the
# group a collective is stacking for: the dry run's counter
# (``launch/cost.py``) bills each op to the position it works for
_POSITION = contextvars.ContextVar("mesh_position", default=None)
_GROUP = contextvars.ContextVar("mesh_group", default=None)


OUTSIDE = -1     # the position of work done for no position (a fetch)


@contextlib.contextmanager
def outside():
    """Work in the scope is done for no mesh position: the fetch of a
    result to the caller (``current_position`` is ``OUTSIDE``)."""
    token = _POSITION.set(OUTSIDE)
    try:
        yield
    finally:
        _POSITION.reset(token)


def current_position() -> Optional[int]:
    """The mesh position a ``positions`` / ``each`` loop is working for."""
    return _POSITION.get()


def current_group() -> Optional[tuple]:
    """The positions a collective is stacking a payload for."""
    return _GROUP.get()


def _at(var, value):
    """Generator helper: ``var`` is ``value`` while the caller's loop body
    runs, and is restored when the body asks for the next item."""
    token = var.set(value)
    try:
        yield
    finally:
        try:
            var.reset(token)
        except ValueError:        # closed from another context: nothing set
            pass


class positions:
    """``range(n)`` over mesh positions whose iteration makes each position
    current (``current_position``) while the loop's body works for it.  The
    port's sharded code runs every position in one host loop; this is how
    the dry run tells the positions' work apart (a device index cannot: a
    meta tensor has none)."""

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        return range(self.n)[i]

    def __iter__(self):
        for i in range(self.n):
            for _ in _at(_POSITION, i):
                yield i


def each(items):
    """``enumerate(items)`` with item i's position current while the loop's
    body works on it (``positions``)."""
    for i, x in enumerate(items):
        for _ in _at(_POSITION, i):
            yield i, x


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over named axes; frozen and hashable."""

    devices: tuple          # torch.device per mesh position, row-major
    axis_names: tuple       # str per axis
    axis_sizes: tuple       # int per axis

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis_names {self.axis_names} and axis_sizes "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if int(np.prod(self.axis_sizes)) != len(self.devices):
            raise ValueError(f"mesh shape {self.axis_sizes} needs "
                             f"{int(np.prod(self.axis_sizes))} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def shard_devices(self, axis: str) -> tuple:
        """The devices of the shards of ``axis`` ("a" or "a,b"), in the
        row-major order of those axes: the order of ``all_gather(tiled=
        False)`` under ``shard_map`` (shard d of the flattened axis is
        entry d).  The named axes must cover the mesh: the coloring
        engines shard over all of it (a part of the mesh is ``groups``)."""
        names = self._names(axis)
        if sorted(names) != sorted(self.axis_names):
            raise ValueError(
                f"axis {axis!r} must name every axis of the mesh "
                f"{self.axis_names}: the port shards over the whole mesh")
        return tuple(self.devices[i] for i in self.groups(axis)[0])

    def _names(self, axis) -> tuple:
        names = tuple(a for a in (axis.split(",") if isinstance(axis, str)
                                  else axis) if a)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axis {unknown} not in mesh axes "
                             f"{self.axis_names}")
        return names

    def groups(self, axis) -> tuple:
        """The groups of ``axis`` (a name, "a,b", or a tuple of names; an
        empty one is no axis): the mesh positions (row-major indices into
        ``devices``) that share every other axis's coordinate, each group
        in the row-major order of the named axes, the groups in the
        row-major order of the other axes.  On a (data 2, model 2) mesh
        ``groups("model")`` is ((0, 1), (2, 3)) and ``groups("data")``
        ((0, 2), (1, 3)); axes that cover the mesh make one group."""
        names = self._names(axis)
        rest = [a for a in self.axis_names if a not in names]
        pos = np.arange(self.size).reshape(self.axis_sizes)
        order = pos.transpose([self.axis_names.index(a)
                               for a in rest + list(names)])
        n = int(np.prod([self.shape[a] for a in names]))
        return tuple(tuple(int(i) for i in g)
                     for g in order.reshape(-1, n))

    def group_index(self, pos: int, axis) -> int:
        """Position ``pos``'s index within its group of ``axis`` (its
        flattened coordinate over the named axes)."""
        names = self._names(axis)
        coords = np.unravel_index(pos, self.axis_sizes)
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + int(
                coords[self.axis_names.index(a)])
        return idx


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A value held across a mesh: one block a mesh position (row-major),
    each on its position's device."""

    mesh: Mesh
    blocks: tuple


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``prod(shape)`` shards.  ``devices`` places them one by
    one (row-major); otherwise every shard is on ``device`` — None: the
    CUDA device, raising where there is none, as everywhere in the port."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if devices is None:
        # api imports the engine modules, which import this one
        from repro_torch.api import _resolve_device
        dev = _resolve_device(device)
        devices = (dev,) * int(np.prod(shape))
    else:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devices = tuple(torch.device(d) for d in devices)
        for d in devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {str(d)!r} was asked for but no "
                                   f"CUDA device is available")
    return Mesh(devices=tuple(devices), axis_names=axis_names,
                axis_sizes=shape)


def all_gather(payloads: Sequence[torch.Tensor]) -> list:
    """``jax.lax.all_gather(x, axis, tiled=False)`` over the shards: given
    shard d's payload (all of one shape and dtype, each on its shard's
    device), returns for every shard the (D, ...) stack of all payloads on
    that shard's device.  Shards on one device share one stacked tensor (it
    is read, never written).  Counts one collective and the stacked
    payload's bytes."""
    D = len(payloads)
    nb = _nbytes(payloads)
    with cost.collective("all-gather", (tuple(range(D)),), nb,
                         [D * b for b in nb]):
        for _ in _at(_GROUP, tuple(range(D))):
            out = _stack(payloads)
    _count(payloads)
    return out


def _nbytes(payloads) -> list:
    return [p.numel() * p.element_size() for p in payloads]


def _stack(payloads: Sequence[torch.Tensor]) -> list:
    """``all_gather``'s stacks, uncounted."""
    first = payloads[0]
    for p in payloads[1:]:
        if p.shape != first.shape or p.dtype != first.dtype:
            raise ValueError(f"all_gather payloads differ: {tuple(p.shape)} "
                             f"{p.dtype} against {tuple(first.shape)} "
                             f"{first.dtype}")
    out, by_dev = [], {}
    for p in payloads:
        g = by_dev.get(p.device)
        if g is None:
            g = torch.stack([q.to(p.device) for q in payloads])
            cost.stacked(g, _GROUP.get() or range(len(payloads)))
            by_dev[p.device] = g
        out.append(g)
    return out


def _count(payloads) -> None:
    obs_metrics.counter("mesh.collectives").inc()
    obs_metrics.counter("mesh.gathered_bytes").inc(
        sum(p.numel() * p.element_size() for p in payloads))


def all_gather_groups(mesh: Mesh, axis, payloads: Sequence[torch.Tensor]
                      ) -> list:
    """``all_gather(x, axis, tiled=False)`` in every group of ``axis`` at
    once: ``payloads`` holds one tensor a mesh position (row-major, each on
    its position's device, all of one shape and dtype within a group);
    returns for every position the (n, ...) stack of its group's payloads,
    in group order, on its device (positions of one group on one device
    share it).  One collective; a group of one shard moves nothing and
    counts nothing."""
    groups = mesh.groups(axis)
    n = len(groups[0])
    if n == 1:
        return [p[None] for p in payloads]
    nb = _nbytes(payloads)
    with cost.collective("all-gather", groups, nb, [n * b for b in nb]):
        out = _group_stacks(mesh, groups, payloads)
    _count(payloads)
    return out


def _group_stacks(mesh: Mesh, groups, payloads) -> list:
    """Every position's stack of its group's payloads, uncounted."""
    out = [None] * mesh.size
    for g in groups:
        for _ in _at(_GROUP, g):
            stacked = _stack([payloads[i] for i in g])
        for i, t in zip(g, stacked):
            out[i] = t
    return out


def psum(mesh: Mesh, axis, payloads: Sequence[torch.Tensor]) -> list:
    """``jax.lax.psum(x, axis)``: for every mesh position the sum of its
    group's payloads, in the payloads' dtype (the wire's), summed in group
    order.  One collective (a gather and a sum); none for groups of one."""
    groups = mesh.groups(axis)
    if len(groups[0]) == 1:
        return list(payloads)
    nb = _nbytes(payloads)
    with cost.collective("all-reduce", groups, nb, nb):
        out = [g.sum(0) for _, g in each(_group_stacks(mesh, groups,
                                                         payloads))]
    _count(payloads)
    return out


def psum_scatter(mesh: Mesh, axis, payloads: Sequence[torch.Tensor],
                 dim: int) -> list:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    for every mesh position its block along ``dim`` of its group's sum (the
    group index's block, ``size / n`` wide), summed in group order as
    ``psum`` sums.  One collective, the payloads' bytes, as ``psum``; none
    for groups of one.  Differentiable: a position's gradient reaches every
    payload of its group at its block, so the backward is an all-gather."""
    groups = mesh.groups(axis)
    n = len(groups[0])
    if n == 1:
        return list(payloads)
    dim %= payloads[0].dim()
    size = payloads[0].shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size {size} does "
                         f"not divide over {n} positions")
    blk = size // n
    nb = _nbytes(payloads)
    with cost.collective("reduce-scatter", groups, nb,
                         [b // n for b in nb]):
        out = [t.narrow(dim + 1, mesh.group_index(i, axis) * blk,
                        blk).sum(0)
               for i, t in each(_group_stacks(mesh, groups, payloads))]
    _count(payloads)
    return out


def collectives() -> int:
    """Gathers counted since the last ``obs.metrics.reset()``."""
    return obs_metrics.counter_value("mesh.collectives")


def gathered_bytes() -> int:
    """Bytes of the gathered payloads counted since the last reset."""
    return obs_metrics.counter_value("mesh.gathered_bytes")
