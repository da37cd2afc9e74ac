"""Elastic scaling: resume a run on a different mesh than it was saved from
(the port of the reference's ``training/elastic.py``).

The checkpoint format (``training/checkpoint.py``) stores full logical
arrays, so elasticity reduces to choosing each leaf's place on the new mesh
at restore.  The port has no ``NamedSharding``: a leaf is not split over
devices, it lives whole on one device of the ``core.mesh.Mesh``, and
``rules(path, leaf)`` picks which (a ``torch.device`` of the mesh, or None
for the mesh's first device) — where the reference's rules give a
``PartitionSpec``.

  * ``reshard_tree(tree, mesh, rules)`` — move every leaf to its device.
  * ``elastic_restore(ckpt_dir, like, mesh, rules)`` — restore + place in
    one call; a change of mesh needs no checkpoint conversion.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.core.mesh import Mesh
from repro_torch.training import checkpoint as ckpt


def device_tree(tree: Any, mesh: Mesh, rules: Callable) -> Any:
    """A device for every leaf via ``rules(path, leaf)`` (the reference's
    ``sharding_tree``)."""
    out = []
    for path, leaf in T.flatten_with_paths(tree):
        dev = rules(path, leaf)
        dev = mesh.devices[0] if dev is None else torch.device(dev)
        if dev not in mesh.devices:
            raise ValueError(f"{path}: rules chose {dev}, not a device of "
                             f"the mesh {mesh.devices}")
        out.append(dev)
    return T.unflatten(tree, out)


def reshard_tree(tree: Any, mesh: Mesh, rules: Callable) -> Any:
    return T.tree_map(lambda x, dev: x.to(dev), tree,
                      device_tree(tree, mesh, rules))


def elastic_restore(ckpt_dir: str, like: Any, mesh: Optional[Mesh] = None,
                    rules: Optional[Callable] = None):
    """Restore LATEST onto the current mesh.  Returns (tree, step, extra) or
    None.  With mesh / rules None, each leaf goes where ``like``'s is."""
    devices = None
    if mesh is not None and rules is not None:
        devices = device_tree(like, mesh, rules)
    return ckpt.restore(ckpt_dir, like, devices)
