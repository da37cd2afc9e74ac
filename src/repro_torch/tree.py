"""Nested containers of tensors: the port's counterpart of the parts of
``jax.tree_util`` that training uses.

A tree is a dict, a list or tuple, a ``models.transformer.ParamTree``, or a
leaf (a tensor, a numpy array or a scalar).  Leaves come in JAX's order —
a dict's keys sorted, a list's items in turn — and each leaf's path is the
string ``jax.tree_util.keystr`` gives it (``['params']['blocks'][0]['A']``),
so a checkpoint's keys are the same in both packages.  ``tree_map`` and
``unflatten`` build plain dicts and lists, whatever container they read.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    """``(is_dict, [(key, child)])`` of a container, in JAX's order; None
    for a leaf."""
    if isinstance(tree, dict) or getattr(tree, "is_list", None) is False:
        return True, [(k, tree[k]) for k in sorted(tree.keys())]
    if isinstance(tree, (list, tuple)) or getattr(tree, "is_list", None):
        return False, list(enumerate(tree))
    return None


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in JAX's leaf order."""
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    is_dict, kids = node
    out = []
    for key, child in kids:
        path = f"{prefix}[{key!r}]" if is_dict else f"{prefix}[{key}]"
        out += flatten_with_paths(child, path)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure (as plain dicts and lists) holding
    ``values`` in leaf order."""
    it = iter(values)

    def build(t):
        node = _children(t)
        if node is None:
            return next(it)
        is_dict, kids = node
        if is_dict:
            return {k: build(child) for k, child in kids}
        return [build(child) for _, child in kids]

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), as a tree of ``tree``'s structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others, strict=True)])
