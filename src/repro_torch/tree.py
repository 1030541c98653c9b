"""Nested dicts and lists of tensors (the port's parameter trees).

``tree_leaves`` visits dict keys in sorted order, as ``jax.tree_util`` does,
so a sum over leaves (``optim.global_norm``) adds in the reference's order;
``tree_map`` keeps the structure of its first tree.  A NamedTuple is a leaf:
optimizer states are built field by field, never mapped whole.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves, dict keys sorted (``jax.tree_util.tree_leaves``' order)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if type(tree) in (list, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, Mapping):
            vals = {k: take(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if type(node) in (list, tuple):
            return type(node)(take(v) for v in node)
        return next(it)

    out = take(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out
