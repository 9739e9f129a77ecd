"""Nested-dict parameter trees: the port's counterpart of `jax.tree`.

Parameters are nested dicts of tensors with the reference's keys. The
leaf order is `jax.tree.leaves` order, which sorts dict keys at every
level (`bias` before `kernel`), so a raveled (C, N) matrix matches the
reference's column for column.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply `fn` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """Rebuild `template`'s structure from leaves in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
