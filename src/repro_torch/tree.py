"""Nested parameter and state trees: the port's counterpart of `jax.tree`.

A tree is a dict, a list or None, nested; anything else is a leaf. The
leaf order is `jax.tree.leaves` order: dict keys sorted at every level
(`bias` before `kernel`), list entries in order, None holding no leaf.
So a raveled (C, N) matrix matches the reference's column for column,
and a model's parameter tree or decode state (lists of per-layer dicts)
lists its leaves as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in sorted-key, list order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply `fn` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """Rebuild `template`'s structure from leaves in `tree_leaves`
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
