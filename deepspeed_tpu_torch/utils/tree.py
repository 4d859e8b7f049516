"""Nested-dict parameter trees (the port's stand-in for ``jax.tree_util``).

A tree is a dict (or list/tuple) of trees, or a leaf.  Dict keys are walked
in sorted order, as JAX flattens a dict, so reductions over the leaves
(global norms) add them up in the JAX package's order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, ``path`` the keys (and list
    indices) joined by '/' as the JAX package's ``path_str`` spells them
    ('layers/wq', 'embed')."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, f"{prefix}{i}/")
                          for i, x in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_flatten_with_path(tree: Any) -> List[tuple]:
    """``[(path, leaf), ...]`` in :func:`tree_leaves` order."""
    out: List[tuple] = []
    tree_map_with_path(lambda path, x: out.append((path, x)), tree)
    return out


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


__all__ = ["tree_map", "tree_leaves", "tree_unflatten_like", "tree_map_with_path",
           "tree_flatten_with_path"]
