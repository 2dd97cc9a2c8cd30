"""Pytrees of the training plane, flattened as ``jax.tree`` flattens them.

A tree is a nested ``dict`` (keys taken in sorted order), ``tuple`` or
``list`` (``NamedTuple`` fields in order), ``None`` (no leaf) or a leaf
(a tensor, a numpy array, a number).  Flattening in the reference's order
makes a checkpoint's ``leaf_i`` the same leaf in either package.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like: PyTree, items: list) -> PyTree:
    """``like``'s structure over ``items`` (in :func:`leaves` order)."""
    it = iter(items)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more items than leaves")
    return out


def map_leaves(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (same structures), as ``jax.tree.map``."""
    cols = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("map_leaves: trees of different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree: PyTree) -> str:
    """``str(jax.tree.structure(tree))`` for these trees: what a
    checkpoint's ``meta.json`` records as ``treedef``."""
    def d(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {d(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(d(x) for x in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(d(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(d(x) for x in t) + "]"
        return "*"
    return f"PyTreeDef({d(tree)})"
