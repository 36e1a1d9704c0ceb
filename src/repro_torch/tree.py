"""Nested-dict parameter trees: map, flatten and rebuild.

The port keeps the JAX package's trees as nested dicts of tensors.  Leaves
are visited in sorted-key order, the order in which ``jax.tree.leaves``
flattens a dict, so sums over a tree (``optim.global_norm``) add their
terms in the same order on both sides.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (sorted-key order)."""
    return _build(like, iter(leaves))


def _build(like, it):
    # a module-level function: a nested one that recursed through its own
    # closure would be a reference cycle holding ``leaves`` (a step's whole
    # gradient) until the garbage collector happened to run
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    return next(it)
