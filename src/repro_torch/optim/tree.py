"""Leaves of a parameter tree (nested dicts and lists of tensors).

``leaves`` walks dicts in sorted-key order and lists in order, as
``jax.tree.leaves`` does, so that reductions over a tree (the global
norm) add the leaves in the JAX package's order.
"""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, flat):
    """A tree of ``tree``'s structure whose leaves are taken from the
    iterable ``flat``, in ``leaves`` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)
