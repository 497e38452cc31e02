"""Nested dicts of tensors (a model's parameters, gradients, moments):
their leaves and an element-wise map, both in sorted key order, the order
JAX flattens a dict in."""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)
