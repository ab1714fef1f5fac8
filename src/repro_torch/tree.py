"""Pytrees of tensors: the walk the port's operators share.

A tree is a tensor (a leaf), ``None`` (no leaf), or a dict, list, tuple
or NamedTuple of trees; anything else (a Python scalar, a numpy array)
is a leaf too.  Dict leaves come in sorted key order, as
``jax.tree.leaves`` gives them, so a sum over leaves adds in the
reference's order and a checkpoint's leaves line up with the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure; a dict keeps
    its keys' order, ``None`` stays ``None``."""
    t = trees[0]
    if torch.is_tensor(t):
        return fn(*trees)
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if is_namedtuple(t):
        return type(t)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def leaves(tree) -> List[Any]:
    """The leaves in the reference's order (dict keys sorted)."""
    if torch.is_tensor(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, values):
    """``like``'s structure with its leaves, in ``leaves`` order,
    replaced by ``values``."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the structure has leaves")
    return out
