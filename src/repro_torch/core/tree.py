"""Pytree helpers for the CRDT states: NamedTuples, dicts, lists and tuples
of tensors (the shapes ``jax.tree`` walks in the JAX package).  Dict keys
are visited in sorted order, as ``jax.tree.leaves`` does."""
from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree: Any) -> list[torch.Tensor]:
    """Every tensor of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if tree is None:
        return []
    raise TypeError(f"not a tensor tree node: {type(tree).__name__}")


def map(fn: Callable, tree: Any, *rest: Any,
        is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over matching leaves of ``tree`` and ``rest``; the result keeps
    ``tree``'s structure (NamedTuple types included)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, v, *(r[i] for r in rest),
                                is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tensor tree node: {type(tree).__name__}")


def unflatten(like: Any, flat: list) -> Any:
    """``flat`` (in ``leaves(like)`` order) rebuilt in ``like``'s structure
    (NamedTuple types included): the inverse of :func:`leaves`."""
    it = iter(flat)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        raise TypeError(f"not a tensor tree node: {type(node).__name__}")

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
