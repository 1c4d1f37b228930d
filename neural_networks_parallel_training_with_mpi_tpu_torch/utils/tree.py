"""Parameter trees: nested dicts, lists, tuples and NamedTuples with
tensor leaves — the port's stand-in for JAX pytrees.  Leaf order is
insertion order of dicts, then list/field order (``jax.tree_util`` sorts
dict keys: ``utils.checkpoint.flatten`` gives its order)."""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor leaf, in tree order."""
    out: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over aligned tensor leaves of ``tree`` and ``rest``; other
    leaves (ints, None) pass through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def unflatten(tree: Any, flat: List[torch.Tensor]) -> Any:
    """A tree shaped like ``tree`` whose tensor leaves are ``flat``, in
    order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
