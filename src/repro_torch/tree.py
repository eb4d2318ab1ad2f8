"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Params and caches are plain nested dicts of tensors keyed exactly as the
JAX package's pytrees, so the weight bridge is a key-for-key copy.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise over one or more dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
