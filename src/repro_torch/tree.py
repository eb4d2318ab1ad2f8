"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Params and caches are plain nested dicts of tensors keyed exactly as the
JAX package's pytrees, so the weight bridge is a key-for-key copy.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise over one or more dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """`fn(key_path, leaf)` leafwise, keeping `tree`'s structure and key
    order."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten(tree: Any, path: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in `jax.tree` order: dict keys sorted at
    every level. The ring layout of secure aggregation, the DP noise draws
    and checkpointed tail leaves follow this order, so they line up with
    the JAX package's."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_flatten(tree[k],
                                                                path + (k,))]
    return [(path, tree)]

