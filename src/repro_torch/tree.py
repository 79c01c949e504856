"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are nested ``dict``s of tensors
shaped like the JAX package's pytrees, so a JAX tree bridges with one copy
(:mod:`repro_torch.interop`) and gradients compare leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and congruent ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in key-sorted depth-first order (JAX's dict flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree: Any, prefix: str = "") -> list[str]:
    """``"a/b"`` path of every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Rebuild a tree shaped like ``like`` from :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)
