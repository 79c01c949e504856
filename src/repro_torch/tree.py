"""Parameter trees of dicts and lists: the port's stand-in for JAX pytrees.

Parameters, gradients, optimizer moments and serving caches are nested
``dict``s and ``list``s of tensors shaped like the JAX package's pytrees
(the LM's ``params["stages"]`` and its cache are lists), so a JAX tree
bridges with one copy (:mod:`repro_torch.interop`) and trees compare leaf by
leaf.  Anything else, tuples included, is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and congruent ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _children(tree: Any) -> list[tuple[Any, Any]] | None:
    """``(key, child)`` pairs in JAX's flattening order (dict keys sorted,
    lists by index), or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def tree_leaves(tree: Any) -> list:
    """Leaves depth-first in JAX's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in tree_leaves(child)]


def tree_paths(tree: Any, prefix: str = "") -> list[str]:
    """``"a/0/b"`` path of every leaf, in :func:`tree_leaves` order."""
    kids = _children(tree)
    if kids is None:
        return [prefix.rstrip("/")]
    return [p for k, child in kids for p in tree_paths(child, f"{prefix}{k}/")]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Rebuild a tree shaped like ``like`` from :func:`tree_leaves` order."""
    return _build(like, iter(leaves))


def _build(node: Any, it) -> Any:
    # a module-level function, not a closure over ``it``: a recursive closure
    # is a reference cycle, and its cell would hold the leaves' list (every
    # step's tensors) until the cyclic collector ran
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_build(child, it) for child in node]
    return next(it)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over every leaf, ``path`` as :func:`tree_paths`
    spells it (``"stages/0/sub0/attn/wq/w"``, the JAX package's
    ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix.rstrip("/"), tree)
