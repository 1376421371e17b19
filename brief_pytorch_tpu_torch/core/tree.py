"""Walks over parameter trees: nested dicts and lists whose leaves are
tensors or numpy arrays.

Every φ family's parameters are such a tree ({"layers": [...]} for chains,
plus {"encoder": {"bvals"}} for FFN; {"linear", "output", "filters"} for the
MFNs), with the JAX package's keys.  Two orders matter:

  * `tree_leaves`: dicts in insertion order (a layer is w then b), the order
    the optimizer's moments and the trainstate's p{i} leaves are kept in;
  * `tree_leaves_sorted`: dict keys sorted, lists in order — the order of
    jax.tree_util.tree_flatten, which the JAX package's params.npz container
    numbers its leaves by (io/modelsave.py).
"""
from __future__ import annotations

from typing import Any, Callable, List


def _keys(tree: dict, sort: bool):
    return sorted(tree) if sort else list(tree)


def _walk(tree: Any, sort: bool, out: List) -> List:
    if isinstance(tree, dict):
        for k in _keys(tree, sort):
            _walk(tree[k], sort, out)
    elif isinstance(tree, list):
        for v in tree:
            _walk(v, sort, out)
    else:
        out.append(tree)
    return out


def tree_leaves(tree: Any) -> List:
    """Leaves with dicts in insertion order and lists in order."""
    return _walk(tree, False, [])


def tree_leaves_sorted(tree: Any) -> List:
    """Leaves in jax.tree_util.tree_flatten order (dict keys sorted)."""
    return _walk(tree, True, [])


def tree_pairs(tree: Any, other: Any):
    """(leaf of `tree`, leaf of `other`) pairs in tree_leaves order of
    `tree`, `other`'s leaves looked up by `tree`'s keys (its dicts may be
    in another order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_pairs(v, other[k])
    elif isinstance(tree, list):
        for v, o in zip(tree, other):
            yield from tree_pairs(v, o)
    else:
        yield tree, other


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` (and of trees of the same structure in
    `rest`, looked up by the same keys); returns a tree of the same shape
    with `tree`'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List, sort: bool = False) -> Any:
    """A tree shaped like `like` holding `leaves`, which are in
    tree_leaves order (tree_leaves_sorted order when `sort`)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in _keys(node, sort)}
            return {k: got[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(like)
