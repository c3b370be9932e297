"""Minimal pytree helpers over nested dicts of tensors.

Stands in for ``jax.tree_util`` on the parameter trees the port carries:
dict nodes flatten in sorted-key order, exactly as JAX flattens dicts, so
the packed layout (and with it the masks and the digests) matches the
reference leaf for leaf. Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

_LEAF = None   # treedef marker of a leaf
_END = object()


def _walk(node, out: list):
    if isinstance(node, dict):
        return {k: _walk(node[k], out) for k in sorted(node)}
    out.append(node)
    return _LEAF


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef is a nested dict skeleton.

    The walkers are module functions, not closures: a recursive closure
    is a reference cycle, and its cell would keep the leaves (a whole
    model's tensors) alive until the garbage collector runs."""
    out: List[Any] = []
    return out, _walk(tree, out)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def _build(d, it):
    if isinstance(d, dict):
        return {k: _build(d[k], it) for k in sorted(d)}
    return next(it)


def unflatten(treedef, flat) -> Any:
    it = iter(flat)
    tree = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef holds")
    return tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of same-structure trees."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("trees differ in structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def index(tree, i: int):
    """Every leaf indexed by ``i`` along its leading axis (one layer of
    stacked params or caches, as views: writes reach the stack)."""
    return tree_map(lambda a: a[i], tree)


def stack_trees(make: Callable[[], Any], n: int):
    """``n`` trees from ``make()`` (called n times, in order) stacked leaf
    by leaf on a new leading axis: each tree is copied into preallocated
    stacks and dropped, so the peak is the stacks and one tree, not two
    copies of a model."""
    first, treedef = flatten(make())
    stacks = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                          device=a.device) for a in first]
    for i in range(n):
        leaves_i = first if i == 0 else flatten(make())[0]
        for s, a in zip(stacks, leaves_i):
            s[i].copy_(a)
        first = leaves_i = None
    return unflatten(treedef, stacks)
