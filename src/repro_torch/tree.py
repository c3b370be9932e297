"""Minimal pytree helpers over nested dicts of tensors.

Stands in for ``jax.tree_util`` on the parameter trees the port carries:
dict nodes flatten in sorted-key order, exactly as JAX flattens dicts, so
the packed layout (and with it the masks and the digests) matches the
reference leaf for leaf. Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = None   # treedef marker of a leaf
_END = object()


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef is a nested dict skeleton."""
    out: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        out.append(node)
        return _LEAF

    return out, walk(tree)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(treedef, flat) -> Any:
    it = iter(flat)

    def build(d):
        if isinstance(d, dict):
            return {k: build(d[k]) for k in sorted(d)}
        return next(it)

    tree = build(treedef)
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
