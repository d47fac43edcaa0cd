"""Nested dict / list / tuple trees of tensors — the port's pytrees.

Leaves are flattened in ``jax.tree_util`` order: dict keys sorted,
list and tuple entries in position, ``None`` an empty node.  A bridged
reference tree therefore flattens to the same leaf sequence in both
packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    """-> (leaves, treedef).  ``treedef`` is a hashable nested tuple."""
    leaves: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(rec(c) for c in node))
        if node is None:
            return ("none",)
        leaves.append(node)
        return ("leaf",)

    return leaves, rec(tree)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: tuple, leaves):
    it = iter(leaves)

    def rec(td):
        kind = td[0]
        if kind == "dict":
            return {k: rec(c) for k, c in zip(td[1], td[2])}
        if kind == "list":
            return [rec(c) for c in td[1]]
        if kind == "tuple":
            return tuple(rec(c) for c in td[1])
        if kind == "none":
            return None
        return next(it)

    return rec(treedef)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves; structure of ``tree``."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError("tree_map: tree structures differ")
    return tree_unflatten(
        treedef, [fn(*ls) for ls in zip(leaves, *[o[0] for o in others])])


def tree_stack(trees):
    """List of same-structure trees -> one tree with a leading axis."""
    import torch
    return tree_map(lambda *xs: torch.stack(xs), *trees)
