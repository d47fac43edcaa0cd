"""Nested dict / list / tuple trees of tensors — the port's pytrees.

Leaves are flattened in ``jax.tree_util`` order: dict keys sorted,
list and tuple entries in position, ``None`` an empty node.  A bridged
reference tree therefore flattens to the same leaf sequence in both
packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


# The recursions are module-level functions, not closures: a nested
# function that calls itself sits in a reference cycle (function ->
# cell -> function) with everything it closes over, so each call would
# keep its leaves alive until the cyclic garbage collector ran -- at a
# full-width model's size, gigabytes of gradients and optimizer
# temporaries held past their last use.

def _flatten(node, leaves: List[Any]):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_flatten(c, leaves)
                                           for c in node))
    if node is None:
        return ("none",)
    leaves.append(node)
    return ("leaf",)


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    """-> (leaves, treedef).  ``treedef`` is a hashable nested tuple."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def _unflatten(td: tuple, it):
    kind = td[0]
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(td[1], td[2])}
    if kind == "list":
        return [_unflatten(c, it) for c in td[1]]
    if kind == "tuple":
        return tuple(_unflatten(c, it) for c in td[1])
    if kind == "none":
        return None
    return next(it)


def tree_unflatten(treedef: tuple, leaves):
    return _unflatten(treedef, iter(leaves))


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


def _with_path(fn, node, path):
    if isinstance(node, dict):
        return {k: _with_path(fn, node[k], path + (str(k),))
                for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_with_path(fn, c, path + (str(i),))
                          for i, c in enumerate(node))
    if node is None:
        return None
    return fn(path, node)


def tree_map_with_path(fn: Callable, tree):
    """``fn(path, leaf)`` over the leaves, ``path`` the tuple of dict
    keys and sequence indices (as strings) from the root to the leaf,
    as ``jax.tree_util.tree_map_with_path`` gives them; structure of
    ``tree``."""
    return _with_path(fn, tree, ())
