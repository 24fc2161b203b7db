"""Leaves of the port's parameter trees: nested dicts and lists of tensors.

The reference walks its pytrees with ``jax.tree``; the port's trees are
plain containers, and these helpers fix one order for them: a dict's
entries in sorted key order (as ``jax.tree`` orders dict keys), a list's
or tuple's in index order, depth first.  The optimizer, the train step
and the checkpoint store all flatten in this order.
"""
from __future__ import annotations


def tree_leaves(tree, tuple_leaves: bool = False) -> list:
    """Every leaf of ``tree``, in the order above; with ``tuple_leaves``
    a tuple is one leaf (a tree of ZeRO-1 cuts or of process groups)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], tuple_leaves)]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not tuple_leaves):
        return [x for node in tree for x in tree_leaves(node, tuple_leaves)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` on the leaves of ``tree`` (and of the like-shaped ``rest``),
    in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, node, *(r[i] for r in rest))
                          for i, node in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves``, given in the order
    of ``tree_leaves(like)``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)
