"""Trees of tensors: the port's counterpart of ``jax.tree`` for nested dicts and lists.

Parameter, optimizer, train-state and checkpoint trees are plain dicts and
lists with tensors (or arrays) at the leaves.  :func:`tree_leaves` gives the
leaves in the JAX package's order — dict keys sorted, lists in order — so a
sum over the leaves adds them as ``jax.tree.leaves`` does, and
:func:`tree_unflatten` puts a list in that order back into a tree's shape.
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` at every leaf of ``tree``, structure kept.

    ``rest`` are trees of ``tree``'s structure (a dict of ``rest`` may hold
    more keys; only ``tree``'s are visited).
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves, dict keys sorted and lists in order (``jax.tree.leaves``'s order)."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves`' order; a path joins the
    dict keys and list indices from the root with ``/`` (``params/layers/3/q/w``)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for name, v in items
            for pair in tree_paths(v, f"{prefix}/{name}" if prefix else name)]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure whose leaves, in :func:`tree_leaves`' order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # the caller's key order
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
