"""Parameter trees in the reference's pytree order.

The reference's parameters and optimizer states are nested dicts (and,
for a train state, a ``(params, opt_state)`` tuple) that ``jax.tree``
walks depth first, dict keys in sorted order and sequences in index
order. These helpers walk a tree of tensors the same way, so a leaf's
position (its slice of a gradient bucket, its key in a checkpoint) is
the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def paths(tree: Tree, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in the reference's order; a path is the
    tuple of dict keys and sequence indices leading to the leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def unflatten(template: Tree, new_leaves) -> Tree:
    """``template``'s structure with ``new_leaves`` (in :func:`leaves`
    order) in place of its leaves."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}        # keep the caller's order
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others, strict=True)])
