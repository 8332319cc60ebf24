"""Nested dict / list trees of tensors, flattened in ``jax.tree_util``'s
order: dict keys sorted, lists in order.

The trainer keeps the reference's parameter and optimizer-state trees,
so leaf i here is leaf i of ``jax.tree.leaves`` there: the sketch key
offsets, the noise keys and the checkpoint paths line up one to one.
A path is the reference checkpoint's key, its parts joined by "/"
(``decoder/0/0/ffn/down``).  An empty dict has no leaves.
"""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in flattening order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(leaves_with_paths(sub, f"{prefix}/{key}" if prefix
                                     else str(key)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves) -> object:
    """A tree shaped like ``template`` holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees shaped alike."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
