"""Byzantine attack models (simulation).

Port of ``repro.core.byzantine``.  A Byzantine worker may send an
arbitrary symbol; the experiments model the standard attack families of
the BFT-SGD literature, each a function of the honest gradient tree,
applied when the worker is Byzantine and its per-iteration tamper coin
fires (the paper's ``p_i``).  Keys are ``core.prngkey`` keys; the coin
and the attack's key come from ``split(key)`` as in the reference, so
a worker tampers exactly when its reference counterpart does.

A worker split over the model axis tampers each rank's shards alike:
the coin is the worker's; the ``noise`` attack draws each split leaf's
full normal and keeps the shard's slice (``placements``), one leaf at a
time, so the shards concatenate to the reference's draw.
"""
from __future__ import annotations

import torch

from repro_torch.core import prngkey, tree

ATTACKS = (
    "none",
    "sign_flip",
    "scale",
    "noise",
    "zero",
    "inf",
    "constant_drift",
)


def apply_attack(grad_tree, attack: str, key, scale: float = 10.0, *,
                 placements=None):
    """The tampered gradient tree for one attack kind (new tensors).
    ``placements``: each leaf's ``sharding.Placement`` when the leaves
    are shards of a worker split over the model axis."""
    if attack == "none":
        return grad_tree
    if attack == "sign_flip":
        return tree.tree_map(lambda g: -scale * g, grad_tree)
    if attack == "scale":
        return tree.tree_map(lambda g: scale * g, grad_tree)
    if attack == "zero":
        return tree.tree_map(torch.zeros_like, grad_tree)
    if attack == "inf":
        return tree.tree_map(lambda g: torch.full_like(g, 1e30), grad_tree)
    if attack == "noise":
        grads = tree.leaves(grad_tree)
        keys = prngkey.split(key, len(grads))
        pls = placements or [None] * len(grads)

        def draw(g, k, pl):
            if pl is None or not pl.sharded:
                return prngkey.normal(k, tuple(g.shape), g.device)
            return pl.take(prngkey.normal(k, pl.shape, g.device))

        return tree.unflatten(grad_tree, [
            g + scale * draw(g, k, pl).to(g.dtype)
            for g, k, pl in zip(grads, keys, pls)])
    if attack == "constant_drift":
        # a stealthy attack: small constant bias pushing w away from w*
        return tree.tree_map(lambda g: g + torch.full_like(g, 0.1), grad_tree)
    raise ValueError(f"unknown attack {attack!r}")


def maybe_tamper(grad_tree, *, is_byz, key, attack: str, p_tamper: float,
                 scale: float = 10.0, placements=None):
    """(tree, did_tamper): tampered iff the worker is Byzantine AND its
    iteration coin ``bernoulli(split(key)[0], p_tamper)`` fires.  The
    coin is drawn on the host, so an honest or lucky worker's gradient
    is returned untouched."""
    kc, ka = prngkey.split(key)
    do = bool(is_byz) and prngkey.bernoulli_scalar(kc, p_tamper)
    if not do:
        return grad_tree, False
    return apply_attack(grad_tree, attack, ka, scale,
                        placements=placements), True
