"""Byzantine identification by majority vote over 2f+1 replicas (paper
§4.1, the reactive phase).

Port of ``repro.core.identification``.  With r = 2f+1 replicas of a
shard's gradient and at most f Byzantine workers, the honest replicas
form a strict majority of pairwise-equal values: the vote recovers the
exact gradient and exposes every replica that deviates.

``majority_vote_np`` is the host simulators' numpy form (f32, as the
reference's); ``pairwise_agreement``, ``majority_vote`` and
``vote_tree`` take torch tensors on any device.  The batched on-device
vote of the engine's data plane is ``kernels.ops.batched_vote`` (K3).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree as tree_mod

DEFAULT_TAU = 1e-5


def majority_vote_np(replicas: np.ndarray, tau: float = DEFAULT_TAU):
    """Host-side numpy majority vote over (r, d) replicas, in float32.

    Returns (value (d,) float32, faulty (r,) bool, ok bool): the first
    replica agreed on by a strict majority, the replicas that do not
    match it, and whether a strict majority exists."""
    reps = np.asarray(replicas, np.float32)
    a, b = reps[:, None], reps[None, :]
    scale = 1.0 + np.minimum(np.abs(a), np.abs(b))
    agree = (np.abs(a - b) <= tau * scale).all(axis=-1)        # (r, r)
    r = reps.shape[0]
    counts = agree.sum(axis=1)
    is_major = counts > (r // 2)
    has_majority = bool(is_major.any())
    winner = int(np.argmax(is_major))
    faulty = ~agree[winner] & has_majority
    return reps[winner], faulty, has_majority


def pairwise_agreement(replicas: torch.Tensor,
                       tau: float = DEFAULT_TAU) -> torch.Tensor:
    """replicas (r, d) -> (r, r) bool agreement matrix (relative tol)."""
    a = replicas[:, None]                      # (r, 1, d)
    b = replicas[None, :]                      # (1, r, d)
    scale = 1.0 + torch.minimum(a.abs(), b.abs())
    return ((a - b).abs() <= tau * scale).all(dim=-1)


def majority_vote(replicas: torch.Tensor, tau: float = DEFAULT_TAU):
    """Majority vote over replicas (r, d).

    Returns (value (d,), faulty (r,) bool, has_majority () bool): the
    replica agreed on by a strict majority (> r/2; the first such), the
    replicas not matching it, and whether a strict majority exists."""
    r = replicas.shape[0]
    agree = pairwise_agreement(replicas, tau)
    counts = agree.sum(dim=1)                                   # (r,)
    is_major = counts > (r // 2)
    has_majority = is_major.any()
    # first replica in the majority (argmax returns the first maximum)
    winner = torch.argmax(is_major.to(torch.int32))
    value = replicas[winner]
    faulty = ~agree[winner] & has_majority
    return value, faulty, has_majority


def vote_tree(replica_trees, tau: float = DEFAULT_TAU):
    """Majority vote leaf-wise over a tree of stacked replicas (each
    leaf's leading dim r).

    Each leaf is voted on independently; one per-replica faulty mask is
    the union of the leaves' (a worker is Byzantine if it tampered any
    leaf).  Returns (voted tree, faulty (r,) bool, ok () bool: every
    leaf had a strict majority)."""
    leaves = tree_mod.leaves(replica_trees)
    r = leaves[0].shape[0]
    dev = leaves[0].device
    faulty = torch.zeros(r, dtype=torch.bool, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    voted = []
    for leaf in leaves:
        value, f_leaf, has_maj = majority_vote(leaf.reshape(r, -1), tau)
        voted.append(value.reshape(leaf.shape[1:]))
        faulty |= f_leaf
        ok &= has_maj
    return tree_mod.unflatten(replica_trees, voted), faulty, ok
