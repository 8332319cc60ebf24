"""Byzantine identification by majority vote over 2f+1 replicas (paper
§4.1, the reactive phase).

Port of ``repro.core.identification``.  With r = 2f+1 replicas of a
shard's gradient and at most f Byzantine workers, the honest replicas
form a strict majority of pairwise-equal values: the vote recovers the
exact gradient and exposes every replica that deviates.

``majority_vote_np`` is the host simulators' numpy form (f32, as the
reference's); ``pairwise_agreement`` and ``majority_vote`` take torch
tensors on any device.  The batched on-device vote of the engine's data
plane is ``kernels.ops.batched_vote`` (K3).
"""
from __future__ import annotations

import numpy as np
import torch

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
