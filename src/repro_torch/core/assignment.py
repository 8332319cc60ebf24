"""Shard -> worker replica-group assignment (paper §4.1).

Port of the parts of ``repro.core.assignment`` that the host control
replay runs: the assignment record and the vectorized fast layout.
Fast mode gives every active worker its own shard (r = 1); check and
identify layouts (r = f_t + 1, r = 2 f_t + 1) are drawn by the
engine's ``_grouped_rows``.  Eliminated or crashed workers keep their
slot with weight 0 and no group.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Arrays are all length-n (the data-axis size)."""

    shard_of_worker: np.ndarray   # (n,) int32: shard computed by worker w
    group_of_worker: np.ndarray   # (n,) int32: replica group id (-1 = idle)
    weight: np.ndarray            # (n,) float32: aggregation weight
    num_shards: int               # m: shards used for the update
    replication: int              # r: replicas per shard
    shard_sizes: np.ndarray       # (n,) int32: microbatch rows per shard


@dataclasses.dataclass(frozen=True)
class BatchedAssignment:
    """Assignments for B independent trials, one row per trial."""

    shard_of_worker: np.ndarray   # (B, n) int32
    group_of_worker: np.ndarray   # (B, n) int32, -1 = idle
    weight: np.ndarray            # (B, n) float32
    num_shards: np.ndarray        # (B,) int64


def fast_assignment_batched(active: np.ndarray) -> BatchedAssignment:
    """Vectorized ``fast_assignment`` over a (B, n) bool active matrix:
    the g-th active worker (ascending index) owns shard g with weight
    1/m; idle workers keep shard 0, group -1, weight 0."""
    active = np.asarray(active, bool)
    rank = np.cumsum(active, axis=1) - 1
    m = active.sum(axis=1)
    if (m == 0).any():
        raise ValueError("trial with zero active workers")
    shard = np.where(active, rank, 0).astype(np.int32)
    group = np.where(active, rank, -1).astype(np.int32)
    weight = np.where(active, 1.0 / np.maximum(m, 1)[:, None], 0.0).astype(
        np.float32
    )
    return BatchedAssignment(shard, group, weight, m)
