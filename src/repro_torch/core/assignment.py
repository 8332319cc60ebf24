"""Shard -> worker replica-group assignment (paper §4.1).

Port of ``repro.core.assignment``.  Fast mode gives every active
worker its own shard (r = 1); check mode groups r = f_t + 1 workers per
shard (detection); identify mode r = 2 f_t + 1 (majority vote).  The
layouts are built on the host with numpy, the replica groups permuted by
the protocol's seeded generator.  Eliminated or crashed workers keep
their slot with weight 0 and no group.
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

    @property
    def n(self) -> int:
        return len(self.shard_of_worker)

    def gradients_computed(self) -> int:
        return int((self.group_of_worker >= 0).sum())

    def gradients_used(self) -> int:
        return self.num_shards

    def efficiency(self) -> float:
        return self.gradients_used() / max(1, self.gradients_computed())


def build_assignment(active: np.ndarray, replication: int,
                     rng: np.random.Generator | None = None) -> Assignment:
    """Group the active workers into replica groups of ``replication``.

    Shards = the number of complete groups; leftover active workers
    (n_active % r) idle for the iteration.  ``rng`` permutes the active
    workers first (one ``permutation`` draw): random membership is what
    makes every Byzantine worker check-eligible (§4.2)."""
    n = len(active)
    act_idx = np.flatnonzero(active)
    if rng is not None:
        act_idx = rng.permutation(act_idx)
    r = max(1, replication)
    m = len(act_idx) // r
    if m == 0:
        raise ValueError(
            f"not enough active workers ({len(act_idx)}) for replication {r}"
        )
    shard = np.zeros(n, np.int32)
    group = np.full(n, -1, np.int32)
    weight = np.zeros(n, np.float32)
    for g in range(m):
        members = act_idx[g * r : (g + 1) * r]
        shard[members] = g
        group[members] = g
        # each shard's gradient enters the mean once, split among replicas
        weight[members] = 1.0 / (r * m)
    shard_sizes = np.zeros(n, np.int32)
    return Assignment(shard, group, weight, m, r, shard_sizes)


def fast_assignment(active: np.ndarray, rng=None) -> Assignment:
    return build_assignment(active, 1, rng)


def check_assignment(active: np.ndarray, f_t: int, rng=None) -> Assignment:
    return build_assignment(active, f_t + 1, rng)


def identify_assignment(active: np.ndarray, f_t: int, rng=None) -> Assignment:
    return build_assignment(active, 2 * f_t + 1, rng)


def group_members(a: Assignment) -> list[np.ndarray]:
    """Worker indices per replica group (ascending)."""
    return [
        np.flatnonzero(a.group_of_worker == g) for g in range(a.num_shards)
    ]


def shard_batch_indices(a: Assignment, global_batch: int) -> np.ndarray:
    """(n, rows_per_shard) int32: the batch rows each worker's shard
    covers; the batch is cut into ``num_shards`` contiguous shards of
    global_batch // num_shards rows (the remainder is dropped)."""
    m = a.num_shards
    rows = global_batch // m
    if rows == 0:
        raise ValueError(f"global batch {global_batch} < {m} shards")
    out = np.zeros((a.n, rows), np.int32)
    for w in range(a.n):
        s = a.shard_of_worker[w]
        out[w] = np.arange(s * rows, (s + 1) * rows, dtype=np.int32)
    return out


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
