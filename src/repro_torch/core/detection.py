"""Replica-group fault detection on per-worker symbols.

Port of ``repro.core.detection``.

 * ``detect_groups_batched`` (the scenario engines): each worker's
   symbols against its group's FIRST member (ascending worker id) with
   an ABSOLUTE tolerance.  Sketches are linear and honest replicas are
   bitwise copies, so a group's symbols are equal exactly when its
   gradients are.
 * ``sketch_tree``, ``detect_groups``, ``detect_full`` (the trainer's
   check step): each worker's gradient tree is sketched into one (k,)
   symbol, one K4s launch per leaf, and each member is held against its
   group's mean within a RELATIVE tolerance tau.
 * ``hash_sign_sketch`` and ``key_scalar_for_seed`` are also the sketch
   and key of the serving audit (``repro_torch.serving``).

With a worker split over the model axis (``train.ranks.ModelAxis``),
``sketch_tree`` sketches each split leaf's shard under the full leaf's
flat index (K4s's shard form, ``ops.sketch_shard``), the replicated
leaves on the axis's rank 0 only, and sums the partial symbols over the
axis: the reference's symbol of the whole tree (its ``iota`` over each
full flat leaf), up to the order of the sums.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prngkey
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops

DEFAULT_K = 256
DEFAULT_TAU = 1e-5
# the golden-ratio step between the leaves' sketch keys
LEAF_KEY_STEP = 0x9E3779B9


def hash_sign_sketch(flat_g: torch.Tensor, key_scalar, k: int = DEFAULT_K, *,
                     impl: str | None = None) -> torch.Tensor:
    """CountSketch of a flat vector: (d,) -> (k,) float32 (``ops.sketch``:
    K4s on a CUDA tensor)."""
    return ops.sketch(flat_g.reshape(-1), key_scalar, k, impl=impl)


def shard_block(leaf: torch.Tensor, pl) -> tuple:
    """A split leaf's shard as K4s's shard form reads it: (block (rows,
    cols), cfull, c0), the block of the full leaf's (rows, cfull) view
    from column c0 (``sharding.Placement`` ``pl``)."""
    j = pl.split_dim
    local = pl.local_shape
    inner = math.prod(local[j + 1:])
    rows = math.prod(local[:j])
    cols = local[j] * inner
    return (leaf.reshape(rows, cols), pl.shape[j] * inner,
            pl.index[j] * cols)


def sketch_tree(grad_tree, key_scalar, k: int = DEFAULT_K, *,
                impl: str | None = None, axis=None) -> torch.Tensor:
    """One (k,) float32 symbol for a whole gradient tree: leaf i (in
    ``core.tree`` order, the reference's ``jax.tree.leaves``) sketched
    over its flat layout under the key ``key_scalar + 0x9E3779B9 (i+1)``
    mod 2^32, so equal values in different leaves do not cancel, and the
    leaf sketches summed in order.  Linear: equal gradients give equal
    symbols.  ``axis``: the worker's model axis (its ``placements``, one
    per leaf): the shards' partial symbols summed over it."""
    total = None
    for i, leaf in enumerate(leaves(grad_tree)):
        key = (int(key_scalar) + LEAF_KEY_STEP * (i + 1)) & 0xFFFFFFFF
        pl = None if axis is None else axis.placements[i]
        if pl is not None and pl.sharded:
            block, cfull, c0 = shard_block(leaf, pl)
            s = ops.sketch_shard(block, key, k, cfull, c0, impl=impl)
        elif axis is not None and axis.rank != 0:
            continue                   # a replicated leaf: rank 0 adds it
        else:
            s = hash_sign_sketch(leaf.reshape(-1), key, k, impl=impl)
        total = s if total is None else total + s
    if axis is not None:
        if total is None:
            total = torch.zeros(k, dtype=torch.float32,
                                device=leaves(grad_tree)[0].device)
        axis.all_reduce_sum(total)
    return total


key_scalar_for_step = prngkey.key_scalar_for_step


def detect_groups(symbols: torch.Tensor, group_of_worker: torch.Tensor,
                  num_groups: int, tau: float = DEFAULT_TAU):
    """Per-group fault flags from per-worker symbols.

    symbols (n, k) float32; group_of_worker (n,) int, -1 idle.  Returns
    (group_fault (num_groups,) bool, worker_mismatch (n,) bool): a
    member mismatches when a symbol leaves its group's mean by more than
    tau * (1 + |mean|); a group is faulty when a member mismatches.
    With r = f+1 replicas a mismatch does not prove which member lied;
    that takes the reactive 2f+1 round, as the paper argues."""
    valid = group_of_worker >= 0
    gid = torch.where(valid, group_of_worker, 0).to(torch.int64)
    onehot = torch.nn.functional.one_hot(gid, num_groups).to(symbols.dtype) \
        * valid[:, None].to(symbols.dtype)
    count = onehot.sum(dim=0)
    gsum = torch.einsum("nk,ng->gk", symbols, onehot)
    gmean = gsum / torch.clamp(count, min=1.0)[:, None]
    ref = gmean[gid]
    mismatch = ((symbols - ref).abs() > tau * (1.0 + ref.abs())).any(dim=-1) \
        & valid
    group_fault = torch.zeros(num_groups, dtype=torch.int64,
                              device=symbols.device).index_add_(
        0, gid, mismatch.to(torch.int64)) > 0
    return group_fault, mismatch


def detect_full(replica_grads: torch.Tensor, tau: float = DEFAULT_TAU):
    """Paper-faithful replica comparison on full gradients: (r, d) ->
    () bool, True when the replicas are not unanimous within tau of the
    first one's magnitude."""
    ref = replica_grads[0]
    return ((replica_grads - ref[None]).abs()
            > tau * (1.0 + ref.abs())[None]).any()


def key_scalar_for_seed(n: int) -> int:
    """The uint32 hash key the reference derives from
    ``jax.random.PRNGKey(n)`` (``key_scalar_for_step``: key data
    word 0 XOR word 1).  Threefry keys from a seed hold (hi, lo) =
    (0, n mod 2^32) with 64-bit values off, as the reference runs (with
    them on, hi would be n >> 32; the two agree for 0 <= n < 2^32)."""
    return int(n) & 0xFFFFFFFF


def detect_groups_batched(symbols: torch.Tensor, group_of_worker: torch.Tensor,
                          tau: float = 1e-9):
    """symbols (B, n, k); group_of_worker (B, n) int, -1 idle.
    Returns (trial_fault (B,) bool, worker_mismatch (B, n) bool)."""
    B, n, _ = symbols.shape
    valid = group_of_worker >= 0
    same = (group_of_worker[:, :, None] == group_of_worker[:, None, :]) \
        & valid[:, None, :] & valid[:, :, None]
    idx = torch.arange(n, device=symbols.device)
    first = torch.where(same, idx[None, None, :], n).amin(dim=2)
    rows = torch.arange(B, device=symbols.device)[:, None]
    ref = symbols[rows, first.clamp(max=n - 1)]
    dev = (symbols - ref).abs().amax(dim=2)
    mismatch = valid & (first < n) & (dev > tau)
    return mismatch.any(dim=1), mismatch
