"""Replica-group fault detection on per-worker symbols.

Port of ``repro.core.detection.detect_groups_batched``: each worker's
symbols are compared against its group's FIRST member (ascending worker
id) with an ABSOLUTE tolerance.  Sketches are linear and honest replicas
are bitwise copies, so a group's symbols are equal exactly when its
gradients are.  ``hash_sign_sketch`` and ``key_scalar_for_seed`` are the
sketch and key of the serving audit (``repro_torch.serving``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

DEFAULT_K = 256


def hash_sign_sketch(flat_g: torch.Tensor, key_scalar, k: int = DEFAULT_K, *,
                     impl: str | None = None) -> torch.Tensor:
    """CountSketch of a flat vector: (d,) -> (k,) float32 (``ops.sketch``:
    K4s on a CUDA tensor)."""
    return ops.sketch(flat_g.reshape(-1), key_scalar, k, impl=impl)


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
