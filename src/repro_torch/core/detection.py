"""Replica-group fault detection on per-worker symbols.

Port of ``repro.core.detection.detect_groups_batched``: each worker's
symbols are compared against its group's FIRST member (ascending worker
id) with an ABSOLUTE tolerance.  Sketches are linear and honest replicas
are bitwise copies, so a group's symbols are equal exactly when its
gradients are.
"""
from __future__ import annotations

import torch


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
