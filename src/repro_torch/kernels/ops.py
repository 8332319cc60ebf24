"""Dispatch over the port's kernels: the hand-written CUDA kernel or its
plain PyTorch version.

``impl`` is ``"cuda"`` (the hand-written kernel), ``"torch"`` (the plain
version) or ``None``.  ``None`` follows the tensor: a CUDA tensor goes
to the CUDA kernel, a CPU tensor to the plain version.  ``"torch"`` on a
CUDA tensor is an explicit choice (the chip check compares the two with
it) and is never made automatically; ``"cuda"`` on a CPU tensor raises.
A CUDA kernel that fails to build or launch raises — nothing falls back.

Each kernel wrapper counts the calls in which it launched its kernel
(``launch_counts``), so a run can show that it went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gram as _gm
from repro_torch.kernels import majority_vote as _mv

IMPLS = ("cuda", "torch")


def resolve_impl(impl: str | None, device) -> str:
    """Resolve a kernel impl choice against the device the data lies on."""
    device = torch.device(device)
    if impl is None:
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; allowed values: "
                         f"{list(IMPLS)} (or None to follow the device)")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f'kernel impl "cuda" needs CUDA tensors, got '
                         f"device {device}")
    return impl


def launch_counts() -> dict[str, int]:
    """{kernel: wrapper calls that launched it} since the last reset."""
    return {"gram_factors": _gm.LAUNCHES,
            "pairwise_relmax_batched": _mv.LAUNCHES}


def reset_launch_counts() -> None:
    _gm.LAUNCHES = 0
    _mv.LAUNCHES = 0


def gram_factors(rows: torch.Tensor, W0: torch.Tensor | None, keys, *,
                 k: int = 256, impl: str | None = None,
                 with_gram: bool = True):
    """(rows (Ie, d) f32, W0 (B, d) f32 or None, keys (T,) uint32) ->
    (G (Ie, Ie) or None, S0 (B, Ie) or None, SK (T, Ie, k)); see
    :mod:`repro_torch.kernels.gram`."""
    if resolve_impl(impl, rows.device) == "cuda":
        return _gm.gram_factors_cuda(rows, W0, keys, k, with_gram)
    return _gm.gram_factors_plain(rows, W0, keys, k, with_gram)


def batched_pairwise_relmax(replicas: torch.Tensor, *,
                            impl: str | None = None) -> torch.Tensor:
    """(B, R, d) -> (B, R, R) relative max-difference matrices."""
    if resolve_impl(impl, replicas.device) == "cuda":
        return _mv.pairwise_relmax_batched_cuda(replicas.to(torch.float32))
    return _mv.pairwise_relmax_batched_plain(replicas)


def batched_vote(replicas: torch.Tensor, group_of_worker: torch.Tensor,
                 tau: float = 1e-5, *, impl: str | None = None):
    """Majority votes for all replica groups of all trials at once.

    replicas (B, n, d); group_of_worker (B, n) int (-1 = idle).  Per
    group, the winner is the lowest-indexed worker that agrees with a
    strict in-group majority.  Returns (winner_coeff (B, n) f32, one-hot
    per group, faulty (B, n) bool) — the reference's epilogue
    (``repro/kernels/ops.py:175-208``) in torch.
    """
    rel = batched_pairwise_relmax(replicas, impl=impl)
    valid = group_of_worker >= 0
    same = (group_of_worker[:, :, None] == group_of_worker[:, None, :]) \
        & valid[:, None, :] & valid[:, :, None]
    agree = (rel <= tau) & same
    counts = agree.sum(dim=2)
    gsize = same.sum(dim=2)
    is_major = valid & (counts > gsize // 2)
    n = replicas.shape[1]
    idx = torch.arange(n, device=replicas.device)
    cand = torch.where(is_major, idx[None, :], n)
    first = torch.where(same, cand[:, None, :], n).amin(dim=2)
    winner_coeff = (valid & (idx[None, :] == first)).to(torch.float32)
    is_winner_row = torch.gather(
        agree, 2, first.clamp(max=n - 1)[:, :, None])[:, :, 0]
    faulty = valid & ~is_winner_row & (first < n)
    return winner_coeff, faulty
