"""Batched pairwise replica agreement: the hand-written Hopper kernel and
its plain PyTorch version.

``(B, R, d) -> (B, R, R)`` with rel[b, i, j] = max_t |x_i - x_j| /
(1 + min(|x_i|, |x_j|)); a vote counts replicas i and j as agreeing iff
rel <= tau.  The CUDA kernel lives in ``csrc/majority_vote.cu``, whose
header note says which TPU kernel it replaces
(src/repro/kernels/majority_vote.py:63), what bounds it on the H100 and
what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = 0     # wrapper calls that launched the CUDA kernel


def pairwise_relmax_batched_plain(replicas: torch.Tensor) -> torch.Tensor:
    """The plain version: ``ref.batched_pairwise_maxdiff_ref`` over d in
    chunks, so the (B, R, R, chunk) broadcast stays near 64 MiB."""
    x = replicas.to(torch.float32)
    B, R, d = x.shape
    chunk = max(128, (1 << 24) // max(1, B * R * R))
    if d <= chunk:
        return _ref.batched_pairwise_maxdiff_ref(x)
    acc = torch.zeros((B, R, R), dtype=torch.float32, device=x.device)
    for lo in range(0, d, chunk):
        acc = torch.maximum(
            acc, _ref.batched_pairwise_maxdiff_ref(x[:, :, lo:lo + chunk]))
    return acc


def _lib():
    lib = _build.load("majority_vote")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.relmax_batched.argtypes = [vp, i, i, ll, vp, vp]
        lib.relmax_batched.restype = i
        lib.relmax_error_string.argtypes = [i]
        lib.relmax_error_string.restype = ctypes.c_char_p
        lib.relmax_max_replicas.argtypes = []
        lib.relmax_max_replicas.restype = i
        lib._typed = True
    return lib


def pairwise_relmax_batched_cuda(replicas: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel (``csrc/majority_vote.cu``) on a CUDA
    tensor; runs on PyTorch's current stream, no synchronization."""
    global LAUNCHES
    if not replicas.is_cuda:
        raise ValueError("replicas must be a CUDA tensor for the CUDA kernel")
    if replicas.dtype != torch.float32 or replicas.dim() != 3:
        raise TypeError(f"replicas must be a 3-D float32 tensor, got "
                        f"{replicas.dtype} {tuple(replicas.shape)}")
    x = replicas.contiguous()
    B, R, d = x.shape
    lib = _lib()
    if R > lib.relmax_max_replicas():
        raise ValueError(f"relmax kernel takes at most "
                         f"{lib.relmax_max_replicas()} replicas, got {R}")
    out = torch.zeros((B, R, R), dtype=torch.float32, device=x.device)
    if B == 0 or R == 0 or d == 0:
        return out
    status = lib.relmax_batched(
        x.data_ptr(), B, R, d, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        msg = lib.relmax_error_string(status).decode()
        raise RuntimeError(f"relmax_batched: CUDA error {status} ({msg})")
    LAUNCHES += 1
    return out
