"""Pairwise replica agreement: the hand-written Hopper kernel and its
plain PyTorch versions.

``(B, R, d) -> (B, R, R)`` with rel[b, i, j] = max_t |x_i - x_j| /
(1 + min(|x_i|, |x_j|)); a vote counts replicas i and j as agreeing iff
rel <= tau.  The single form ``(R, d) -> (R, R)`` is the same kernel at
B = 1.  The CUDA kernel lives in ``csrc/majority_vote.cu``, whose header
note says which TPU kernels it replaces
(src/repro/kernels/majority_vote.py:63 and :30), what bounds it on the
H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# wrapper calls that launched the CUDA kernel, per form
LAUNCHES = {"pairwise_relmax_batched": 0, "pairwise_relmax": 0}


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
        lib.max_r = lib.relmax_max_replicas()   # asked once, at load
        lib._typed = True
    return lib


@_build.on_operand_device
def _relmax_cuda(x: torch.Tensor, form: str) -> torch.Tensor:
    """x (B, R, d) f32 on the card -> (B, R, R).  The host work per call
    is kept to the checks that raise: the vote's launch costs less."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3
            and x.is_contiguous()):
        _build.require_cuda_tensor(x, "replicas", 3, (torch.float32,))
    B, R, d = x.shape
    lib = _lib()
    if R > lib.max_r:
        raise ValueError(f"relmax kernel takes at most {lib.max_r} "
                         f"replicas, got {R}")
    if B > 65535:
        raise ValueError(f"relmax kernel takes B <= 65535, got {B}")
    if B == 0 or R == 0 or d == 0:
        return x.new_zeros((B, R, R))
    out = x.new_empty((B, R, R))
    status = lib.relmax_batched(x.data_ptr(), B, R, d, out.data_ptr(),
                                _build.raw_stream(x.get_device()))
    if status:
        _build.check_status(lib.relmax_error_string, status, form)
    LAUNCHES[form] += 1
    return out


def pairwise_relmax_batched_cuda(replicas: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel (``csrc/majority_vote.cu``) on a CUDA
    tensor; runs on PyTorch's current stream, no synchronization."""
    return _relmax_cuda(replicas.contiguous() if replicas.is_cuda
                        else replicas, "pairwise_relmax_batched")


def pairwise_relmax_plain(replicas: torch.Tensor) -> torch.Tensor:
    """The plain single form: (R, d) -> (R, R)."""
    return pairwise_relmax_batched_plain(replicas[None])[0]


def pairwise_relmax_cuda(replicas: torch.Tensor) -> torch.Tensor:
    """The single form (R, d) -> (R, R): the batched kernel at B = 1."""
    if replicas.dim() != 2:
        raise TypeError(f"replicas must be 2-D (R, d), got "
                        f"{tuple(replicas.shape)}")
    x = replicas.contiguous() if replicas.is_cuda else replicas
    return _relmax_cuda(x[None], "pairwise_relmax")[0]
