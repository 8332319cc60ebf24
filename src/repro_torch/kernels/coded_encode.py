"""Linear encode: the hand-written Hopper kernel and its plain PyTorch
versions.

``coded_encode_batched(c (B, n_sym, m), g (B, m, d)) -> (B, n_sym, d)``,
f32, each output a sum over m in the order 0..m-1
(``ref.batched_coded_encode_ref``); ``coded_encode(c (n_sym, m),
g (m, d))`` is the same kernel at B = 1 (``ref.coded_encode_ref``).
The engine's per-problem plane aggregates with it: one symbol, the
worker-weighted residual row over the trial's own data rows.  The CUDA
kernel lives in ``csrc/coded_encode.cu``, whose header note says which
TPU kernels it replaces (src/repro/kernels/coded_encode.py:51 and :21),
what bounds it on the H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# wrapper calls that launched the CUDA kernel, per form
LAUNCHES = {"coded_encode_batched": 0, "coded_encode": 0}


def coded_encode_batched_plain(coeffs: torch.Tensor,
                               grads: torch.Tensor) -> torch.Tensor:
    return _ref.batched_coded_encode_ref(coeffs, grads)


def coded_encode_plain(coeffs: torch.Tensor,
                       grads: torch.Tensor) -> torch.Tensor:
    return _ref.coded_encode_ref(coeffs, grads)


def _lib():
    lib = _build.load("coded_encode")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.coded_encode_batched.argtypes = [vp, vp, i, i, i, ll, vp, vp]
        lib.coded_encode_batched.restype = i
        lib.encode_max_m.argtypes = []
        lib.encode_max_m.restype = i
        lib.encode_error_string.argtypes = [i]
        lib.encode_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _encode_cuda(c: torch.Tensor, g: torch.Tensor,
                 form: str) -> torch.Tensor:
    _build.require_cuda_tensor(c, "coeffs", 3, (torch.float32,))
    _build.require_cuda_tensor(g, "grads", 3, (torch.float32,))
    B, n_sym, m = c.shape
    if g.shape[:2] != (B, m) or g.device != c.device:
        raise ValueError(f"coeffs {tuple(c.shape)} and grads "
                         f"{tuple(g.shape)} do not match")
    d = g.shape[2]
    lib = _lib()
    if m > lib.encode_max_m():
        raise ValueError(f"encode kernel takes m <= {lib.encode_max_m()}, "
                         f"got {m}")
    if B > 65535:
        raise ValueError(f"encode kernel takes B <= 65535, got {B}")
    if B == 0 or n_sym == 0 or d == 0:
        return torch.zeros((B, n_sym, d), dtype=torch.float32,
                           device=c.device)
    out = torch.empty((B, n_sym, d), dtype=torch.float32, device=c.device)
    _build.check_status(lib.encode_error_string, lib.coded_encode_batched(
        c.data_ptr(), g.data_ptr(), B, n_sym, m, d, out.data_ptr(),
        torch.cuda.current_stream(c.device).cuda_stream),
        "coded_encode_batched")
    LAUNCHES[form] += 1
    return out


def _contig(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous() if x.is_cuda else x


def coded_encode_batched_cuda(coeffs: torch.Tensor,
                              grads: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel on CUDA tensors; runs on PyTorch's
    current stream, no synchronization."""
    return _encode_cuda(_contig(coeffs), _contig(grads),
                        "coded_encode_batched")


def coded_encode_cuda(coeffs: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """The single form (n_sym, m) @ (m, d): the batched kernel at B = 1."""
    if coeffs.dim() != 2 or grads.dim() != 2:
        raise TypeError(f"coeffs and grads must be 2-D, got "
                        f"{tuple(coeffs.shape)} and {tuple(grads.shape)}")
    return _encode_cuda(_contig(coeffs)[None], _contig(grads)[None],
                        "coded_encode")[0]
