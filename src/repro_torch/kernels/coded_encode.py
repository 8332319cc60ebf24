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
        lib.max_m = lib.encode_max_m()     # asked once, at load
        lib._typed = True
    return lib


def _ok(x: torch.Tensor, ndim: int) -> bool:
    return x.is_cuda and x.dtype == torch.float32 and x.dim() == ndim \
        and x.is_contiguous()


@_build.on_operand_device
def _encode_cuda(c: torch.Tensor, g: torch.Tensor, ndim: int,
                 form: str) -> torch.Tensor:
    """c (B, n_sym, m), g (B, m, d); or, ndim = 2, the single form's
    (n_sym, m) and (m, d) read as B = 1.  The host work per call is kept
    to the checks that raise: the single form's launch costs less."""
    if not (_ok(c, ndim) and _ok(g, ndim)):
        _build.require_cuda_tensor(c, "coeffs", ndim, (torch.float32,))
        _build.require_cuda_tensor(g, "grads", ndim, (torch.float32,))
    cs, gs = c.shape, g.shape
    if cs[:-2] != gs[:-2] or cs[-1] != gs[-2] \
            or c.get_device() != g.get_device():
        raise ValueError(f"coeffs {tuple(cs)} and grads {tuple(gs)} do "
                         f"not match")
    B, n_sym, m, d = (cs[0] if ndim == 3 else 1), cs[-2], cs[-1], gs[-1]
    lib = _lib()
    if m > lib.max_m:
        raise ValueError(f"encode kernel takes m <= {lib.max_m}, got {m}")
    if B > 65535:
        raise ValueError(f"encode kernel takes B <= 65535, got {B}")
    out = c.new_empty((*cs[:-1], d))
    if B == 0 or n_sym == 0 or d == 0:
        return out
    status = lib.coded_encode_batched(
        c.data_ptr(), g.data_ptr(), B, n_sym, m, d, out.data_ptr(),
        _build.raw_stream(c.get_device()))
    if status:
        _build.check_status(lib.encode_error_string, status, form)
    LAUNCHES[form] += 1
    return out


def coded_encode_batched_cuda(coeffs: torch.Tensor,
                              grads: torch.Tensor) -> torch.Tensor:
    """The hand-written kernel on CUDA tensors; runs on PyTorch's
    current stream, no synchronization."""
    return _encode_cuda(coeffs.contiguous(), grads.contiguous(), 3,
                        "coded_encode_batched")


def coded_encode_cuda(coeffs: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """The single form (n_sym, m) @ (m, d): the batched kernel at B = 1."""
    return _encode_cuda(coeffs.contiguous(), grads.contiguous(), 2,
                        "coded_encode")
