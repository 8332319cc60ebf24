"""The fused protocol step: the hand-written Hopper kernel and its plain
PyTorch version.

``fused_step(rows (Ie, d) f32|bf16, W (B, d) f32, cw (B, Ie) f32, key)
-> (W', resid, sk)`` with W' = W - cw @ rows, resid = W' @ rows^T
(B, Ie) and sk = CountSketch_k(rows) (Ie, k) under ``key``
(``ref.fused_step_ref``).  All arithmetic is f32; bf16 rows are widened
on load.  The CUDA route writes W' over W (the reference aliases W the
same way), so a caller must not read W after the call; the plain
version returns a new tensor.  The CUDA kernel lives in
``csrc/fused_step.cu``, whose header note says which TPU kernel it
replaces (src/repro/kernels/fused_step.py:50), what bounds it on the
H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_K = 256

LAUNCHES = {"fused_step": 0}   # wrapper calls that launched the kernel


def fused_step_plain(rows: torch.Tensor, W: torch.Tensor, cw: torch.Tensor,
                     key_scalar, k: int = DEFAULT_K):
    return _ref.fused_step_ref(rows, W, cw, key_scalar, k)


def _lib():
    lib = _build.load("fused_step")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_step_num_spans.argtypes = [i, i, ll, i]
        lib.fused_step_num_spans.restype = i
        for fn in (lib.fused_step_f32, lib.fused_step_bf16):
            fn.argtypes = [vp, i, ll, vp, vp, i, i, ctypes.c_uint32, vp, vp,
                           vp, vp, vp]
            fn.restype = i
        lib.fused_step_error_string.argtypes = [i]
        lib.fused_step_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@_build.on_operand_device
def fused_step_cuda(rows: torch.Tensor, W: torch.Tensor, cw: torch.Tensor,
                    key_scalar, k: int = DEFAULT_K):
    """The hand-written kernel on CUDA tensors: W (contiguous f32) is
    overwritten with W' and returned with resid and sk.  Runs on
    PyTorch's current stream, no synchronization."""
    _build.require_cuda_tensor(rows, "rows", 2,
                               (torch.float32, torch.bfloat16))
    _build.require_cuda_tensor(W, "W", 2, (torch.float32,))
    cw = cw.contiguous() if cw.is_cuda else cw
    _build.require_cuda_tensor(cw, "cw", 2, (torch.float32,))
    Ie, d = rows.shape
    B = W.shape[0]
    if W.shape[1] != d or cw.shape != (B, Ie):
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, W "
                         f"{tuple(W.shape)}, cw {tuple(cw.shape)} (want W "
                         f"({B}, {d}), cw ({B}, {Ie}))")
    if len({rows.device, W.device, cw.device}) != 1:
        raise ValueError("rows, W and cw must be on one device")
    if k < 32 or k % 32:
        raise ValueError(f"the fused kernel takes a sketch width k that is "
                         f"a positive multiple of 32, got {k}")
    lib = _lib()
    dev = rows.device
    resid = torch.empty((B, Ie), dtype=torch.float32, device=dev)
    sk = torch.empty((Ie, k), dtype=torch.float32, device=dev)
    if Ie == 0 or d == 0:
        return W, resid.zero_(), sk.zero_()
    nspan = lib.fused_step_num_spans(B, Ie, d, k)
    part_r = torch.empty((nspan, B, Ie), dtype=torch.float32, device=dev)
    part_sk = torch.empty((nspan, Ie, k), dtype=torch.float32, device=dev)
    fn = lib.fused_step_bf16 if rows.dtype == torch.bfloat16 \
        else lib.fused_step_f32
    status = fn(rows.data_ptr(), Ie, d, W.data_ptr(), cw.data_ptr(), B, k,
                int(key_scalar) & 0xFFFFFFFF, part_r.data_ptr(),
                part_sk.data_ptr(), resid.data_ptr(), sk.data_ptr(),
                _build.raw_stream(rows.get_device()))
    if status:
        _build.check_status(lib.fused_step_error_string, status, "fused_step")
    LAUNCHES["fused_step"] += 1
    return W, resid, sk
