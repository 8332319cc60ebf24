"""Gram-plane precompute: the hand-written Hopper kernel and its plain
PyTorch version.

``gram_factors(rows, W0, keys)`` -> (G (Ie, Ie), S0 (B, Ie) or None,
SK (T, Ie, k)): G = rows @ rows^T, S0 = W0 @ rows^T, SK[t] = per-row
CountSketch_k(rows) under keys[t] (bucket = column % k, sign from
``ref.hash_signs_ref``).  The CUDA kernels live in ``csrc/gram.cu``,
whose header note says which TPU kernel they replace
(src/repro/kernels/gram.py:45), what bounds them on the H100 and what
their design does about it.

``with_gram=False`` skips G and S0 (the engine forms G itself and
starts from W0 = 0, so it needs only SK).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_K = 256
# columns per span of the G/S0 product kernel (f32 inside a span,
# f64 across spans)
ROWDOT_SPAN = 8192

LAUNCHES = 0     # wrapper calls that launched the CUDA kernels


def _keys_u32(keys) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(keys, dtype=np.uint32))


def gram_factors_plain(rows: torch.Tensor, W0: torch.Tensor | None, keys,
                       k: int = DEFAULT_K, with_gram: bool = True):
    """The plain version: matrix products for G and S0, and all T sketch
    tables as one bucketed einsum over a (T, d) sign table (the
    reference's XLA fallback, ``repro/kernels/ops.py:421-424``)."""
    rows32 = rows.to(torch.float32)
    G = rows32 @ rows32.T if with_gram else None
    S0 = None if (W0 is None or not with_gram) \
        else W0.to(torch.float32) @ rows32.T
    keys = torch.from_numpy(_keys_u32(keys).astype(np.int64)).to(rows.device)
    Ie = rows32.shape[0]
    if keys.shape[0] == 0:
        SK = torch.zeros((0, Ie, k), dtype=torch.float32, device=rows.device)
        return G, S0, SK
    g = _ref._bucketed(rows32, k)
    idx = torch.arange(g.shape[1], device=rows.device)
    signs = _ref.hash_signs_ref(idx[None, :], keys[:, None])      # (T, d_pad)
    SK = torch.einsum("imb,tmb->tib", g.reshape(Ie, -1, k),
                      signs.reshape(keys.shape[0], -1, k))
    return G, S0, SK


def _lib():
    lib = _build.load("gram")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gram_sketch_tables.argtypes = [vp, i, ll, vp, i, i, vp, vp]
        lib.gram_sketch_tables.restype = i
        lib.gram_rowdot.argtypes = [vp, i, vp, i, ll, i, vp, vp, vp]
        lib.gram_rowdot.restype = i
        lib.gram_error_string.argtypes = [i]
        lib.gram_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.gram_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def _require_f32_cuda(x: torch.Tensor, name: str, ndim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if x.dtype != torch.float32 or x.dim() != ndim:
        raise TypeError(f"{name} must be a {ndim}-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _rowdot(lib, X: torch.Tensor, Y: torch.Tensor, stream: int) -> torch.Tensor:
    nx, d = X.shape
    ny = Y.shape[0]
    out = torch.empty((nx, ny), dtype=torch.float32, device=X.device)
    if nx == 0 or ny == 0:
        return out
    nsplit = max(1, -(-d // ROWDOT_SPAN))
    part = torch.empty((nsplit, nx, ny), dtype=torch.float32, device=X.device)
    _check(lib, lib.gram_rowdot(X.data_ptr(), nx, Y.data_ptr(), ny, d,
                                nsplit, part.data_ptr(), out.data_ptr(),
                                stream), "gram_rowdot")
    return out


def gram_factors_cuda(rows: torch.Tensor, W0: torch.Tensor | None, keys,
                      k: int = DEFAULT_K, with_gram: bool = True):
    """The hand-written kernels (``csrc/gram.cu``) on CUDA tensors:
    one launch for all T sketch tables, plus the G/S0 product kernel
    when ``with_gram``.  Outputs are allocated here; the kernels run on
    PyTorch's current stream and nothing synchronizes."""
    global LAUNCHES
    _require_f32_cuda(rows, "rows", 2)
    Ie, d = rows.shape
    if W0 is not None:
        _require_f32_cuda(W0, "W0", 2)
        if W0.shape[1] != d or W0.device != rows.device:
            raise ValueError(f"W0 {tuple(W0.shape)} does not match rows "
                             f"{tuple(rows.shape)}")
    if k < 1:
        raise ValueError(f"sketch width k must be >= 1, got {k}")
    keys_np = _keys_u32(keys)
    T = keys_np.shape[0]
    lib = _lib()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    SK = torch.empty((T, Ie, k), dtype=torch.float32, device=rows.device)
    launched = False
    if T and Ie:
        keys_dev = torch.from_numpy(keys_np.view(np.int32)).to(rows.device)
        _check(lib, lib.gram_sketch_tables(rows.data_ptr(), Ie, d,
                                           keys_dev.data_ptr(), T, k,
                                           SK.data_ptr(), stream),
               "gram_sketch_tables")
        launched = True
    G = S0 = None
    if with_gram:
        G = _rowdot(lib, rows, rows, stream)
        if W0 is not None:
            S0 = _rowdot(lib, W0, rows, stream)
        launched = launched or Ie > 0
    if launched:
        LAUNCHES += 1
    return G, S0, SK
