"""CountSketch of flat vectors: the hand-written Hopper kernels and their
plain PyTorch versions.

``sketch_batched(g (B, d), key) -> (B, k)``: out[b, c] = sum over
columns p = c (mod k) of sign(p, key) * g[b, p], one shared key for all
rows (``ref.batched_sketch_ref``).  ``sketch(g (d,), key) -> (k,)`` is
the single form (``ref.sketch_ref``), one launch of its own kernel.
``sketch_block(block (rows, cols), key, k, cfull, c0) -> (k,)`` is the
shard form (``ref.block_sketch_ref``): one rank's shard of a leaf split
over the model axis, viewed as a (rows, cols) block of the leaf's
(rows, cfull) view from column c0, hashed and bucketed by the full
leaf's flat index, one launch; it reads an f32 or bf16 block as it is
(a bf16 block sketches as its f32 cast).  The
CUDA kernels live in ``csrc/sketch.cu``, whose header note says which
TPU kernels they replace (src/repro/kernels/sketch.py:77 and :25), what
bounds them on the H100 and what their design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_K = 256

# wrapper calls that launched the CUDA kernel, per form (the shard form
# per input dtype: bf16 and f32)
LAUNCHES = {"sketch_batched": 0, "sketch": 0, "sketch_shard": 0,
            "sketch_shard_f32": 0}

# the single and shard forms' partials and tickets, per (device, stream,
# k): calls on one stream run in order, so they can share them; two
# streams never do
_SINGLE_WS: dict = {}


def sketch_batched_plain(flat_g: torch.Tensor, key_scalar,
                         k: int = DEFAULT_K) -> torch.Tensor:
    return _ref.batched_sketch_ref(flat_g, key_scalar, k)


def sketch_plain(flat_g: torch.Tensor, key_scalar,
                 k: int = DEFAULT_K) -> torch.Tensor:
    return _ref.sketch_ref(flat_g, key_scalar, k)


def sketch_block_plain(block: torch.Tensor, key_scalar, k: int, cfull: int,
                       c0: int) -> torch.Tensor:
    return _ref.block_sketch_ref(block, key_scalar, k, cfull, c0)


def _lib():
    lib = _build.load("sketch")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sketch_num_spans.argtypes = [i, ll, i]
        lib.sketch_num_spans.restype = i
        lib.sketch_batched.argtypes = [vp, i, ll, i, ctypes.c_uint32, vp,
                                       vp, vp]
        lib.sketch_batched.restype = i
        lib.sketch_single_max_blocks.argtypes = []
        lib.sketch_single_max_blocks.restype = i
        lib.sketch_single.argtypes = [vp, ll, i, ctypes.c_uint32, vp, vp, vp,
                                      vp]
        lib.sketch_single.restype = i
        for fn in (lib.sketch_block, lib.sketch_block_bf16):
            fn.argtypes = [vp, ll, ll, ll, ll, i, ctypes.c_uint32, vp, vp,
                           vp, vp]
            fn.restype = i
        lib.sketch_error_string.argtypes = [i]
        lib.sketch_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _contig(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous() if x.is_cuda else x


@_build.on_operand_device
def sketch_batched_cuda(flat_g: torch.Tensor, key_scalar,
                        k: int = DEFAULT_K) -> torch.Tensor:
    """The hand-written kernel on a CUDA tensor (B, d) f32; runs on
    PyTorch's current stream, no synchronization."""
    g = _contig(flat_g)
    _build.require_cuda_tensor(g, "flat_g", 2, (torch.float32,))
    if k < 1:
        raise ValueError(f"sketch width k must be >= 1, got {k}")
    B, d = g.shape
    out = torch.empty((B, k), dtype=torch.float32, device=g.device)
    if B == 0:
        return out
    lib = _lib()
    part = torch.empty((lib.sketch_num_spans(B, d, k), B, k),
                       dtype=torch.float32, device=g.device)
    _build.check_status(lib.sketch_error_string, lib.sketch_batched(
        g.data_ptr(), B, d, k, int(key_scalar) & 0xFFFFFFFF, part.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream),
        "sketch_batched")
    LAUNCHES["sketch_batched"] += 1
    return out


def _single_workspace(lib, device: torch.device, stream: int, k: int):
    key = (device.index, stream, k)
    ws = _SINGLE_WS.get(key)
    if ws is None:
        kp = -(-k // 4) * 4
        ws = _SINGLE_WS[key] = (
            torch.empty((lib.sketch_single_max_blocks(), kp),
                        dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))
    return ws


@_build.on_operand_device
def sketch_cuda(flat_g: torch.Tensor, key_scalar,
                k: int = DEFAULT_K) -> torch.Tensor:
    """The single form (d,) -> (k,) on a CUDA tensor: one launch of
    ``sketch_single`` on PyTorch's current stream, no synchronization."""
    if flat_g.dim() != 1:
        raise TypeError(f"flat_g must be 1-D (d,), got {tuple(flat_g.shape)}")
    g = _contig(flat_g)
    _build.require_cuda_tensor(g, "flat_g", 1, (torch.float32,))
    if k < 1:
        raise ValueError(f"sketch width k must be >= 1, got {k}")
    lib = _lib()
    stream = _build.raw_stream(g.device.index)
    part, ticket = _single_workspace(lib, g.device, stream, k)
    out = torch.empty(k, dtype=torch.float32, device=g.device)
    _build.check_status(lib.sketch_error_string, lib.sketch_single(
        g.data_ptr(), g.shape[0], k, int(key_scalar) & 0xFFFFFFFF,
        part.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream),
        "sketch_single")
    LAUNCHES["sketch"] += 1
    return out


@_build.on_operand_device
def sketch_block_cuda(block: torch.Tensor, key_scalar, k: int, cfull: int,
                      c0: int) -> torch.Tensor:
    """The shard form on a CUDA (rows, cols) f32 or bf16 block, read in its
    own dtype: one launch of ``sketch_block`` (``sketch_block_bf16``) on
    PyTorch's current stream, no synchronization."""
    if block.dim() != 2:
        raise TypeError(f"block must be 2-D (rows, cols), got "
                        f"{tuple(block.shape)}")
    g = _contig(block)
    _build.require_cuda_tensor(g, "block", 2, (torch.float32, torch.bfloat16))
    if k < 1:
        raise ValueError(f"sketch width k must be >= 1, got {k}")
    rows, cols = g.shape
    if c0 < 0 or c0 + cols > cfull:
        raise ValueError(f"columns [{c0}, {c0 + cols}) outside a row of "
                         f"{cfull}")
    lib = _lib()
    stream = _build.raw_stream(g.device.index)
    part, ticket = _single_workspace(lib, g.device, stream, k)
    out = torch.empty(k, dtype=torch.float32, device=g.device)
    fn = lib.sketch_block_bf16 if g.dtype == torch.bfloat16 \
        else lib.sketch_block
    _build.check_status(lib.sketch_error_string, fn(
        g.data_ptr(), rows, cols, cfull, c0, k, int(key_scalar) & 0xFFFFFFFF,
        part.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream),
        "sketch_block")
    LAUNCHES["sketch_shard" if g.dtype == torch.bfloat16
             else "sketch_shard_f32"] += 1
    return out
