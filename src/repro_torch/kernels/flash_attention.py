"""GQA flash-attention forward: the hand-written Hopper kernel (K6) and
its plain PyTorch version.

``flash_attention(q (B, Sq, H, hd), k, v (B, Sk, K, hd)) -> (B, Sq, H,
hd)`` with K | H, causal (queries aligned to the end of the keys), an
optional sliding window, f32 or bf16 in and q's dtype out, every sum in
f32.  The plain version is ``ref.flash_attention_ref``, the port of the
reference's ``blockwise_attention``.  ``FlashAttention`` gives the
forward a gradient for training: the reference has no Pallas backward
(its training differentiates XLA's ``blockwise_attention``), so the
backward recomputes the plain version under autograd and differentiates
that.  The CUDA kernel lives in
``csrc/flash_attention.cu``, whose header note says which TPU kernel it
replaces (src/repro/kernels/flash_attention.py:33), what bounds it on
the H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _account, _build
from repro_torch.kernels import ref as _ref
from repro_torch.launch.roofline import kernel_cost

HEAD_DIMS = (16, 32, 64, 128, 256)
# bf16 at these head dims runs the Hopper body, which may ask for scratch
HOPPER_HEAD_DIMS = (64, 128, 256)

# wrapper calls that launched the CUDA kernel
LAUNCHES = {"flash_attention": 0}


def check_window(window) -> None:
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    check_window(window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """K6's shape-only form for the dry-run: the output on q's (``meta``)
    device, with no (B, H, Sq, Sk) score buffer, which K6 never makes."""
    check_window(window)
    B, Sq, H, hd = q.shape
    return torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)


def cost(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
         window: int | None = None):
    """K6's ``roofline.KernelCost`` at q's and k's shapes."""
    B, Sq, H, hd = q.shape
    return kernel_cost("flash_attention", B=B, Sq=Sq, Sk=k.shape[1], H=H,
                       K=k.shape[2], hd=hd, causal=causal, window=window,
                       dtype=str(q.dtype).removeprefix("torch."))


def attend(q, k, v, causal, window, scale, impl: str) -> torch.Tensor:
    """The forward of ``impl``: "cuda" (K6), "meta" (its shape-only
    form) or "torch" (the plain version); the first two accounted to
    the dry-run's counter when one is active."""
    if impl == "torch":
        return flash_attention_plain(q, k, v, causal, window, scale)
    fn = flash_attention_cuda if impl == "cuda" else flash_attention_meta
    return _account.run("flash_attention",
                        lambda: cost(q, k, causal, window),
                        lambda: fn(q, k, v, causal, window, scale))


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is K6 (``impl="cuda"``), its shape-only
    form (``"meta"``) or the plain version (``"torch"``), computed
    without a graph, and whose backward recomputes the plain version
    from the saved q, k, v and differentiates it.  Only the forward
    launches the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        return attend(q, k, v, causal, window, scale, impl)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale = ctx.mask
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_plain(*qkv, causal, window, scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad_out)
        return dq, dk, dv, None, None, None, None


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                            i, ll, ll, ll, ll, ll, ll, ll, ll,
                                            ll, ctypes.c_float, i, i, vp, vp,
                                            vp]
        lib.flash_attention_fwd.restype = i
        pll = ctypes.POINTER(ll)
        lib.flash_attention_plan.argtypes = [i, i, i, i, i, i, i, i, i, pll,
                                             pll]
        lib.flash_attention_plan.restype = i
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _readable(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: unit stride on hd and, for bf16, what a
    TMA map takes (positive strides in multiples of 8 elements, a
    16-byte-aligned start); else a copy."""
    vec = 8 if x.dtype == torch.bfloat16 else 1
    if x.stride(-1) == 1 and all(s % vec == 0 and s > 0
                                 for s in x.stride()[:3]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


@_build.on_operand_device
def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """The hand-written kernel on CUDA tensors; runs on PyTorch's current
    stream, no synchronization.  q, k and v may be strided views."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor for the CUDA "
                             f"kernel")
        if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be a 4-D float32 or bfloat16 "
                            f"tensor, got {x.dtype} {tuple(x.shape)}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype or v.shape != k.shape \
            or k.shape[0] != B or k.shape[3] != hd or k.device != q.device \
            or v.device != q.device or K == 0 or H % K:
        raise ValueError(f"q {q.dtype} {tuple(q.shape)}, k {k.dtype} "
                         f"{tuple(k.shape)} and v {v.dtype} "
                         f"{tuple(v.shape)} do not match (k, v: (B, Sk, K, "
                         f"hd) with K | H, q's dtype and device)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes hd in {HEAD_DIMS}, got {hd}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash kernel takes B, H <= 65535, got {B}, {H}")
    check_window(window)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    q, k, v = _readable(q), _readable(k), _readable(v)
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    bf16, win = int(q.dtype == torch.bfloat16), \
        -1 if window is None else int(window)
    lib = _lib()
    # scratch of the balanced small grids: the chunks' partial results
    # and a zeroed count per query tile
    n_part, n_count = ctypes.c_longlong(0), ctypes.c_longlong(0)
    if bf16 and hd in HOPPER_HEAD_DIMS:
        _build.check_status(lib.flash_error_string, lib.flash_attention_plan(
            bf16, B, Sq, Sk, H, K, hd, int(bool(causal)), win,
            ctypes.byref(n_part), ctypes.byref(n_count)), "flash_attention")
    part = counts = None
    if n_part.value:
        part = torch.empty(n_part.value, dtype=torch.float32,
                           device=q.device)
        counts = torch.zeros(n_count.value, dtype=torch.int32,
                             device=q.device)
    _build.check_status(lib.flash_error_string, lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bf16, B,
        Sq, Sk, H, K, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(bool(causal)), win,
        None if part is None else part.data_ptr(),
        None if counts is None else counts.data_ptr(),
        _build.raw_stream(q.get_device())), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
