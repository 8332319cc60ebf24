"""Core layers: norms, rotary embeddings, embeddings, SwiGLU MLP, init.

Port of ``repro.models.layers``: pure functions over explicit parameter
dictionaries, with the reference's precision rules — norms, rotary
angles and the SiLU in f32, cast back to the input's dtype; logits in
f32 from an f32 copy of the tied table.

A leaf split over the ambient ``model`` axis (``models.parallel``) is
read as it lies: the embedding table's rows by vocab (a masked local
lookup, then a sum over ``model``), the unembedding's columns by vocab
(the f32 logits stay split, (..., V / model) on each rank), the MLP's
gate / up columns and down rows by ffn (then a sum over ``model``), an
RMSNorm over a split dim by its sum of squares summed over ``model``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import parallel


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_weight(shape, dtype, gen: torch.Generator, device) -> torch.Tensor:
    """The reference's ``materialize`` for a matrix: truncated normal on
    [-2, 2] times 1/sqrt(fan_in), fan_in = shape[-2], drawn in f32; on
    the ``meta`` device only its shape and dtype."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w *= 1.0 / math.sqrt(max(1, shape[-2]))
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            width: int | None = None) -> torch.Tensor:
    """RMSNorm over the last dim; when it is below ``width``, x and the
    scale are this rank's slice of a dim of ``width`` split over the
    model axis, and the mean square is the f32 sum of squares summed
    over ``model`` (forward and backward), over ``width``."""
    x32 = x.to(torch.float32)
    if width is None or width == x.shape[-1]:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        var = parallel.all_reduce(
            x32.square().sum(dim=-1, keepdim=True)) / width
    x32 = x32 * torch.rsqrt(var + eps)
    return (x32 * params["scale"].to(torch.float32)).to(x.dtype)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS normalization (qk-norm without learned scale)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in f32; theta enters as a number, so no
    host tensor is made (the dry-run counts the same storages on every
    device)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    table = params["tokens"].to(dtype_of(cfg))
    if table.shape[0] == cfg.vocab_size:       # the vocab is not split
        return table[tokens]
    ax = parallel.require_axis()
    n = table.shape[0]
    local = tokens - ax.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return parallel.reduce(torch.where(inside[..., None], rows, 0.0), ax)


def unembed(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits in f32: x and the (tied) table both cast to f32.  Under a
    vocab split, this rank's columns of them."""
    w = params["tokens"].T if cfg.tie_embeddings else params["head"]
    if w.shape[-1] != cfg.vocab_size:
        x = parallel.copy(x)
    return x.to(torch.float32) @ w.to(torch.float32)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(params, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU; when ``params``' ffn width is below ``d_ff``, its slice of
    the ffn over the model axis: column-parallel gate / up, row-parallel
    down, the outputs summed over ``model``."""
    split = d_ff is not None and params["gate"].shape[-1] != d_ff
    if split:
        x = parallel.copy(x)
    g = x @ params["gate"]
    u = x @ params["up"]
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    y = h @ params["down"]
    return parallel.reduce(y) if split else y
