"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Port of ``repro.kernels.ref``: deliberately naive definitions, run on
whatever device their inputs lie on.  The sign hash is bit-exact with
the reference's uint32 arithmetic.  PyTorch on the CPU has no ``+``,
``>>`` or ``<`` on ``uint32``, so the hash runs in int64 and masks every
step with ``& 0xFFFFFFFF``; each 32-bit multiply is split into two
16-bit halves so that no int64 product can overflow.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
HASH_MUL1 = 2654435761
HASH_MUL2 = 2246822519


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a uint32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_signs_ref(idx: torch.Tensor, key_scalar) -> torch.Tensor:
    """±1 float32 signs of column positions ``idx`` under a uint32 key
    (``key_scalar`` an int, or an int64 tensor broadcasting against
    ``idx``): the reference's xorshift-multiply hash, low bit -> sign."""
    if isinstance(key_scalar, torch.Tensor):
        key = key_scalar.to(torch.int64) & _M32
    else:
        key = int(key_scalar) & _M32
    h = (_mul32(idx.to(torch.int64) & _M32, HASH_MUL1) + key) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, HASH_MUL2)
    h = h ^ (h >> 13)
    one = torch.ones((), dtype=torch.float32, device=h.device)
    return torch.where((h & 1) == 1, one, -one)


def _bucketed(flat_g: torch.Tensor, k: int) -> torch.Tensor:
    """(..., d) -> (..., d_pad) float32 with zero padding to a multiple
    of k (zero columns are inert in every sketch)."""
    d = flat_g.shape[-1]
    pad = (-d) % k
    return torch.nn.functional.pad(flat_g.to(torch.float32), (0, pad))


def sketch_ref(flat_g: torch.Tensor, key_scalar, k: int) -> torch.Tensor:
    """CountSketch of a flat vector: (d,) -> (k,); bucket = column % k."""
    g = _bucketed(flat_g, k)
    idx = torch.arange(g.shape[0], device=g.device)
    return (g * hash_signs_ref(idx, key_scalar)).reshape(-1, k).sum(dim=0)


def batched_sketch_ref(flat_g: torch.Tensor, key_scalar, k: int) -> torch.Tensor:
    """(B, d) -> (B, k): per-row ``sketch_ref`` under one shared key."""
    g = _bucketed(flat_g, k)
    idx = torch.arange(g.shape[1], device=g.device)
    signed = g * hash_signs_ref(idx, key_scalar)[None]
    return signed.reshape(g.shape[0], -1, k).sum(dim=1)


def pairwise_maxdiff_ref(replicas: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, R): rel[i, j] = max_t |a - b| / (1 + min(|a|, |b|))
    over replicas a = r_i, b = r_j (agreement iff rel <= tau)."""
    a = replicas[:, None].to(torch.float32)
    b = replicas[None, :].to(torch.float32)
    rel = (a - b).abs() / (1.0 + torch.minimum(a.abs(), b.abs()))
    return rel.amax(dim=-1)


def batched_pairwise_maxdiff_ref(replicas: torch.Tensor) -> torch.Tensor:
    """(B, R, d) -> (B, R, R): per-row ``pairwise_maxdiff_ref``."""
    a = replicas[:, :, None].to(torch.float32)
    b = replicas[:, None, :].to(torch.float32)
    rel = (a - b).abs() / (1.0 + torch.minimum(a.abs(), b.abs()))
    return rel.amax(dim=-1)


def gram_factors_ref(rows: torch.Tensor, W0: torch.Tensor | None,
                     keys: torch.Tensor, k: int = 256):
    """Composed oracle of the gram precompute: G = rows @ rows^T,
    S0 = W0 @ rows^T (None without W0), SK[t] = per-row CountSketch of
    the rows under keys[t] (``keys`` int64 values of uint32 keys)."""
    rows32 = rows.to(torch.float32)
    G = rows32 @ rows32.T
    S0 = None if W0 is None else W0.to(torch.float32) @ rows32.T
    Ie = rows32.shape[0]
    if keys.shape[0] == 0:
        SK = torch.zeros((0, Ie, k), dtype=torch.float32, device=rows.device)
    else:
        SK = torch.stack([batched_sketch_ref(rows32, int(key), k)
                          for key in keys.tolist()])
    return G, S0, SK
