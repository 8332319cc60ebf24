"""The port's copy of what ``jax.random`` gives the trainer.

A key is a pair of uint32 words ``(k0, k1)`` held as Python ints, as
``jax.random.PRNGKey`` holds its threefry key data.  Every function
here is one threefry-2x32 block per output word pair
(``rngstream.threefry2x32``), with the counter layout of
``jax.random`` under ``jax_threefry_partitionable`` (the default):

 * ``PRNGKey(seed)`` = (0, seed);
 * ``fold_in(k, x)`` = threefry(k, (0, x));
 * ``split(k, n)[i]`` = threefry(k, (0, i));
 * ``bits(k, shape)[i]`` = x0 ^ x1 of threefry(k, (0, i)), i the
   flat (row-major) index;
 * ``uniform`` = bitcast((bits >> 9) | 0x3F800000) - 1, in float32;
 * ``bernoulli(k, p)`` = uniform < p (p rounded to float32);
 * ``normal`` = sqrt(2) * erfinv(u), u uniform on the reference's open
   interval (nextafter(-1, 0), 1), erfinv by the float32 polynomial XLA
   lowers ``erf_inv`` to (Giles' approximation, off by up to 1.5e-5 in
   the tails; ``torch.erfinv`` is more exact, so it would not match).

Keys and scalar draws are computed on the host in numpy; draws over a
shape run the torch block on the device they are asked for, in chunks
so the int64 words stay small.  All but ``normal`` are bitwise
``jax.random``'s; ``normal`` agrees within an ulp or two of the float32
``log1p`` (5e-7 over 2e6 draws).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.rngstream import threefry2x32, threefry2x32_torch

_M32 = 0xFFFFFFFF
# flat elements per torch threefry block: eight int64 words of this
# many elements stay near 1 GiB
_CHUNK = 1 << 24
# XLA's erf_inv for float32 (Giles, "Approximating the erfinv function"):
# Horner coefficients for w = -log1p(-x^2) < 5 and >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def PRNGKey(seed: int) -> tuple[int, int]:
    """The threefry key of a seed in [0, 2^32)."""
    return (0, int(seed) & _M32)


def _block(key, c0: int, c1: int) -> tuple[int, int]:
    with np.errstate(over="ignore"):          # uint32 adds wrap by design
        x0, x1 = threefry2x32(np.uint32(key[0]), np.uint32(key[1]),
                              np.uint32(c0), np.uint32(c1))
    return int(x0), int(x1)


def fold_in(key, data: int) -> tuple[int, int]:
    return _block(key, 0, int(data) & _M32)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    return [_block(key, 0, i) for i in range(num)]


def key_scalar_for_step(key) -> int:
    """The uint32 scalar the sketch hash takes: word 0 XOR word 1."""
    return (int(key[0]) ^ int(key[1])) & _M32


def _uniform_from_bits(b) -> np.float32:
    f = np.array((int(b) >> 9) | 0x3F800000, np.uint32).view(np.float32)
    return np.float32(f - np.float32(1.0))


def uniform_scalar(key) -> np.float32:
    """One float32 uniform in [0, 1) of shape ()."""
    x0, x1 = _block(key, 0, 0)
    return max(np.float32(0.0), _uniform_from_bits(x0 ^ x1))


def bernoulli_scalar(key, p: float) -> bool:
    """``jax.random.bernoulli(key, p)`` of shape (): uniform < float32(p)."""
    return bool(uniform_scalar(key) < np.float32(p))


def _words(key, n: int, dev: torch.device):
    """(start, int64 uint32 words) chunks of the flat bits of n draws."""
    k0 = torch.tensor(int(key[0]), dtype=torch.int64, device=dev)
    k1 = torch.tensor(int(key[1]), dtype=torch.int64, device=dev)
    for lo in range(0, n, _CHUNK):
        idx = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64,
                           device=dev)
        x0, x1 = threefry2x32_torch(k0, k1, idx >> 32, idx & _M32)
        yield lo, x0 ^ x1


def bits(key, shape, device=None) -> torch.Tensor:
    """int64 tensor of uint32 random words of ``shape``."""
    dev = torch.device("cpu" if device is None else device)
    out = torch.empty(math.prod(shape), dtype=torch.int64, device=dev)
    for lo, w in _words(key, out.shape[0], dev):
        out[lo:lo + w.shape[0]] = w
    return out.reshape(shape)


def uniform(key, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms on [minval, maxval), the reference's rounding:
    f * (maxval - minval) + minval, then max(minval, .), in float32."""
    dev = torch.device("cpu" if device is None else device)
    out = torch.empty(math.prod(shape), dtype=torch.float32, device=dev)
    lo_t = torch.tensor(minval, dtype=torch.float32, device=dev)
    span = torch.tensor(maxval, dtype=torch.float32, device=dev) - lo_t
    for lo, w in _words(key, out.shape[0], dev):
        f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        out[lo:lo + w.shape[0]] = torch.maximum(lo_t, (f - 1.0) * span + lo_t)
    return out.reshape(shape)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv polynomial, elementwise; +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32,
                                         device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key, shape, device=None) -> torch.Tensor:
    """float32 standard normals: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, 0), 1), computed in chunks."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, lo, 1.0)
    flat = u.reshape(-1)
    for s in range(0, flat.shape[0], _CHUNK):
        flat[s:s + _CHUNK] = erfinv(flat[s:s + _CHUNK])
    return u.mul_(np.float32(math.sqrt(2.0)))
