"""Counter-based RNG streams of the ``rng="device"`` contract.

Port of ``repro.core.rngstream``.  Every decision variate is a pure
function of ``(seed, stream tag, step t, phase, worker w)`` through one
threefry2x32 block, so the device control plane can draw a whole
chunk's coins before its step loop and the host can replay them
afterwards, bit for bit:

 * DECIDE: one uniform per step, counter ``(t, 0)``: the check coin.
 * TAMPER: one uniform per (step, phase, worker), counter
   ``(t, phase << 16 | w)``: phase 0 = main pass, phase 1 = identify
   pass.
 * PERM: one uint32 sort key per (step, phase, worker), the same
   counter layout: a replica-group permutation is the active workers
   sorted by (key, worker id).

The block is written twice: in numpy ``uint32`` for the host (the
reference's arithmetic), and in torch for the device.  PyTorch on the
CPU has no ``+``, ``>>`` or ``<`` on ``uint32``, so the torch block
holds each word in int64 and masks with ``& 0xFFFFFFFF`` after every
add and shift.  Uniforms take the top 24 bits of the first output word
scaled by 2^-24, exact in float32, so host and device compare the same
value against q and p.  Only the adaptive q*_t itself depends on how
the loss rounds: a coin within an ulp of it can fall either way.
"""
from __future__ import annotations

import numpy as np
import torch

# stream tags (domain separation mixed into the high key word)
DECIDE = np.uint32(0x0DEC1DE5)
TAMPER = np.uint32(0x7A39B013)
PERM = np.uint32(0x9E3779B1)

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The standard 20-round threefry-2x32 block on numpy ``uint32``
    arrays: keys ``(k0, k1)``, counter ``(c0, c1)`` -> two output words,
    all broadcast together."""
    ks = (k0, k1, (k0 ^ k1) ^ np.uint32(_PARITY))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for r in range(5):
        for rot in _ROT[4 * (r % 2): 4 * (r % 2) + 4]:
            x0 = x0 + x1
            x1 = _rotl(x1, rot) ^ x0
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return x0, x1


def threefry2x32_torch(k0, k1, c0, c1):
    """The same block on int64 tensors holding uint32 values (each in
    [0, 2^32)), broadcast together; every add and shift is masked back
    to 32 bits.  Bitwise the numpy block's words."""
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for r in range(5):
        for rot in _ROT[4 * (r % 2): 4 * (r % 2) + 4]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << rot) & _M32) | (x1 >> (32 - rot))) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _M32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & _M32
    return x0, x1


def key_for(seed: int, tag) -> tuple[np.uint32, np.uint32]:
    """Per-trial stream key: low/high words of the seed, tag XORed into
    the high word."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0 = np.uint32(s & _M32)
    k1 = np.uint32(s >> 32) ^ np.uint32(tag)
    return k0, k1


def uniform01(bits):
    """Top-24-bit uniform in [0, 1) of uint32 words (numpy ``uint32`` or
    a torch int64 tensor): ``(bits >> 8)`` cast to float32 times 2^-24,
    exact in float32."""
    if isinstance(bits, torch.Tensor):
        return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    f32 = (bits >> np.uint32(8)).astype(np.float32)
    return f32 * np.float32(1.0 / (1 << 24))


def counter(t, phase, w):
    """Counter words for a (step, phase, worker) cell."""
    return np.uint32(t), (np.uint32(phase) << np.uint32(16)) | np.uint32(w)


# ---------------------------------------------------------------------------
# Host blocks (numpy)
# ---------------------------------------------------------------------------


def decide_uniforms(seed: int, steps: int) -> np.ndarray:
    """(steps,) float32 check coins of one trial."""
    if steps == 0:
        return np.zeros(0, np.float32)
    k0, k1 = key_for(seed, DECIDE)
    t = np.arange(steps, dtype=np.uint32)
    x0, _ = threefry2x32(np.full_like(t, k0), np.full_like(t, k1),
                         t, np.zeros_like(t))
    return uniform01(x0)


def _phase_worker_block(seed: int, steps: int, n: int, tag) -> np.ndarray:
    """(steps, 2, n) uint32 first output words of a per-(t, phase, w)
    stream."""
    if steps == 0 or n == 0:
        return np.zeros((steps, 2, n), np.uint32)
    k0, k1 = key_for(seed, tag)
    t = np.arange(steps, dtype=np.uint32)[:, None, None]
    ph = np.arange(2, dtype=np.uint32)[None, :, None]
    w = np.arange(n, dtype=np.uint32)[None, None, :]
    c0 = np.broadcast_to(t, (steps, 2, n))
    c1 = np.broadcast_to((ph << np.uint32(16)) | w, (steps, 2, n))
    x0, _ = threefry2x32(np.full(c0.shape, k0), np.full(c0.shape, k1),
                         np.ascontiguousarray(c0), np.ascontiguousarray(c1))
    return x0


def tamper_uniforms(seed: int, steps: int, n: int) -> np.ndarray:
    """(steps, 2, n) float32 tamper coins (phase 0 = main pass, phase 1
    = identify pass)."""
    return uniform01(_phase_worker_block(seed, steps, n, TAMPER))


def perm_keys(seed: int, steps: int, n: int) -> np.ndarray:
    """(steps, 2, n) uint32 permutation sort keys."""
    return _phase_worker_block(seed, steps, n, PERM)


class StepClock:
    """Shared step counter the engine advances once per iteration; the
    per-trial ``CounterPermuter``s key their phase counters off it."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = -1


class CounterPermuter:
    """Stand-in for ``ProtocolState.rng`` under the device contract:
    ``permutation(act_idx)`` returns the active workers sorted by their
    (PERM key, worker id) for the current (step, phase) cell.  The first
    call in a step takes phase 0 (the check regroup), the second phase 1
    (the identify regroup), as the engine calls them."""

    __slots__ = ("keys", "clock", "_t", "_phase")

    def __init__(self, keys: np.ndarray, clock: StepClock):
        self.keys = keys              # (steps, 2, n) uint32
        self.clock = clock
        self._t = -1
        self._phase = 0

    def permutation(self, act_idx: np.ndarray) -> np.ndarray:
        if self.clock.t != self._t:
            self._t = self.clock.t
            self._phase = 0
        k = self.keys[self._t, self._phase, act_idx]
        self._phase += 1
        return act_idx[np.argsort(k, kind="stable")]


# ---------------------------------------------------------------------------
# Device blocks (torch): a chunk's coins and keys in one threefry each
# ---------------------------------------------------------------------------


def decide_uniforms_torch(k0: torch.Tensor, k1: torch.Tensor,
                          steps: int) -> torch.Tensor:
    """(steps, B) float32 check coins of B trials, from their DECIDE key
    words k0, k1 (B,) int64; row t equals ``decide_uniforms(seed)[t]``
    of each trial."""
    t = torch.arange(steps, dtype=torch.int64, device=k0.device)[:, None]
    x0, _ = threefry2x32_torch(k0[None], k1[None], t, torch.zeros_like(t))
    return uniform01(x0)


def phase_worker_torch(k0: torch.Tensor, k1: torch.Tensor, steps: int,
                       n: int) -> torch.Tensor:
    """(steps, 2, B, n) int64 first output words of a per-(t, phase, w)
    stream for B trials with key words k0, k1 (B,) int64; [:, :, b]
    equals ``_phase_worker_block`` of trial b."""
    dev = k0.device
    t = torch.arange(steps, dtype=torch.int64, device=dev)[:, None, None,
                                                           None]
    ph = torch.arange(2, dtype=torch.int64, device=dev)[None, :, None, None]
    w = torch.arange(n, dtype=torch.int64, device=dev)[None, None, None, :]
    x0, _ = threefry2x32_torch(k0[None, None, :, None],
                               k1[None, None, :, None], t, (ph << 16) | w)
    return x0
