"""Adaptive fault-check probability (paper §4.3, eqs. 4–5), scalar form.

Port of the host half of ``repro.core.adaptive``: the float64 closed
form ``q_star`` and ``lam_from_loss`` that ``ProtocolState``'s check
probability calls.  The vectorized in-scan forms belong to the device
control plane, which a later slice ports.

    q_t* = λ b² / ((1-λ) a² + λ b²),  clipped to [0, 1],

with a = 2f_t/(2f_t+1), b = 1-(1-p)^{f_t} and λ_t = 1 - exp(-ℓ_t).
"""
from __future__ import annotations

import math


def lam_from_loss(loss: float) -> float:
    """λ_t = 1 - e^{-ℓ_t} (paper eq. 5)."""
    return 1.0 - math.exp(-max(0.0, float(loss)))


def q_star(f_t: int, p: float, lam: float) -> float:
    """Closed-form minimizer of eq. 4, clipped to [0, 1]."""
    if f_t <= 0:
        return 0.0
    a = 2.0 * f_t / (2.0 * f_t + 1.0)
    b = 1.0 - (1.0 - p) ** f_t
    if b == 0.0:
        return 0.0
    lam = min(max(lam, 0.0), 1.0)
    denom = (1.0 - lam) * a * a + lam * b * b
    if denom == 0.0:
        return 0.0
    return min(1.0, max(0.0, lam * b * b / denom))
