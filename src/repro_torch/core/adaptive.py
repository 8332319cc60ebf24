"""Adaptive fault-check probability (paper §4.3, eqs. 2–5), scalar form.

Port of ``repro.core.adaptive``: the float64 closed form ``q_star``
and ``lam_from_loss`` that ``ProtocolState``'s check probability calls,
the eq-2 / eq-3 bounds the efficiency report (``obs.report``) sets the
observed overhead against, and the vectorized torch forms
``lam_from_loss_arr`` / ``q_star_arr`` the device control plane computes
q*_t with inside its step loop, in the loss's dtype (float32).

    q_t* = λ b² / ((1-λ) a² + λ b²),  clipped to [0, 1],

with a = 2f_t/(2f_t+1), b = 1-(1-p)^{f_t} and λ_t = 1 - exp(-ℓ_t).
"""
from __future__ import annotations

import math

import torch


def com_eff(q: float, f_t: int) -> float:
    """Expected computation efficiency lower bound (paper eq. 2)."""
    if f_t <= 0:
        return 1.0
    return (2 * f_t * (1 - q) + 1) / (2 * f_t + 1)


def prob_faulty_update(q: float, f_t: int, p: float) -> float:
    """Probability of a faulty parameter update (paper eq. 3)."""
    return (1 - (1 - p) ** f_t) * (1 - q)


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


def lam_from_loss_arr(loss: torch.Tensor) -> torch.Tensor:
    """Vectorized eq. 5 in ``loss``'s dtype."""
    return 1.0 - torch.exp(-torch.clamp(loss, min=0.0))


def q_star_arr(f_t: torch.Tensor, p: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """Vectorized ``q_star`` in ``lam``'s dtype: ``f_t`` (int), ``p`` and
    ``lam`` broadcast.  The same guards: f_t <= 0, b == 0 and denom == 0
    give 0; lam is clipped to [0, 1] and the result too."""
    ft = torch.clamp(f_t, min=0).to(lam.dtype)
    a = 2.0 * ft / (2.0 * ft + 1.0)
    b = 1.0 - (1.0 - p) ** ft
    lam = torch.clamp(lam, 0.0, 1.0)
    denom = (1.0 - lam) * a * a + lam * b * b
    ok = (ft > 0) & (b != 0.0) & (denom != 0.0)
    q = lam * b * b / torch.where(ok, denom, 1.0)
    return torch.where(ok, torch.clamp(q, 0.0, 1.0), 0.0)
