"""Randomized reactive-redundancy protocol state (paper §4.2, §4.3, §5).

Port of the host state machine in ``repro.core.randomized``.  All
randomness flows from two seeded numpy generators — ``rng`` (replica-
group permutations) and ``decide_rng`` (check-iteration coin flips) —
derived exactly as the reference derives them, so the port's control
replay consumes the identical streams in the identical order and
reproduces the reference's schedule bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core import adaptive
from repro_torch.core.efficiency import EfficiencyMeter

Mode = Literal["randomized", "deterministic", "draco", "filter", "none"]


def decide_generator(seed: int) -> np.random.Generator:
    """The decide-stream generator for a protocol seed (one block draw
    ``Generator.random(T)`` equals T sequential draws)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), 0x0DEC1DE]))


def selective_probabilities(alpha: np.ndarray, beta: np.ndarray,
                            active: np.ndarray, q: float) -> np.ndarray:
    """§5 selective checks: per-worker check probabilities proportional to
    the Beta posterior fault rate, normalized so the active workers' sum
    stays q."""
    rate = alpha / (alpha + beta)
    total = max(rate[active].sum(), 1e-9)
    return np.clip(q * rate / total, 0.0, 1.0) * active


@dataclasses.dataclass
class BFTConfig:
    n: int                       # workers (data-axis size)
    f: int                       # Byzantine tolerance target (< n/2)
    mode: Mode = "randomized"
    q: float | None = None       # fixed check prob; None -> adaptive (§4.3)
    p_assumed: float = 0.5       # assumed per-iteration tamper prob (eq. 3)
    selective: bool = False      # reliability-weighted per-worker checks (§5)
    seed: int = 0

    def __post_init__(self):
        if not (0 <= 2 * self.f < self.n):
            raise ValueError(f"need 2f < n, got f={self.f}, n={self.n}")


@dataclasses.dataclass
class ProtocolState:
    cfg: BFTConfig
    active: np.ndarray            # (n,) bool — not eliminated / not crashed
    identified: np.ndarray        # (n,) bool — proven Byzantine
    crashed: np.ndarray           # (n,) bool — failed nodes (elastic path)
    alpha: np.ndarray             # (n,) float — reliability: fault events + prior
    beta: np.ndarray              # (n,) float — reliability: clean checks + prior
    rng: np.random.Generator      # replica-group permutations
    decide_rng: np.random.Generator  # check-iteration coin flips
    step: int = 0
    meter: EfficiencyMeter = dataclasses.field(default_factory=EfficiencyMeter)
    last_q: float = 0.0
    last_lambda: float = 0.0

    @property
    def kappa(self) -> int:
        """κ_t: Byzantine workers identified so far."""
        return int(self.identified.sum())

    @property
    def f_t(self) -> int:
        """Residual fault budget f - κ_t (never below 0)."""
        return max(0, self.cfg.f - self.kappa)

    def check_probability(self, observed_loss: float | None) -> float:
        cfg = self.cfg
        if cfg.mode == "none":
            return 0.0
        if cfg.mode in ("deterministic", "randomized") and self.f_t == 0:
            return 0.0
        if cfg.mode in ("deterministic", "draco"):
            return 1.0
        if cfg.q is not None:
            return float(cfg.q)
        lam = adaptive.lam_from_loss(observed_loss if observed_loss is not None else 1.0)
        self.last_lambda = lam
        return adaptive.q_star(self.f_t, cfg.p_assumed, lam)

    def decide_check(self, observed_loss: float | None = None) -> bool:
        q = self.check_probability(observed_loss)
        self.last_q = q
        if self.cfg.selective and 0.0 < q < 1.0:
            q_i = selective_probabilities(self.alpha, self.beta,
                                          self.active, q)
            return bool((self.decide_rng.random(self.cfg.n) < q_i).any())
        return bool(self.decide_rng.random() < q)

    def on_clean_check(self, checked_workers: np.ndarray) -> None:
        self.beta[checked_workers] += 1.0

    def on_identified(self, byz_workers: np.ndarray) -> None:
        """Eliminate identified Byzantine workers (κ grows, f_t shrinks)."""
        self.identified[byz_workers] = True
        self.active[byz_workers] = False
        self.alpha[byz_workers] += 1.0

    def on_crash(self, workers: np.ndarray) -> None:
        """Elastic path: node failure — same remap as elimination, no
        Byzantine verdict."""
        self.crashed[workers] = True
        self.active[workers] = False

    def on_recover(self, workers: np.ndarray) -> None:
        """Elastic scale-up: recovered nodes rejoin unless identified."""
        self.crashed[workers] = False
        self.active[workers] = ~self.identified[workers]
