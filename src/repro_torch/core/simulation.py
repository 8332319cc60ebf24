"""The paper's least-squares testbed: attack table, problem generator and
per-trial result record.

Port of the parts of ``repro.core.simulation`` that the engine needs.
The serial ``run_protocol`` reference is ported in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.randomized import ProtocolState

Attack = Callable[[np.ndarray], np.ndarray]

ATTACKS: dict[str, Attack] = {
    "none": lambda g: g,
    "sign_flip": lambda g: -5.0 * g,
    "scale": lambda g: 10.0 * g,
    "noise": lambda g: g + np.random.default_rng(0).normal(size=g.shape),
    "drift": lambda g: g + 1.0,
    "zero": lambda g: np.zeros_like(g),
}


def make_problem(n_data=256, d=8, seed=0):
    """Noiseless least squares: A ~ N(0, 1) (n_data, d), w* ~ N(0, 1),
    y = A w* — drawn in the reference's order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_data, d))
    w_true = rng.normal(size=d)
    return A, A @ w_true, w_true


@dataclasses.dataclass
class SimResult:
    w: np.ndarray
    w_true: np.ndarray
    state: ProtocolState
    losses: list
    q_trace: list
    identify_step: dict  # worker -> step identified

    @property
    def final_error(self) -> float:
        return float(np.linalg.norm(self.w - self.w_true))

    @property
    def efficiency(self) -> float:
        return self.state.meter.overall
