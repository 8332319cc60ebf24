"""Computation-efficiency accounting (paper Definition 2).

computation efficiency = (# gradients used for the update)
                       / (# gradients computed by the workers in total)

Port of ``repro.core.efficiency``: the host control plane's meter, kept
as a copy so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EfficiencyMeter:
    used: int = 0
    computed: int = 0
    iterations: int = 0
    check_iterations: int = 0
    identify_iterations: int = 0
    history: list = dataclasses.field(default_factory=list)

    def record(self, used: int, computed: int, *, checked: bool = False,
               identified: bool = False) -> float:
        self.used += used
        self.computed += computed
        self.iterations += 1
        self.check_iterations += int(checked)
        self.identify_iterations += int(identified)
        eff = used / max(1, computed)
        self.history.append(eff)
        return eff

    @property
    def overall(self) -> float:
        return self.used / max(1, self.computed)

    def state_dict(self) -> dict:
        return {
            "used": self.used,
            "computed": self.computed,
            "iterations": self.iterations,
            "check_iterations": self.check_iterations,
            "identify_iterations": self.identify_iterations,
        }

    def load_state_dict(self, d: dict) -> None:
        self.used = d["used"]
        self.computed = d["computed"]
        self.iterations = d["iterations"]
        self.check_iterations = d["check_iterations"]
        self.identify_iterations = d["identify_iterations"]
