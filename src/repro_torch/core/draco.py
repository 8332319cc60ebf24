"""DRACO baseline (Chen et al., 2018): proactive fault correction.

Port of ``repro.core.draco``.  Every shard goes to 2f+1 workers in every
iteration and is majority-voted, so up to f faults are corrected with no
reactive round, at a computation efficiency of 1/(2f+1) always: a DRACO
iteration is a permanent identify-mode iteration.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.assignment import Assignment, identify_assignment
from repro_torch.core.identification import vote_tree  # noqa: F401


def draco_assignment(active: np.ndarray, f: int) -> Assignment:
    return identify_assignment(active, f)


def draco_efficiency(f: int) -> float:
    return 1.0 / (2 * f + 1)
