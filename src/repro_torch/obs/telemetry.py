"""Protocol telemetry: the counter names and their host-side container.

Port of ``repro.obs.telemetry``.  :data:`TEL_KEYS` is the single source
of truth for the counter names.  Inside the step loop
(``run_batch(..., telemetry=True)``) the counters live as a
``{key: (B,) int32}`` dict of tensors on the scan's device, accumulated
exactly as the reference's scan carry accumulates them, so every plane
counts the SAME quantities and the tests can assert exact integer
equality against the reference's backends.  On the host the counters
are widened to int64 and wrapped in :class:`Telemetry` together with
the q_t summary statistics (taken from the per-trial ``q_trace`` rather
than the scan, keeping the counters integer-only).

Counter semantics (per trial, summed over protocol steps):

* ``steps`` — live protocol steps executed (post-convergence steps of a
  padded batch do not count);
* ``checks`` — steps that ran the random reactive check (prob. q_t);
* ``redundant_steps`` — steps that paid any redundant computation
  (reactive check or deterministic DRACO-style vote): the numerator of
  the paper's redundancy-overhead fraction;
* ``detects`` — checked steps whose verdict flagged tampering;
* ``identify_rounds`` — reactive identification rounds triggered;
* ``vote_rounds`` — voting rounds of either flavour (deterministic
  schedule or reactive identification);
* ``eliminations`` — workers eliminated by a vote verdict;
* ``tamper_events`` — gradient tamperings injected by the adversary
  (both phases), whether or not they were caught;
* ``byz_active_steps`` — sum over steps of the number of Byzantine
  workers still active after that step's eliminations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TEL_KEYS = (
    "steps",
    "checks",
    "redundant_steps",
    "detects",
    "identify_rounds",
    "vote_rounds",
    "eliminations",
    "tamper_events",
    "byz_active_steps",
)


def zero_counts(B: int) -> dict:
    """Host-side zero counters for a batch of B trials."""
    return {k: np.zeros(B, dtype=np.int64) for k in TEL_KEYS}


@dataclasses.dataclass
class Telemetry:
    """Per-trial protocol counters for one batch (``BatchResult.telemetry``).

    ``counters[key]`` is a (B,) int64 array indexed like the spec list;
    ``q_mean``/``q_final`` are (B,) float64 summaries of each trial's
    check-probability trajectory (NaN where no live step ran).
    """

    counters: dict
    q_mean: np.ndarray
    q_final: np.ndarray
    labels: tuple = ()

    @classmethod
    def from_counts(cls, counters: dict, *, specs=None, q_traces=None):
        B = len(next(iter(counters.values()))) if counters else 0
        counts = {k: np.asarray(counters[k], dtype=np.int64).reshape(B)
                  for k in TEL_KEYS}
        q_mean = np.full(B, np.nan)
        q_final = np.full(B, np.nan)
        if q_traces is not None:
            for b, tr in enumerate(q_traces):
                tr = np.asarray(tr, dtype=np.float64).ravel()
                if tr.size:
                    q_mean[b] = tr.mean()
                    q_final[b] = tr[-1]
        labels = tuple(getattr(s, "label", str(i))
                       for i, s in enumerate(specs)) if specs else ()
        return cls(counters=counts, q_mean=q_mean, q_final=q_final,
                   labels=labels)

    def __len__(self) -> int:
        return len(self.counters["steps"]) if self.counters else 0

    @property
    def redundancy_overhead(self) -> np.ndarray:
        """Observed fraction of live steps that paid redundant compute —
        the paper's headline efficiency metric, per trial."""
        steps = self.counters["steps"]
        return (self.counters["redundant_steps"]
                / np.maximum(steps, 1).astype(np.float64))

    @property
    def check_rate(self) -> np.ndarray:
        """Fraction of live steps that ran the randomized check
        (empirical realization of E[q_t])."""
        steps = self.counters["steps"]
        return (self.counters["checks"]
                / np.maximum(steps, 1).astype(np.float64))

    @property
    def detection_rate(self) -> np.ndarray:
        """Fraction of checked steps whose verdict caught tampering."""
        checks = self.counters["checks"]
        return (self.counters["detects"]
                / np.maximum(checks, 1).astype(np.float64))

    def per_trial(self, b: int) -> dict:
        """All counters and derived rates for one trial, plain scalars."""
        out = {k: int(v[b]) for k, v in self.counters.items()}
        out["redundancy_overhead"] = float(self.redundancy_overhead[b])
        out["check_rate"] = float(self.check_rate[b])
        out["detection_rate"] = float(self.detection_rate[b])
        out["q_mean"] = float(self.q_mean[b])
        out["q_final"] = float(self.q_final[b])
        if self.labels:
            out["label"] = self.labels[b]
        return out

    def totals(self) -> dict:
        """Batch-wide sums of every counter."""
        return {k: int(v.sum()) for k, v in self.counters.items()}
