"""Efficiency report: turn a ``BatchResult`` (with telemetry) into the
paper's redundancy-overhead accounting.

Port of ``repro.obs.report``.  Rows group trials by scenario class
(default key: the spec's attack / Byzantine-count signature) and compare
the OBSERVED redundancy overhead against the closed-form expectation,
``1 - com_eff(q, f_t)`` from eq. 2, evaluated at the trial's mean q_t
and its worst-case (initial) Byzantine count.

Kept out of ``repro_torch.obs.__init__`` and importing
``repro_torch.core`` lazily: the core's plan layer imports
``repro_torch.obs``, so a top-level import here would be circular.
"""
from __future__ import annotations

import numpy as np


def _default_key(spec) -> str:
    byz = getattr(spec, "byz", ())
    attack = getattr(spec, "attack", "?")
    return f"{attack}/f={len(byz)}"


def efficiency_rows(batch, key=None) -> list[dict]:
    """Per-scenario-class efficiency rows for a batch with telemetry.

    ``batch`` is duck-typed: needs ``.specs`` and ``.telemetry`` (a
    :class:`repro_torch.obs.telemetry.Telemetry`).  ``key`` maps a spec
    to its grouping label (defaults to ``attack/f=<count>``).
    """
    from repro_torch.core import adaptive  # lazy: core imports obs

    tel = getattr(batch, "telemetry", None)
    if tel is None:
        raise ValueError("batch has no telemetry — run with "
                         "run_batch(..., telemetry=True)")
    key = key or _default_key
    groups: dict[str, list[int]] = {}
    for b, spec in enumerate(batch.specs):
        groups.setdefault(key(spec), []).append(b)

    rows = []
    overhead = tel.redundancy_overhead
    for label in sorted(groups):
        idx = np.asarray(groups[label])
        steps = int(tel.counters["steps"][idx].sum())
        q_means = tel.q_mean[idx]
        q_mean = (float(np.nanmean(q_means))
                  if np.isfinite(q_means).any() else 0.0)
        f_max = max(len(getattr(batch.specs[b], "byz", ())) for b in idx)
        # eq-2 bound at mean q and the initial (worst-case) Byzantine count
        expected = 1.0 - adaptive.com_eff(q_mean, f_max)
        rows.append({
            "scenario": label,
            "trials": int(idx.size),
            "steps": steps,
            "checks": int(tel.counters["checks"][idx].sum()),
            "detects": int(tel.counters["detects"][idx].sum()),
            "eliminations": int(tel.counters["eliminations"][idx].sum()),
            "tamper_events": int(tel.counters["tamper_events"][idx].sum()),
            "q_mean": q_mean,
            "observed_overhead": float(overhead[idx].mean()),
            "expected_overhead": expected,
        })
    return rows


def render_report(batch, key=None) -> str:
    """Plain-text table of :func:`efficiency_rows` for terminal output."""
    rows = efficiency_rows(batch, key=key)
    cols = ["scenario", "trials", "steps", "checks", "detects",
            "eliminations", "q_mean", "observed_overhead",
            "expected_overhead"]
    fmt = {"q_mean": "{:.3f}", "observed_overhead": "{:.3f}",
           "expected_overhead": "{:.3f}"}
    table = [[fmt.get(c, "{}").format(r[c]) for c in cols] for r in rows]
    widths = [max(len(c), *(len(t[i]) for t in table)) if table else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(t.ljust(w) for t, w in zip(row, widths))
              for row in table]
    return "\n".join(lines)
