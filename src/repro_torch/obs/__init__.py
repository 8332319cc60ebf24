"""Observability for the port's engine and serving: the protocol flight
recorder.  Port of ``repro.obs``; nothing here imports the JAX package.

* :mod:`repro_torch.obs.telemetry`: the protocol counters that
  ``run_batch(..., telemetry=True)`` accumulates in the step loop
  (detections, votes, eliminations, tamper events, the paper's
  redundancy-overhead fraction), returned as ``BatchResult.telemetry``;
* :mod:`repro_torch.obs.trace`: host span tracing (context manager +
  decorator) with Chrome-trace export and the ``profile_trace`` hook
  that nests ``torch.profiler`` under ``REPRO_PROFILE``;
* :mod:`repro_torch.obs.metrics`: a process-wide counter / gauge /
  histogram registry with JSONL export.

:mod:`repro_torch.obs.report` renders a ``BatchResult`` into the
paper's efficiency accounting (observed redundancy overhead against the
eq-2 closed form); :mod:`repro_torch.obs.oblog` is the deduplicating
warning funnel the plan layer routes its fallback warnings through.

Layering: ``repro_torch.obs`` sits BESIDE the engine, not above it:
nothing here imports ``repro_torch.core`` at module scope (the report
duck-types ``BatchResult``), so the plan layer may import it.
"""
from repro_torch.obs import metrics, oblog, telemetry, trace  # noqa: F401
from repro_torch.obs.metrics import REGISTRY  # noqa: F401
from repro_torch.obs.oblog import reset_warn_once, warn_once  # noqa: F401
from repro_torch.obs.telemetry import TEL_KEYS, Telemetry  # noqa: F401
from repro_torch.obs.trace import TRACER, profile_trace, span, traced  # noqa: F401
