"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics`` (the port keeps its own copy).  One global
:data:`REGISTRY` (module-level helpers delegate to it) with JSONL
export: each :meth:`MetricsRegistry.export_jsonl` call appends ONE
self-contained snapshot line, so a long-running process (a sweep, the
serving engine) can dump periodically and the file stays grep/jq-able.
Everything is plain Python and a lock; there is no background thread
and nothing touches the device, so the registry is safe to use from the
engine facade's hot path.
"""
from __future__ import annotations

import json
import os
import threading
import time


class Counter:
    """Monotonically increasing count (events, trials, warnings)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (device count, chunk size)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Streaming summary of an observed distribution (latencies).

    Keeps count/total/min/max — enough for mean and range without
    unbounded storage; per-event detail belongs in the span tracer.
    """

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"kind": self.kind, "count": self.count,
                "total": self.total, "mean": self.mean,
                "min": self.min, "max": self.max}


class MetricsRegistry:
    """Named metrics, created on first touch, one namespace per process."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._KINDS[kind](name)
                self._metrics[name] = m
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def snapshot(self) -> dict:
        """name -> {kind, ...values}, sorted for stable diffs."""
        with self._lock:
            return {name: self._metrics[name].snapshot()
                    for name in sorted(self._metrics)}

    def export_jsonl(self, path: str, extra: dict | None = None) -> str:
        """Append one JSON line holding the full current snapshot."""
        line = {"ts": time.time(), "metrics": self.snapshot()}
        if extra:
            line.update(extra)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(json.dumps(line) + "\n")
        return path

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
export_jsonl = REGISTRY.export_jsonl
reset = REGISTRY.reset
