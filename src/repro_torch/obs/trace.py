"""Host span tracing: wall-clock spans with Chrome-trace export, and the
``profile_trace`` hook that nests ``torch.profiler``.

Port of ``repro.obs.trace``.  Spans record into a bounded in-process
ring buffer (no I/O on the hot path, no background thread);
:func:`export_chrome` writes the buffer as Chrome-trace JSON ("X"
complete events) loadable in ``chrome://tracing`` / Perfetto.
``profile_trace`` additionally nests ``torch.profiler.profile`` (CPU
and, on a CUDA device, CUDA activities) when ``REPRO_PROFILE=<dir>`` is
set (or an explicit ``profile_dir`` is passed), and writes its Chrome
trace under ``<dir>/<label>``, so every kernel launch lines up with the
host spans: the counterpart of the reference's ``jax.profiler.trace``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time


class SpanTracer:
    """Bounded ring buffer of completed spans."""

    def __init__(self, maxlen: int = 65536):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=maxlen)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a wall-clock span around the enclosed block.

        Extra keyword arguments land in the event's ``args`` dict
        (small JSON-serializable values: chunk index, schedule mode)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur = time.perf_counter_ns() - t0
            ev = {"name": name, "ts_ns": t0, "dur_ns": dur,
                  "tid": threading.get_ident()}
            if args:
                ev["args"] = args
            with self._lock:
                self._events.append(ev)

    def traced(self, name: str | None = None):
        """Decorator form of :meth:`span` (span name defaults to the
        function's qualified name)."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def export_chrome(self, path: str) -> str:
        """Write the buffered spans as Chrome-trace JSON ("X" events,
        microsecond timestamps) and return the path."""
        pid = os.getpid()
        events = []
        for ev in self.spans():
            out = {"name": ev["name"], "ph": "X", "pid": pid,
                   "tid": ev["tid"], "ts": ev["ts_ns"] / 1e3,
                   "dur": ev["dur_ns"] / 1e3}
            if "args" in ev:
                out["args"] = ev["args"]
            events.append(out)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      fh, indent=1)
            fh.write("\n")
        return path


TRACER = SpanTracer()

span = TRACER.span
traced = TRACER.traced
spans = TRACER.spans
clear = TRACER.clear
export_chrome = TRACER.export_chrome


@contextlib.contextmanager
def profile_trace(label: str, profile_dir: str | None = None):
    """Span + opt-in ``torch.profiler`` window around the enclosed block.

    Always records an obs span named ``label``.  When
    ``REPRO_PROFILE=<dir>`` is set (or ``profile_dir`` is passed
    explicitly), additionally profiles the block with
    ``torch.profiler.profile`` (CUDA activities too when a CUDA device
    is present) and writes its Chrome trace to
    ``<dir>/<label>/<worker>.<timestamp>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``'s layout, which
    TensorBoard and Perfetto read); without it, the profiler side is a
    no-op.
    """
    prof_dir = (os.environ.get("REPRO_PROFILE") if profile_dir is None
                else profile_dir)
    with TRACER.span(label, profiled=bool(prof_dir)):
        if not prof_dir:
            yield
            return
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        handler = tensorboard_trace_handler(os.path.join(prof_dir, label))
        with profile(activities=activities, on_trace_ready=handler):
            yield
            if torch.cuda.is_available():
                # the window's device work ends inside it
                torch.cuda.synchronize()
