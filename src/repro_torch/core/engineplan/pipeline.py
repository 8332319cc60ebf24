"""Stream the trial batch through the step core in plan-sized chunks.

Port of ``repro.core.engineplan.pipeline.run_chunks`` for one device, an
asynchronous pipeline of depth 1: chunk k+1 is staged and dispatched
before chunk k is drained, so the host's dispatch of one chunk overlaps
the device's work on the other, and at most two chunks' buffers are
resident, which keeps the plan's ``chunk_trials`` memory bound.  The
last chunk pads up to a device multiple with inert trials
(``PAD_FILL``: live=False, weights 0, idle workers -1, no filter) and
the padding is sliced off the results.  Every chunk starts from W0 = 0;
the fused plane's pending-coefficient carry starts at cw0 = 0 (no
update to apply on the first kernel call: the pipelined prologue), and
the gram plane's S0 = W0 R^T is zero too.  Trials that do not share a
problem upload their chunk's slice of ``pid`` and gather their
(chunk, n_data, d) data rows and targets from the device-resident
per-problem stack by it.

On a CUDA device, in place of the reference's asynchronous dispatch and
buffer donation:

* the per-chunk device buffers (W0, cw0) are two slots reused in turn,
  zeroed in place;
* a chunk's schedule and statics go up from pinned memory without
  blocking the host;
* a chunk's W_T (f32), losses, detect flags and counters come back on
  a copy stream that waits on an event recorded after the chunk's last
  kernel, W_T into the slot's reused pinned buffer; the drain waits on
  that copy's event alone, never on the whole device, so chunk k's
  drain does not wait on chunk k+1's queued work;
* one host pass then widens the chunk's W_T into its rows of the f64
  ``W`` (the values are exact: f32 -> f64 is lossless, as the
  reference's ``np.asarray(W, np.float64)``).

Under the device control plane (``plan.control == "device"``) a chunk
stages only its statics (no schedule) and runs ``stepcore.device_scan``,
and its decision trace (q, check, faulty2) comes back beside the losses
and detect flags through the same copy stream and pinned buffers
(``pipeline.py:115-132`` and ``:153-157`` of the reference).

The spans ``pipeline.stage``, ``pipeline.dispatch`` and
``pipeline.drain`` (each with ``lo`` and ``hi``) are the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.engineplan import stepcore
from repro_torch.obs import trace as obtrace
from repro_torch.obs.telemetry import TEL_KEYS, zero_counts

# per-array padding fill values: -1 marks idle workers / no-filter rows,
# everything else pads to an inert zero trial (live=False, weights 0)
PAD_FILL = {"group1": -1, "group2": -1, "fcode": -1, "farr": 1}


def pad_rows(arr: np.ndarray, axis: int, pad: int, fill=0) -> np.ndarray:
    """Pad ``arr`` with ``fill`` along ``axis`` (idle-trial padding)."""
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


class PhaseClock:
    """Wall time per phase, synchronizing the device at each mark so a
    phase's time includes its device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, phase: str, split: dict[str, float] | None = None) -> None:
        """Book the time since the last mark under ``phase``; ``split``
        ({phase: seconds}) books that much of it under other phases."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        elapsed = now - self._t
        for name, s in (split or {}).items():
            self.seconds[name] = self.seconds.get(name, 0.0) + s
            elapsed -= s
        self.seconds[phase] = self.seconds.get(phase, 0.0) + elapsed
        self._t = now


def upload(tree, device: torch.device):
    """numpy arrays (or a dict of them) -> tensors on ``device``; to a
    CUDA device through pinned memory, ordered on the current stream
    without blocking the host."""
    if isinstance(tree, dict):
        return {k: upload(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def widen_into(dst: np.ndarray, src: torch.Tensor) -> None:
    """One host pass: f32 rows on the host -> their f64 rows of ``W``
    (PyTorch's CPU copy, which splits the pass over its threads)."""
    torch.from_numpy(dst).copy_(src)


class _Timer:
    """The scan's time: CUDA events recorded at chunk boundaries on the
    current stream (read once the pipeline is drained), or the host's
    clock on the CPU, where the step loop runs synchronously."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.pairs: list = []
        self._t0 = None

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self._t0 = self._now()

    def stop(self) -> None:
        self.pairs.append((self._t0, self._now()))

    def seconds(self) -> float:
        if self.cuda:
            return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3
        return sum(b - a for a, b in self.pairs)


class _Slot:
    """One chunk's reused buffers: W0 and cw0 on the device and, on a
    CUDA device, the pinned host buffer its W_T comes back through."""

    def __init__(self, rows: int, d: int, Ie: int | None, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.W0 = torch.empty((rows, d), **f32)
        self.cw0 = None if Ie is None else torch.empty((rows, Ie), **f32)
        self.W_host = (torch.empty((rows, d), dtype=torch.float32,
                                   pin_memory=True)
                       if device.type == "cuda" else None)


def run_chunks(plan, *, B: int, T: int, d: int, device, A_dev, y_dev,
               com_dev, stat_np, xs_np, impl: str, clock: PhaseClock,
               noise_dev=None, pid_np=None, telemetry: bool = False):
    """Drive the step core over the batch.  ``A_dev``/``y_dev`` are the
    chunk-invariant operands (gram: {"rows", "G"}; fused: the extended
    rows; stream, shared: the data rows), or, when trials do not share a
    problem, every problem's data rows (P, n_data, d) and targets
    (P, n_data), which each chunk gathers by its slice of ``pid_np``
    (B,).  ``xs_np`` is None under the device control plane.  Returns
    (W (B, d) f64, losses (T, B) f64, det (T, B) bool, counters {key:
    (B,) int64} or None, trace) as numpy arrays, where trace is the
    device plane's {"q": (T, B) f32, "check": (T, B) bool, "faulty2":
    (T, B, n) bool}, or None under host control; the scan's time goes
    to ``clock`` as "scan", the rest of the pipeline's as
    "post_scan"."""
    chunk_trials = plan.chunk_trials
    ndev = plan.n_devices
    fused = plan.fused
    gram = plan.data_plane == "gram"
    shared = plan.shared_problem
    device_ctl = plan.control == "device"
    Ie = None
    if gram:
        Ie = A_dev["rows"].shape[0]
    elif fused:
        Ie = A_dev.shape[0]
    flags = dict(fused=fused, gram=gram)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    timer = _Timer(cuda)
    rows = min(chunk_trials, B)
    rows += (-rows) % ndev
    n_chunks = -(-B // chunk_trials)
    slots = [_Slot(rows, d, Ie, device) for _ in range(min(2, n_chunks))]

    W = np.empty((B, d), np.float64)
    losses = np.empty((T, B))
    det = np.empty((T, B), bool)
    counts = zero_counts(B) if telemetry else None
    trace = None
    if device_ctl:
        n = stat_np["byz"].shape[1]
        trace = dict(q=np.empty((T, B), np.float32),
                     check=np.empty((T, B), bool),
                     faulty2=np.empty((T, B, n), bool))

    def stage(lo: int, slot: _Slot):
        """The chunk's per-trial operands on the device."""
        hi = min(lo + chunk_trials, B)
        with obtrace.span("pipeline.stage", lo=lo, hi=hi):
            bs = hi - lo
            pad = (-bs) % ndev
            stat_c = {k: pad_rows(v[lo:hi], 0, pad, PAD_FILL.get(k, 0))
                      for k, v in stat_np.items()}
            W0 = slot.W0[:bs + pad].zero_()
            cw0 = None if Ie is None else slot.cw0[:bs + pad].zero_()
            A_c, y_c, pid_c = A_dev, y_dev, None
            if not (fused or gram):
                pid_c = upload(pad_rows(pid_np[lo:hi], 0, pad).astype(
                    np.int64), device)
                if not shared:
                    A_c, y_c = A_dev[pid_c], y_dev[pid_c]
            if device_ctl:
                args = (A_c, y_c, W0, cw0, upload(stat_c, device), com_dev,
                        noise_dev, pid_c)
                return lo, hi, args, None
            xs_c = {k: pad_rows(v[:, lo:hi], 1, pad, PAD_FILL.get(k, 0))
                    for k, v in xs_np.items()}
            args = (A_c, y_c, W0, cw0, upload(stat_c, device),
                    upload(xs_c, device), com_dev, noise_dev, pid_c)
            return lo, hi, args, carry.gates_from_xs(xs_c)

    def dispatch(lo: int, hi: int, args, gates, slot: _Slot):
        """Queue the chunk's scan, W_T and, on a CUDA device, its copies
        to the host; returns what the drain needs."""
        bs = hi - lo
        with obtrace.span("pipeline.dispatch", lo=lo, hi=hi):
            timer.start()
            if device_ctl:
                out = stepcore.device_scan(
                    *args, impl=impl, gram=gram, shared=shared,
                    has_bias=plan.has_bias, telemetry=telemetry)
                # losses, det, then the trace's q, check, faulty2
                small = [out[1], out[4], out[2], out[3], out[5]]
            else:
                out = stepcore.scan(
                    *args, gates=gates, impl=impl, shared=shared,
                    has_filter=plan.has_filter, has_bias=plan.has_bias,
                    telemetry=telemetry, **flags)
                small = list(out[1:3])
            timer.stop()
            A_c, W0 = args[0], args[2]
            Wc = stepcore.finish(A_c, W0, out[0], **flags)[:bs]
            # losses, det, the trace and the counters keep their padding
            # columns until the drain
            if telemetry:
                small.append(torch.stack([out[-1][k] for k in TEL_KEYS]))
            if not cuda:
                return lo, hi, None, Wc, small
            done = torch.cuda.Event()
            done.record()
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(done)
                W_host = slot.W_host[:bs]
                W_host.copy_(Wc, non_blocking=True)
                small_host = []
                for t in small:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    small_host.append(h.copy_(t, non_blocking=True))
                copied = torch.cuda.Event()
                copied.record()
            # the copies read these on the copy stream: their memory must
            # not go back to the allocator's pool before the copies end
            for t in [Wc] + small:
                t.record_stream(copy_stream)
            return lo, hi, copied, W_host, small_host

    def drain(lo: int, hi: int, copied, W_host, small_host):
        """Wait for the chunk's copies alone; write its rows."""
        with obtrace.span("pipeline.drain", lo=lo, hi=hi):
            if copied is not None:
                copied.synchronize()
            widen_into(W[lo:hi], W_host)
            bs = hi - lo
            losses[:, lo:hi] = small_host[0][:, :bs].numpy()
            det[:, lo:hi] = small_host[1][:, :bs].numpy()
            if device_ctl:
                for key, h in zip(("q", "check", "faulty2"),
                                  small_host[2:5]):
                    trace[key][:, lo:hi] = h[:, :bs].numpy()
            if telemetry:
                tel = small_host[-1][:, :bs].numpy()
                for i, k in enumerate(TEL_KEYS):
                    counts[k][lo:hi] = tel[i]

    inflight = None
    for i, lo in enumerate(range(0, B, chunk_trials)):
        slot = slots[i % len(slots)]
        staged = dispatch(*stage(lo, slot), slot)
        if inflight is not None:
            drain(*inflight)
        inflight = staged
    if inflight is not None:
        drain(*inflight)
    clock.mark("post_scan", split={"scan": timer.seconds()})
    return W, losses, det, counts, trace
