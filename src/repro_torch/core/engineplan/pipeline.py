"""Stream the trial batch through the step core in plan-sized chunks,
each chunk split over the devices of a trials mesh.

Port of ``repro.core.engineplan.pipeline.run_chunks``, an asynchronous
pipeline of depth 1: every shard of chunk k+1 is staged and dispatched
before any shard of chunk k is drained, so the host's dispatch of one
chunk overlaps the devices' work on the other, and at most two chunks'
buffers are resident on each device, which keeps the plan's
``chunk_trials`` memory bound.  The last chunk pads up to a multiple of
the device count with inert trials (``PAD_FILL``: live=False, weights 0,
idle workers -1, no filter) and the padding is sliced off the results.
A chunk of ``bs`` trials splits into ``ndev`` shards of ceil(bs / ndev)
consecutive trials (the reference's ``shard_map`` over the padded
chunk); a shard that would hold padding alone is not run.  Which
operand splits and which replicates is ``engineplan.shard``'s table:
each device holds its own copy of the chunk-invariant operands (the
caller's ``operands``), and a shard's statics, schedule and ``pid`` are
cut from the batch's by their specs.  Every chunk starts from W0 = 0;
the fused plane's pending-coefficient carry starts at cw0 = 0 (no
update to apply on the first kernel call: the pipelined prologue), and
the gram plane's S0 = W0 R^T is zero too.  Trials that do not share a
problem upload their shard's slice of ``pid`` and gather their
(rows, n_data, d) data rows and targets from the device-resident
per-problem stack by it.

Each shard has, in place of the reference's asynchronous dispatch and
buffer donation on a CUDA device:

* its per-chunk device buffers (W0, cw0): two slots reused in turn,
  zeroed in place;
* its statics and schedule going up from pinned memory without
  blocking the host;
* its W_T (f32), losses, detect flags and counters coming back on its
  own copy stream, which waits on an event recorded after the shard's
  last kernel, W_T into the slot's reused pinned buffer; the drain
  waits on that copy's event alone, never on a whole device, so chunk
  k's drain does not wait on chunk k+1's queued work;
* one host pass then widening the shard's W_T into its rows of the f64
  ``W`` (the values are exact: f32 -> f64 is lossless, as the
  reference's ``np.asarray(W, np.float64)``).

A shard's work is staged and dispatched with its device current, so
its events, streams and kernels are that device's.  A mesh may list a
device more than once: its shards then queue one after the other on it.

Under the device control plane (``plan.control == "device"``) a shard
stages only its statics (no schedule) and runs ``stepcore.device_scan``,
and its decision trace (q, check, faulty2) comes back beside the losses
and detect flags through the same copy stream and pinned buffers
(``pipeline.py:115-132`` and ``:153-157`` of the reference).

The spans ``pipeline.stage``, ``pipeline.dispatch`` and
``pipeline.drain`` (each with ``lo`` and ``hi``, a shard's trials) are
the reference's.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.engineplan import shard, stepcore
from repro_torch.obs import trace as obtrace
from repro_torch.obs.telemetry import TEL_KEYS, zero_counts

# per-array padding fill values: -1 marks idle workers / no-filter rows,
# everything else pads to an inert zero trial (live=False, weights 0)
PAD_FILL = {"group1": -1, "group2": -1, "fcode": -1, "farr": 1}


class PhaseClock:
    """Wall time per phase, synchronizing the devices at each mark so a
    phase's time includes their work."""

    def __init__(self, devices):
        devices = [devices] if isinstance(devices, torch.device) \
            else list(devices)
        self.cuda = sorted({d for d in devices if d.type == "cuda"},
                           key=str)
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, phase: str, split: dict[str, float] | None = None) -> None:
        """Book the time since the last mark under ``phase``; ``split``
        ({phase: seconds}) books that much of it under other phases."""
        for dev in self.cuda:
            torch.cuda.synchronize(dev)
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


def on_device(device: torch.device):
    """``device`` made current for what the block queues (its events,
    streams and kernels), on a CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Timer:
    """A shard's scan time: CUDA events recorded at its chunk boundaries
    on its device's current stream (read once the pipeline is drained),
    or the host's clock on the CPU, where the step loop runs
    synchronously."""

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
    """One chunk's reused buffers of a shard: W0 and cw0 on its device
    and, on a CUDA device, the pinned host buffer its W_T comes back
    through."""

    def __init__(self, rows: int, d: int, Ie: int | None, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.W0 = torch.empty((rows, d), **f32)
        self.cw0 = None if Ie is None else torch.empty((rows, Ie), **f32)
        self.W_host = (torch.empty((rows, d), dtype=torch.float32,
                                   pin_memory=True)
                       if device.type == "cuda" else None)


class _Shard:
    """One entry of the mesh: its device, its two slots, its copy stream
    and its timer."""

    def __init__(self, device, rows: int, d: int, Ie: int | None,
                 n_slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        with on_device(device):
            self.slots = [_Slot(rows, d, Ie, device) for _ in range(n_slots)]
            self.copy_stream = torch.cuda.Stream(device) if self.cuda \
                else None
        self.timer = _Timer(self.cuda)


def scan_seconds(shards: list[_Shard]) -> float:
    """The scan's time: each device's shards queue one after the other,
    the devices run side by side, so the longest device's sum."""
    per_device: dict = {}
    for sh in shards:
        per_device[sh.device] = per_device.get(sh.device, 0.0) \
            + sh.timer.seconds()
    return max(per_device.values(), default=0.0)


def run_chunks(plan, *, B: int, T: int, d: int, devices, operands,
               stat_np, xs_np, impl: str, clock: PhaseClock, pid_np=None,
               telemetry: bool = False):
    """Drive the step core over the batch.  ``devices`` lists the
    shards' devices (one entry: unsplit; ``plan.n_devices`` of them);
    ``operands`` maps each distinct device to its chunk-invariant
    operands {"A", "y", "com", "noise"}: A and y are, on the gram plane,
    {"rows", "G"}; fused, the extended rows; stream and shared, the
    data rows; or, when trials do not share a problem, every problem's
    data rows (P, n_data, d) and targets (P, n_data), which each shard
    gathers by its slice of ``pid_np`` (B,).  ``xs_np`` is None under
    the device control plane.  Returns (W (B, d) f64, losses (T, B)
    f64, det (T, B) bool, counters {key: (B,) int64} or None, trace) as
    numpy arrays, where trace is the device plane's {"q": (T, B) f32,
    "check": (T, B) bool, "faulty2": (T, B, n) bool}, or None under
    host control; the scan's time goes to ``clock`` as "scan", the rest
    of the pipeline's as "post_scan"."""
    devices = [torch.device(dv) for dv in devices]
    ndev = len(devices)
    chunk_trials = plan.chunk_trials
    fused = plan.fused
    gram = plan.data_plane == "gram"
    shared = plan.shared_problem
    device_ctl = plan.control == "device"
    first = operands[devices[0]]
    Ie = None
    if gram:
        Ie = first["A"]["rows"].shape[0]
    elif fused:
        Ie = first["A"].shape[0]
    flags = dict(fused=fused, gram=gram)
    ins = shard.in_specs(plan, stat_sig=shard.signature(stat_np),
                         xs_sig=shard.signature(xs_np),
                         com_sig=shard.signature(first["com"]))
    outs = shard.out_specs(plan)
    rows = min(chunk_trials, B)
    rows += (-rows) % ndev
    n_chunks = -(-B // chunk_trials)
    shards = [_Shard(dv, rows // ndev, d, Ie, min(2, n_chunks))
              for dv in devices]

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
    small_names = ["losses", "det"] + (["q", "check", "faulty2"]
                                       if device_ctl else [])
    dest = dict(losses=losses, det=det, **(trace or {}))

    def stage(sh: _Shard, slot: _Slot, lo: int, hi: int, per: int):
        """The shard's per-trial operands on its device: the trials
        [lo, hi), padded to ``per``."""
        with obtrace.span("pipeline.stage", lo=lo, hi=hi):
            dev = sh.device
            op = operands[dev]
            stat_c = shard.take(stat_np, ins[4], lo, hi, per, PAD_FILL)
            W0 = slot.W0[:per].zero_()
            cw0 = None if Ie is None else slot.cw0[:per].zero_()
            A_c, y_c, pid_c = op["A"], op["y"], None
            if not (fused or gram):
                pid_c = upload(shard.take(pid_np, ins[8], lo, hi, per)
                               .astype(np.int64), dev)
                if not shared:
                    A_c, y_c = A_c[pid_c], y_c[pid_c]
            if device_ctl:
                args = (A_c, y_c, W0, cw0, upload(stat_c, dev), op["com"],
                        op["noise"], pid_c)
                return args, None
            xs_c = shard.take(xs_np, ins[5], lo, hi, per, PAD_FILL)
            args = (A_c, y_c, W0, cw0, upload(stat_c, dev),
                    upload(xs_c, dev), op["com"], op["noise"], pid_c)
            return args, carry.gates_from_xs(xs_c)

    def dispatch(sh: _Shard, slot: _Slot, lo: int, hi: int, args, gates):
        """Queue the shard's scan, W_T and, on a CUDA device, its copies
        to the host; returns what the drain needs."""
        bs = hi - lo
        with obtrace.span("pipeline.dispatch", lo=lo, hi=hi):
            sh.timer.start()
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
            sh.timer.stop()
            A_c, W0 = args[0], args[2]
            Wc = stepcore.finish(A_c, W0, out[0], **flags)[:bs]
            # losses, det, the trace and the counters keep their padding
            # columns until the drain
            if telemetry:
                small.append(torch.stack([out[-1][k] for k in TEL_KEYS]))
            if not sh.cuda:
                return None, Wc, small
            done = torch.cuda.Event()
            done.record()
            with torch.cuda.stream(sh.copy_stream):
                sh.copy_stream.wait_event(done)
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
                t.record_stream(sh.copy_stream)
            return copied, W_host, small_host

    def drain(lo: int, hi: int, copied, W_host, small_host):
        """Wait for the shard's copies alone; write its trials' rows."""
        with obtrace.span("pipeline.drain", lo=lo, hi=hi):
            if copied is not None:
                copied.synchronize()
            widen_into(W[lo:hi], W_host)
            for name, h in zip(small_names, small_host):
                shard.put(dest[name], outs[name], lo, h.numpy())
            if telemetry:
                tel = small_host[-1].numpy()
                for i, k in enumerate(TEL_KEYS):
                    shard.put(counts[k], outs[k], lo, tel[i])

    inflight: list = []
    for c, lo in enumerate(range(0, B, chunk_trials)):
        hi = min(lo + chunk_trials, B)
        per = -(-(hi - lo) // ndev)        # the padded chunk / ndev
        queued = []
        for s, sh in enumerate(shards):
            s_lo = lo + s * per
            s_hi = min(s_lo + per, hi)
            if s_lo >= s_hi:               # padding alone: nothing to run
                continue
            slot = sh.slots[c % len(sh.slots)]
            with on_device(sh.device):
                args, gates = stage(sh, slot, s_lo, s_hi, per)
                queued.append((s_lo, s_hi,
                               *dispatch(sh, slot, s_lo, s_hi, args, gates)))
        for item in inflight:
            drain(*item)
        inflight = queued
    for item in inflight:
        drain(*item)
    clock.mark("post_scan", split={"scan": scan_seconds(shards)})
    return W, losses, det, counts, trace
