"""Stream the trial batch through the step core in plan-sized chunks.

Port of ``repro.core.engineplan.pipeline.run_chunks`` for one device:
the plan's ``chunk_trials`` bounds how many trials are resident at once,
the last chunk pads up to a device multiple with inert trials
(``PAD_FILL``: live=False, weights 0, idle workers -1, no filter) and
the padding is sliced off the results.  Every chunk starts from W0 = 0;
the fused plane's pending-coefficient carry starts at cw0 = 0 (no update
to apply on the first kernel call: the pipelined prologue), and the
gram plane's S0 = W0 R^T is zero too.  Trials that do not share a
problem upload their chunk's slice of ``pid`` and gather their
(chunk, n_data, d) data rows and targets from the device-resident
per-problem stack by it.
There is no mesh and no buffer donation.  Chunk k+1 is staged and
dispatched before chunk k's results are copied back, so the host's
dispatch of one chunk overlaps the device's work on the other.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.engineplan import stepcore

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

    def mark(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) + now - self._t
        self._t = now


def run_chunks(plan, *, B: int, T: int, d: int, device, A_dev, y_dev,
               com_dev, stat_np, xs_np, impl: str, clock: PhaseClock,
               noise_dev=None, pid_np=None):
    """Drive the step core over the batch.  ``A_dev``/``y_dev`` are the
    chunk-invariant operands (gram: {"rows", "G"}; fused: the extended
    rows; stream, shared: the data rows), or, when trials do not share a
    problem, every problem's data rows (P, n_data, d) and targets
    (P, n_data), which each chunk gathers by its slice of ``pid_np``
    (B,).  Returns (W (B, d) f64,
    losses (T, B) f64, det (T, B) bool) as numpy arrays; the scan and
    post-scan time go to ``clock``."""
    chunk_trials = plan.chunk_trials
    ndev = plan.n_devices
    fused = plan.fused
    gram = plan.data_plane == "gram"
    shared = plan.shared_problem
    if gram:
        Ie = A_dev["rows"].shape[0]
    elif fused:
        Ie = A_dev.shape[0]
    flags = dict(fused=fused, gram=gram)

    def stage(lo: int):
        hi = min(lo + chunk_trials, B)
        bs = hi - lo
        pad = (-bs) % ndev
        stat_c = {k: pad_rows(v[lo:hi], 0, pad, PAD_FILL.get(k, 0))
                  for k, v in stat_np.items()}
        xs_c = {k: pad_rows(v[:, lo:hi], 1, pad, PAD_FILL.get(k, 0))
                for k, v in xs_np.items()}
        gates = carry.gates_from_xs(xs_c)
        W0 = torch.zeros((bs + pad, d), dtype=torch.float32, device=device)
        cw0 = (torch.zeros((bs + pad, Ie), dtype=torch.float32,
                           device=device) if fused or gram else None)
        A_c, y_c, pid_c = A_dev, y_dev, None
        if not (fused or gram):
            pid_c = carry.to_device(pad_rows(pid_np[lo:hi], 0, pad).astype(
                np.int64), device)
            if not shared:
                A_c, y_c = A_dev[pid_c], y_dev[pid_c]
        out = stepcore.scan(
            A_c, y_c, W0, cw0, carry.to_device(stat_c, device),
            carry.to_device(xs_c, device), com_dev, noise_dev, pid_c,
            gates=gates, impl=impl, shared=shared,
            has_filter=plan.has_filter, has_bias=plan.has_bias, **flags)
        return slice(lo, hi), bs, A_c, W0, out

    W = np.empty((B, d), np.float64)
    losses = np.empty((T, B))
    det = np.empty((T, B), bool)

    def drain(sl, bs, A_c, W0, out):
        fin, lc, dc = out
        clock.mark("scan")
        Wc = stepcore.finish(A_c, W0, fin, **flags)
        W[sl] = np.asarray(Wc[:bs].cpu(), np.float64)
        losses[:, sl] = np.asarray(lc[:, :bs].cpu(), np.float64)
        det[:, sl] = dc[:, :bs].cpu().numpy()
        clock.mark("post_scan")

    inflight = None
    for lo in range(0, B, chunk_trials):
        out = stage(lo)
        if inflight is not None:
            drain(*inflight)
        inflight = out
    if inflight is not None:
        drain(*inflight)
    return W, losses, det
