"""Carry the engine's host operands across to the device.

The control plane and the problem staging produce numpy arrays — the
port's and the reference's alike, in the same layout.  These functions
turn them into the port's tensors on a given device, with the dtypes the
step core computes in.  The engine stages through them, and the tests
use them to drive the port's step core with exactly the reference's
operands.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rngstream
from repro_torch.core.engineplan.plan import is_adaptive

# schedule array -> dtype the step core reads it in (as engine_jax.py
# stages its scan xs)
XS_DTYPES = {
    "live": np.bool_, "checks": np.bool_, "vote1": np.bool_,
    "identify": np.bool_, "m1": np.int32, "shard1": np.int32,
    "group1": np.int32, "aggw": np.float32, "tam1": np.bool_,
    "m2": np.int32, "shard2": np.int32, "group2": np.int32,
    "tam2": np.bool_, "active": np.bool_,
}

# the schedule gates the step loop branches on, kept on the host
GATE_KEYS = ("vote1", "identify")


def xs_from_schedule(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``Schedule.arrays`` (T, B, ...) -> the step core's numpy xs dict."""
    return {k: np.asarray(arrays[k]).astype(dt) for k, dt in XS_DTYPES.items()}


# the device control plane's q codes (engine_jax.py:388-391)
QCODES = {"none": 0, "deterministic": 1, "randomized": 2}
QCODE_ADAPTIVE = 3


def device_statics(specs, n_max: int) -> dict[str, np.ndarray]:
    """The device control plane's per-trial statics (``engine_jax.py:
    373-401``): "p", "qfix" (f32); "qcode" (0 none, 1 deterministic,
    2 randomized, 3 adaptive), "f0", "onset", "steps" (int32); "byz",
    "act0" (B, n_max) bool; and the six stream key words "dk0", "dk1",
    "tk0", "tk1", "pk0", "pk1" (``rngstream.key_for`` of the DECIDE,
    TAMPER and PERM tags) as int64."""
    B = len(specs)
    byz = np.zeros((B, n_max), bool)
    act0 = np.zeros((B, n_max), bool)
    keys = {k: np.zeros(B, np.int64)
            for k in ("dk0", "dk1", "tk0", "tk1", "pk0", "pk1")}
    for b, s in enumerate(specs):
        act0[b, :s.n] = True
        byz[b, list(s.byz)] = True
        for pre, tag in (("d", rngstream.DECIDE), ("t", rngstream.TAMPER),
                         ("p", rngstream.PERM)):
            k0, k1 = rngstream.key_for(s.seed, tag)
            keys[pre + "k0"][b] = k0
            keys[pre + "k1"][b] = k1
    return dict(
        p=np.array([s.p_tamper for s in specs], np.float32),
        qfix=np.array([0.0 if s.q is None else float(s.q) for s in specs],
                      np.float32),
        qcode=np.array([QCODE_ADAPTIVE if is_adaptive(s) else QCODES[s.mode]
                        for s in specs], np.int32),
        f0=np.array([s.f for s in specs], np.int32),
        onset=np.array([s.onset for s in specs], np.int32),
        steps=np.array([s.steps for s in specs], np.int32),
        byz=byz, act0=act0, **keys)


def to_device(tree, device):
    """numpy arrays (or a dict of them; None passes) -> tensors on
    ``device``, dtypes kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def gates_from_xs(xs_np: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The host (T, B) gate arrays the step loop branches on without
    reading the device."""
    return {k: xs_np[k] for k in GATE_KEYS}


def extended_rows(problem_rows, noisevec: np.ndarray) -> np.ndarray:
    """The extended data matrix (P*n_data + 2, d) f32: every distinct
    problem's data rows stacked in problem-index order, a ones row and
    the noise row, so the affine attacks' bias terms ride along as two
    extra coefficient columns (``engine_jax.py:437-442``)."""
    n_data, d = problem_rows[0].shape
    rows = np.empty((len(problem_rows) * n_data + 2, d), np.float32)
    for p, A in enumerate(problem_rows):
        rows[p * n_data:(p + 1) * n_data] = A
    rows[-2] = 1.0
    rows[-1] = noisevec
    return rows


def problem_operands(rows_np: np.ndarray, y_np: np.ndarray, device):
    """The extended rows (Ie, d), or a chunk's per-trial data rows
    (B, n_data, d), and y (n_data,) or (B, n_data) -> f32 tensors on
    ``device``: the step core's operands as the tests hand them over
    from the reference (the engine keeps its problems on the device)."""
    rows = to_device(np.asarray(rows_np, np.float32), device)
    y = to_device(np.asarray(y_np, np.float32), device)
    return rows, y


def sketch_tables(sk_rows, n_data: int, device,
                  n_problems: int | None = None) -> dict[str, torch.Tensor]:
    """(T, P*n_data + 2, k) per-step sketch tables of the extended rows
    (numpy or a tensor) -> the step core's {"SA", "sk_one": (T, k),
    "sk_noise": (T, k)} on ``device``.  "SA" is (T, n_data, k) for the
    one shared problem (``n_problems`` None), else (T, P, n_data, k),
    which the stream plane gathers per trial by problem index
    (``engine_jax.py:500``)."""
    sk = sk_rows if isinstance(sk_rows, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(sk_rows, np.float32))
    sk = sk.to(device)
    T, _, k = sk.shape
    SA = sk[:, :(n_problems or 1) * n_data]
    if n_problems is not None:
        SA = SA.reshape(T, n_problems, n_data, k)
    return {"SA": SA, "sk_one": sk[:, -2], "sk_noise": sk[:, -1]}
