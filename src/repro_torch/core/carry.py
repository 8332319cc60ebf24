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


def problem_operands(rows_np: np.ndarray, y_np: np.ndarray, device):
    """The extended rows (Ie, d) and y (n_data,) -> f32 tensors on
    ``device`` (the per-trial stat dict goes through ``to_device``)."""
    rows = to_device(np.asarray(rows_np, np.float32), device)
    y = to_device(np.asarray(y_np, np.float32), device)
    return rows, y


def sketch_tables(sk_rows, n_data: int, device) -> dict[str, torch.Tensor]:
    """(T, Ie, k) per-step sketch tables of the extended rows (numpy or a
    tensor) -> the step core's {"SA": (T, n_data, k), "sk_one": (T, k),
    "sk_noise": (T, k)} on ``device``."""
    sk = sk_rows if isinstance(sk_rows, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(sk_rows, np.float32))
    sk = sk.to(device)
    return {"SA": sk[:, :n_data], "sk_one": sk[:, n_data],
            "sk_noise": sk[:, n_data + 1]}
