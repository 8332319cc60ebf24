"""Fault-tolerant checkpointing.

Port of ``repro.checkpoint.manager``, with the same directory layout.
Atomicity: a checkpoint is written to ``<dir>/tmp.<step>`` and renamed
to ``<dir>/step_<step>`` only after every array and the manifest have
been written and the manifest fsync'd; a crash mid-write never
corrupts the latest checkpoint.  Restart picks the newest complete step
directory.

Contents: params and optimizer state, one ``.npy`` per leaf addressed
by its tree path (``core.tree``; bfloat16 through its uint16 view, the
manifest keeping the logical dtype), the BFT ``ProtocolState`` (masks,
reliability counts, RNG states: a restart replays the identical check
schedule) and ``extra.json``.  Restored leaves go to the device and
dtype of the caller's templates.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil

import numpy as np
import torch

from repro_torch.core import tree


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array .npy can hold, logical dtype name)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, *, params, opt_state, protocol_state=None,
         extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "arrays": {}}
    for group, t in (("params", params), ("opt_state", opt_state)):
        gdir = os.path.join(tmp, group)
        os.makedirs(gdir, exist_ok=True)
        for key, leaf in tree.leaves_with_paths(t):
            arr, logical = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(gdir, fname), arr)
            manifest["arrays"].setdefault(group, []).append(
                {"key": key, "file": fname, "dtype": logical,
                 "shape": list(arr.shape)})
    if protocol_state is not None:
        with open(os.path.join(tmp, "protocol.pkl"), "wb") as fh:
            pickle.dump(protocol_state.state_dict(), fh)
    with open(os.path.join(tmp, "extra.json"), "w") as fh:
        json.dump(extra or {}, fh)
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _steps(directory: str) -> list[int]:
    return [int(m.group(1)) for d in os.listdir(directory)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory) if os.path.exists(
        os.path.join(directory, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def restore(directory: str, step: int, *, params_template, opt_template,
            protocol_state=None):
    """(params, opt_state, extra) of checkpoint ``step``; the templates
    give each tree's structure and each leaf's device and dtype.
    ``protocol_state`` is loaded in place when given."""
    cdir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(cdir, "manifest.json")) as fh:
        manifest = json.load(fh)

    out = {}
    for group, template in (("params", params_template),
                            ("opt_state", opt_template)):
        flat = {e["key"]: _from_numpy(
            np.load(os.path.join(cdir, group, e["file"])), e["dtype"])
            for e in manifest["arrays"].get(group, [])}
        out[group] = tree.unflatten(template, [
            flat[key].to(device=t.device, dtype=t.dtype)
            for key, t in tree.leaves_with_paths(template)])

    ppath = os.path.join(cdir, "protocol.pkl")
    if protocol_state is not None and os.path.exists(ppath):
        with open(ppath, "rb") as fh:
            protocol_state.load_state_dict(pickle.load(fh))
    with open(os.path.join(cdir, "extra.json")) as fh:
        extra = json.load(fh)
    return out["params"], out["opt_state"], extra


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; save-every-k policy."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, **kw) -> str | None:
        if self.every <= 0 or step % self.every:
            return None
        path = save(self.directory, step, **kw)
        self._gc()
        return path

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
