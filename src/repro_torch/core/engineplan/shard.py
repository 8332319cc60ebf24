"""Split the scenario engine's trial batch over the devices of a trials
mesh.

Port of ``repro.core.engineplan.shard``.  Trials are embarrassingly
parallel (the step loop touches one trial's row everywhere), so the
reference runs the same jitted step core on every device's slice of the
batch under ``shard_map`` over a 1-D ``("trials",)`` mesh, with no
collective inside it.  Here a shard is a slice of a chunk's trials that
the step core runs on its own device, all shards dispatched from the
one host thread (``engineplan.pipeline.run_chunks``); the kernels run on
the device of their operands (``kernels._build.on_operand_device``), so
they need no rule of their own either, which is what the reference's
``kernels/ops.py`` ``_shard_batched`` does for a Pallas op under an
ambient mesh.

``in_specs`` is the reference's one in-spec table (``shard.py:40-75``)
over the step core's argument layout (A, y, W0, cw0, stat, xs, com,
noisevec, pid), and ``out_specs`` its out-spec table; a spec is a
``sharding.trial_partition_spec`` tuple (or a dict of them, or None for
an unused slot).  The one difference is A and y when trials do not
share a problem: the reference shards the gathered (B, n_data, d)
stack, the port replicates every problem's (P, n_data, d) rows and
gathers each shard's trials from them by its slice of ``pid`` on the
device.  ``take`` cuts a host operand's shard by its spec, ``put``
writes a shard's output into the assembled batch.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.telemetry import TEL_KEYS
from repro_torch.sharding import trial_partition_spec as ts


def trial_axis(spec) -> int | None:
    """The axis a spec shards over ``"trials"`` (None: replicated)."""
    return None if spec is None or "trials" not in spec \
        else spec.index("trials")


def in_specs(plan, *, stat_sig: tuple, xs_sig: tuple | None,
             com_sig: tuple) -> tuple:
    """The step core's in-specs: ``stat_sig``, ``xs_sig`` (None under
    the device control plane) and ``com_sig`` are (key, ndim) pairs of
    the statics, the schedule and the chunk-invariant tables.  The rows,
    G, the sketch tables, ``com``, A and y, and ``noisevec`` replicate;
    W0, cw0, the statics and ``pid`` split on axis 0, the schedule
    (T, B, ...) on axis 1."""
    gram = plan.data_plane == "gram"
    coeff = plan.fused or gram   # coefficient-plane carry: cw0 shards
    if gram:
        a_spec, y_spec = {"rows": ts(2, None), "G": ts(2, None)}, ts(1, None)
    elif plan.fused:
        a_spec, y_spec = ts(2, None), ts(1, None)
    else:
        shared = plan.shared_problem
        a_spec = ts(2 if shared else 3, None)
        y_spec = ts(1 if shared else 2, None)
    return (
        a_spec,
        y_spec,
        ts(2, 0),                                          # W0
        ts(2, 0) if coeff else None,                       # cw0
        {k: ts(nd, 0) for k, nd in stat_sig},              # stat
        None if xs_sig is None else
        {k: ts(nd, 1) for k, nd in xs_sig},                # xs (T, B, ..)
        {k: ts(nd, None) for k, nd in com_sig},            # replicated
        None if coeff else ts(1, None),                    # noisevec
        None if coeff else ts(1, 0),                       # pid
    )


def out_specs(plan) -> dict:
    """The step loop's outputs by name: W (B, d) on axis 0; the (T, B)
    losses and detect flags, the device plane's trace (q, check,
    faulty2 (T, B, n)) on axis 1; the (B,) telemetry counters on
    axis 0.  Nothing is reduced across shards."""
    out = {"W": ts(2, 0), "losses": ts(2, 1), "det": ts(2, 1)}
    if plan.control == "device":
        out.update(q=ts(2, 1), check=ts(2, 1), faulty2=ts(3, 1))
    if plan.telemetry:
        out.update({k: ts(1, 0) for k in TEL_KEYS})
    return out


def signature(tree) -> tuple | None:
    """(key, ndim) pairs of a dict of arrays (None passes)."""
    if tree is None:
        return None
    return tuple((k, np.ndim(v)) for k, v in tree.items())


def take(tree, spec, lo: int, hi: int, rows: int, fill=None):
    """The trials [lo, hi) of a host operand (a numpy array or a dict of
    them) along its spec's trial axis, padded to ``rows`` trials with
    inert ones (``fill``: {key: pad value}, else 0); a replicated
    operand passes whole."""
    if isinstance(spec, dict):
        fill = fill or {}
        return {k: take(tree[k], s, lo, hi, rows, fill.get(k, 0))
                for k, s in spec.items()}
    axis = trial_axis(spec)
    if axis is None:
        return tree
    part = np.take(tree, np.arange(lo, hi), axis=axis)
    if hi - lo == rows:
        return part
    widths = [(0, 0)] * part.ndim
    widths[axis] = (0, rows - (hi - lo))
    return np.pad(part, widths, constant_values=fill or 0)


def put(dst: np.ndarray, spec, lo: int, src: np.ndarray) -> None:
    """Write a shard's output ``src`` (its padding included) into the
    batch's ``dst`` at trial ``lo`` along the spec's trial axis; the
    padding is sliced off."""
    axis = trial_axis(spec)
    n = min(src.shape[axis], dst.shape[axis] - lo)
    idx = [slice(None)] * dst.ndim
    idx[axis] = slice(lo, lo + n)
    sidx = [slice(None)] * src.ndim
    sidx[axis] = slice(0, n)
    dst[tuple(idx)] = src[tuple(sidx)]
