"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Port of ``repro.sharding``, in pure Python.  A rule table maps each
*logical* axis name of a parameter or activation (``"embed"``,
``"ffn"``, ...) to one mesh axis or a tuple of them; ``spec_for``
resolves a leaf's logical names to a placement, one entry per
dimension: ``None`` (replicated), a mesh axis, or a tuple of mesh axes,
dropping any mesh axis whose size does not divide the dimension (one
kv-head on a 16-way ``model`` axis degrades to replication instead of
erroring).

A mesh is either a ``torch.distributed`` ``DeviceMesh`` (``make_mesh``,
over an initialized process group) or a ``MeshShape``: axis names and
sizes with no devices, as the production meshes of ``launch.mesh``
are, which ``spec_for`` resolves without a process group.

The port's trainer runs its workers as ranks of the ``data`` axis with
``model`` = 1 (``train.ranks``): the parameters are replicated on every
rank, which ``tp_only_rules`` states.

The scenario engine splits its trials over the local cards of one
process (``core.engineplan.shard``): ``trials_mesh`` gives a
``TrialsMesh``, a 1-D ``("trials",)`` mesh that is only a list of
devices, ``trial_partition_spec`` the placement of one operand on it
and ``mesh_num_devices`` its size.  What of the reference waits:
``Annotated``, ``tree_specs``, ``tree_shardings``, ``constrain`` and
``constrain_here`` for ROADMAP item 7b, which gives the port's
parameter leaves their logical names and a ``model`` axis above 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.core import tree as _tree


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as axis names and sizes only (no devices)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda"):
    """``init_device_mesh`` over the initialized process group: a
    ``DeviceMesh`` of ``axis_shapes`` named ``axis_names``, whose product
    must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class TrialsMesh:
    """The scenario engine's 1-D ``("trials",)`` mesh: the devices its
    trial shards run on, in shard order.  A device may be listed more
    than once (eight times ``cpu``, or ``cuda:0`` twice): each entry is
    a shard of its own, so the split runs on a machine with fewer
    devices than shards."""

    devices: tuple
    axis_names = ("trials",)

    def __post_init__(self):
        import torch

        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a trials mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a trials mesh takes devices of one type, got "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict[str, int]:
        return {"trials": len(self.devices)}


def trials_mesh(max_devices: int | None = None) -> TrialsMesh | None:
    """1-D ``("trials",)`` mesh over the local CUDA devices (at most
    ``max_devices``), the scenario engine's data-parallel axis (trials
    are embarrassingly parallel).  Returns None with one device or
    fewer (a single device is strictly cheaper unsplit).  Sets the gauge
    ``sharding.local_devices`` to the devices it counted."""
    import torch

    from repro_torch.obs import metrics as obmetrics

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max_devices is not None:
        n = min(n, max(1, max_devices))
    obmetrics.gauge("sharding.local_devices").set(n)
    if n <= 1:
        return None
    return TrialsMesh(tuple(f"cuda:{i}" for i in range(n)))


def mesh_num_devices(mesh) -> int:
    """Device count of a trials mesh (its shards): the chunk-rounding
    granularity the plan records as ``n_devices``."""
    n = 1
    for size in mesh.shape.values():
        n *= int(size)
    return n


def trial_partition_spec(ndim: int, axis: int | None) -> tuple:
    """Full-rank placement sharding ``axis`` over the ``"trials"`` mesh
    axis (``None`` = fully replicated), a tuple like ``spec_for``'s.
    Every per-trial operand of the scenario engine's step loop shards on
    its trial axis, so the loop needs no collective."""
    spec: list[Any] = [None] * ndim
    if axis is not None:
        spec[axis] = "trials"
    return tuple(spec)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# Default rule tables (the reference's).
#
# `data`-like mesh axes carry the batch (DP) *and* the FSDP shard of the
# parameters / optimizer state (ZeRO-style); `model` carries TP (heads,
# ffn, vocab) and EP (experts).  On the multi-pod mesh the `pod` axis is an
# extra pure-DP axis: parameters are replicated across pods, gradients are
# reduced over (pod, data).
# ---------------------------------------------------------------------------

#: logical axis -> mesh axis (or tuple of mesh axes) for PARAMETERS.
PARAM_RULES: dict[str, Any] = {
    "embed": "data",          # FSDP shard of the d_model dim
    "embed_no_fsdp": None,    # d_model dim on params too small to FSDP-shard
    "vocab": "model",
    "heads": "model",         # merged H*head_dim (q / o projections)
    "kv": "model",            # merged K*head_dim (k / v projections)
    "ffn": "model",
    "experts": "model",       # expert-parallel axis
    "expert_ffn": None,       # per-expert ffn dim (model axis is taken by E)
    "conv": None,
    "ssm_inner": "model",     # mamba d_inner
    "ssm_state": None,
    "ssm_heads": "model",
    "layers": None,           # stacked-scan leading axis is never sharded
    "norm": None,
}

#: logical axis -> mesh axis for ACTIVATIONS / inputs.
ACT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),  # pod silently dropped on single-pod meshes
    "seq": None,
    "decode_seq": "data",      # KV-cache seq dim for long-context decode (SP)
    "embed": None,
    "heads": "model",
    "heads_forced": "model",   # padded sharding: divisibility NOT required
    "kv": "model",
    "ffn": "model",
    "experts": "model",
    "ssm_inner": "model",
    "vocab": "model",
}

#: logical names that shard even when the dim is not divisible by the mesh
#: axis (the trailing shards are padded): attention heads on architectures
#: whose head count does not divide the TP width.
FORCE_SHARD = {"heads_forced"}


def tp_only_rules() -> dict[str, Any]:
    """The trainer's rules: ``PARAM_RULES`` with ``embed`` replicated, so
    the parameters are replicated over the worker (data) axes and every
    worker holds a full gradient."""
    rules = dict(PARAM_RULES)
    rules["embed"] = None
    return rules


def spec_for(logical_axes: Sequence[str | None], mesh,
             shape: Sequence[int] | None = None,
             rules: Mapping[str, Any] | None = None) -> tuple:
    """Resolve logical axis names to a placement on ``mesh``: a tuple
    with one entry per dimension, ``None``, a mesh axis name or a tuple
    of them.  If ``shape`` is given, any mesh axis whose size does not
    evenly divide the corresponding dimension is dropped (replication
    fallback), except for the names in ``FORCE_SHARD``."""
    rules = PARAM_RULES if rules is None else rules
    sizes = mesh_axis_sizes(mesh)
    out: list[Any] = []
    for i, name in enumerate(logical_axes):
        mesh_axes = None if name is None else rules.get(name, None)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        kept = []
        divisor = 1
        for ax in mesh_axes:
            if ax not in sizes:
                continue  # e.g. "pod" on a single-pod mesh
            n = sizes[ax]
            if (name not in FORCE_SHARD and shape is not None
                    and shape[i] % (divisor * n) != 0):
                continue  # divisibility fallback -> replicate on this axis
            kept.append(ax)
            divisor *= n
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def param_bytes(params) -> int:
    """Bytes of a tree of tensors (real or ``meta``)."""
    return sum(t.numel() * t.element_size() for t in _tree.leaves(params))


def param_count(params) -> int:
    return sum(t.numel() for t in _tree.leaves(params))
