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

Every parameter leaf of the port's models carries the reference's
logical names (``Annotated``, built by ``models.model.annotated_params``);
``tree_specs`` resolves a tree of them to placements, ``tree_shardings``
to each leaf's ``Placement`` on one rank (the dims split over a mesh
axis and the rank's slice of them) and ``tree_structs`` to ``meta``
tensors of the rank's local shard.  The port's trainer runs its workers
as ranks of the ``data`` axis and each worker as ``model`` ranks
(``train.ranks``), with the parameters placed by ``tp_only_rules``:
replicated over ``data``, split over ``model`` by heads, kv, ffn, vocab
and experts.

Inside a worker the model code reads the ambient ``model`` axis: a
``set_mesh`` context installs it (``train.ranks.ModelAxis``: its size,
this rank's coordinate and its collectives), ``ambient_mesh`` reads
it, and ``constrain`` / ``constrain_here``
check that a local activation has the shard shape its logical names
give under ``ACT_RULES``.  The plain steps (``train.pjit_step``) run on
a rank of a (``pod``,) ``data``, ``model`` mesh with the parameters
placed by ``PARAM_RULES`` as they stand (d_model on ``data`` beside
the ``model`` dims, so a leaf may be split on two dims) and install a
``train.ranks.StepMesh``, which holds every axis (``axis_of``); the
batch is split over ``BATCH_AXES`` (those that divide it: a batch of 1
is replicated, ``StepMesh.for_batch``), and the model code passes the
global batch (``batch_rows``) to the checks.  The reference's
``with_sharding_constraint`` places an array; here every rank computes
its shard explicitly, so the
constraint is a check that raises on a wrong shape, and outside a mesh
context ``constrain_here`` is a no-op, as in the reference.

The scenario engine splits its trials over the local cards of one
process (``core.engineplan.shard``): ``trials_mesh`` gives a
``TrialsMesh``, a 1-D ``("trials",)`` mesh that is only a list of
devices, ``trial_partition_spec`` the placement of one operand on it
and ``mesh_num_devices`` its size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or any
    mesh whose ``shape`` is that dict (the ambient model axis)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
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


#: the mesh axes that carry the batch, in the order its shards lie
BATCH_AXES = ("pod", "data")


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
    """Bytes of a tree of tensors (real or ``meta``) or of ``Annotated``
    leaves."""
    total = 0
    for t in _tree.leaves(params):
        if _is_annotated(t):
            import torch

            total += math.prod(t.shape) * torch.empty(
                (), dtype=t.dtype).element_size()
        else:
            total += t.numel() * t.element_size()
    return total


def param_count(params) -> int:
    return sum(math.prod(t.shape) if _is_annotated(t) else t.numel()
               for t in _tree.leaves(params))


# ---------------------------------------------------------------------------
# annotated parameter trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Annotated:
    """A leaf's shape with its logical axes, dtype (a ``torch.dtype``)
    and initializer (normal | ones | zeros | ssm_a | ssm_dt), as the
    reference's parameter trees hold them."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: Any
    init: str = "normal"

    def spec(self, mesh, rules: Mapping[str, Any] | None = None) -> tuple:
        return spec_for(self.logical, mesh, self.shape, rules)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf on one rank: the full ``shape``, the shards of each dim
    (``parts``, from ``spec_for``'s placement), this rank's shard of
    each (``index``) and the mesh axes each dim is split over
    (``axes``).  Under ``PARAM_RULES`` a leaf may be split on two dims:
    d_model over ``data`` (FSDP) and heads, kv, ffn, vocab or experts
    over ``model``; its local block is then 2-d."""

    shape: tuple[int, ...]
    parts: tuple[int, ...]
    index: tuple[int, ...]
    axes: tuple[tuple[str, ...], ...] = ()

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // p for n, p in zip(self.shape, self.parts))

    @property
    def sharded(self) -> bool:
        return any(p > 1 for p in self.parts)

    @property
    def split_dim(self) -> int | None:
        """The one dim split over the mesh (None when replicated); a
        leaf split on two dims raises."""
        dims = [i for i, p in enumerate(self.parts) if p > 1]
        if len(dims) > 1:
            raise ValueError(f"a leaf split on dims {dims}: the port "
                             f"splits at most one dim of a leaf")
        return dims[0] if dims else None

    def dim_on(self, axis: str) -> int | None:
        """The dim split over mesh axis ``axis`` (None when none is)."""
        for i, (p, names) in enumerate(zip(self.parts, self.axes)):
            if p > 1 and axis in names:
                return i
        return None

    @property
    def split_axes(self) -> tuple[str, ...]:
        """The mesh axes the leaf is split over, in dim order."""
        return tuple(a for p, names in zip(self.parts, self.axes)
                     if p > 1 for a in names)

    @property
    def slices(self) -> tuple[slice, ...]:
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(self.index, self.local_shape))

    def take(self, full):
        """This rank's shard of the full leaf (a view)."""
        return full[self.slices] if self.sharded else full


def _is_annotated(x) -> bool:
    return isinstance(x, Annotated)


def _axes(entry) -> tuple:
    """The mesh axes of one entry of a placement."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def tree_specs(annotated_tree, mesh, rules=None):
    """A tree of ``Annotated`` -> the tree of their placements
    (``spec_for`` leaf by leaf, with the divisibility fallback)."""
    return _tree.tree_map(lambda a: a.spec(mesh, rules), annotated_tree)


def mesh_coordinate(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh`` (zeros on
    a ``MeshShape``, which holds no rank)."""
    if hasattr(mesh, "coords"):           # a train.ranks.StepMesh
        return dict(mesh.coords)
    names = tuple(mesh.axis_names if isinstance(mesh, MeshShape)
                  else mesh.mesh_dim_names)
    if isinstance(mesh, MeshShape):
        return {n: 0 for n in names}
    return dict(zip(names, mesh.get_coordinate()))


def placement_of(a: Annotated, mesh, rules=None,
                 coords: Mapping[str, int] | None = None) -> Placement:
    """``a`` on the rank at ``coords`` (default: this rank of a
    ``DeviceMesh``, the first of a ``MeshShape``).  A dim split over
    several axes is split row-major over them, as JAX does."""
    sizes = mesh_axis_sizes(mesh)
    coords = mesh_coordinate(mesh) if coords is None else dict(coords)
    spec = a.spec(mesh, rules)
    parts, index = [], []
    for entry in spec:
        p, i = 1, 0
        for ax in _axes(entry):
            p, i = p * sizes[ax], i * sizes[ax] + int(coords.get(ax, 0))
        parts.append(p)
        index.append(i)
    return Placement(tuple(a.shape), tuple(parts), tuple(index),
                     tuple(_axes(e) for e in spec))


def tree_shardings(annotated_tree, mesh, rules=None, coords=None):
    """A tree of ``Annotated`` -> each leaf's ``Placement`` on one rank
    of ``mesh``: the dims split over its axes and the rank's slice of
    them (the reference's ``NamedSharding`` tree, for one rank)."""
    return _tree.tree_map(lambda a: placement_of(a, mesh, rules, coords),
                          annotated_tree)


def tree_structs(annotated_tree, mesh=None, rules=None, coords=None):
    """A tree of ``Annotated`` -> ``meta`` tensors of each leaf's shape,
    or of the local shard's shape on one rank of ``mesh`` (a
    ``DeviceMesh`` or a ``MeshShape``)."""
    import torch

    def struct(a: Annotated):
        shape = a.shape if mesh is None else \
            placement_of(a, mesh, rules, coords).local_shape
        return torch.empty(shape, dtype=a.dtype, device="meta")

    return _tree.tree_map(struct, annotated_tree)


# ---------------------------------------------------------------------------
# the ambient model axis
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` as the ambient mesh of the model code inside the
    context (the reference's ``set_mesh``): an object with ``shape``
    ({axis: size}); the trainer passes its ``model`` axis
    (``train.ranks.ModelAxis``).  None installs nothing."""
    if mesh is None:
        yield
        return
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The ambient mesh, or None when no mesh is installed."""
    return _AMBIENT[-1] if _AMBIENT else None


def axis_of(mesh, name: str):
    """The object that runs mesh axis ``name``'s collectives: a step
    mesh's (``train.ranks.StepMesh``, which holds one a named axis) or
    the mesh itself when it is one axis (a ``ModelAxis``); None when the
    mesh has no such axis or no mesh is given."""
    if mesh is None:
        return None
    if hasattr(mesh, "axes"):
        return mesh.axes.get(name)
    return mesh if name in mesh.shape else None


def batch_mesh():
    """The ambient mesh when it splits the batch (a step mesh with a
    ``pod`` or ``data`` axis above 1), else None."""
    mesh = ambient_mesh()
    return mesh if getattr(mesh, "batch_axes", ()) else None


def batch_rows(n: int, mesh=None) -> int:
    """The global batch of ``n`` local rows: ``n`` times the sizes of
    the axes that split the batch of ``mesh`` (default: the ambient
    one): a step mesh's ``batch_axes`` (none where the batch is
    replicated, ``train.ranks.StepMesh.for_batch``), else every batch
    axis (``BATCH_AXES``); the full shape that ``constrain_here`` checks
    a local activation against."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None:
        return n
    if hasattr(mesh, "batch_parts"):
        return n * mesh.batch_parts
    sizes = mesh_axis_sizes(mesh)
    return n * math.prod(sizes.get(a, 1) for a in BATCH_AXES)


def _local_of(full: Sequence[int], spec: tuple, sizes) -> tuple[int, ...]:
    return tuple(n // math.prod(sizes[a] for a in _axes(entry))
                 for n, entry in zip(full, spec))


def constrain(x, mesh, logical: Sequence[str | None],
              full: Sequence[int] | None = None):
    """Check that ``x``, one rank's shard, has the shape ``ACT_RULES``
    give the logical names on ``mesh`` for an activation of shape
    ``full`` (default: ``x``'s own, i.e. a replicated activation);
    returns ``x``.  A dim the mesh does not divide stays whole (the
    divisibility fallback); ``heads_forced`` on a dim the mesh does not
    divide is refused: no rank computes a padded shard (attention keeps
    a rank's real heads, ``models.attention.head_group``)."""
    full = tuple(x.shape) if full is None else tuple(full)
    if len(full) != len(logical):
        raise ValueError(f"{len(logical)} logical names for a "
                         f"{len(full)}-d activation")
    spec = spec_for(logical, mesh, full, ACT_RULES)
    sizes = mesh_axis_sizes(mesh)
    for n, entry, name in zip(full, spec, logical):
        if name in FORCE_SHARD and n % math.prod(sizes[a]
                                                 for a in _axes(entry)):
            raise ValueError(
                f"{name!r} pads a dim of {n} over the mesh: a rank "
                f"holds its real heads, no padded shard (heads_forced)")
    want = _local_of(full, spec, sizes)
    if tuple(x.shape) != want:
        raise ValueError(f"activation {tuple(logical)} of full shape {full}"
                         f": a rank holds {want}, got {tuple(x.shape)}")
    return x


def constrain_here(x, logical: Sequence[str | None],
                   full: Sequence[int] | None = None):
    """``constrain`` on the ambient mesh; a no-op outside one, so model
    code calls it unconditionally."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    return constrain(x, mesh, logical, full)
