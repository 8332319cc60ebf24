"""Meshes: the trainer's worker mesh and the production shapes.

Port of ``repro.launch.mesh``.  Functions (never module-level
constants), so importing this module touches no process group.

``make_worker_mesh`` is the trainer's: n ranks on the ``data`` axis,
one BFT worker block each, times ``model`` ranks that split each
worker's leaves (``train.ranks``), over the initialized
``torch.distributed`` process group.  The production meshes are
shape-only (``sharding.MeshShape``): no process group spans 256 cards
here; ``sharding.spec_for`` and the dry-run's report name them.
"""
from __future__ import annotations

from repro_torch.sharding import MeshShape, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_worker_mesh(n_ranks: int, model: int = 1, *,
                     device_type: str | None = None):
    """The BFT trainer's ``DeviceMesh``: ``n_ranks`` on ``data`` x
    ``model``, over the initialized process group (whose world size must
    be ``n_ranks * model``); global rank d * model + m sits at (d, m),
    the reference's row-major ``make_mesh((n, model))``.
    ``device_type`` defaults to "cuda" under NCCL and "cpu" otherwise
    (two gloo ranks sharing one card pass "cuda")."""
    return make_step_mesh(n_ranks, model, device_type=device_type)


def make_step_mesh(data: int, model: int = 1, pod: int = 1, *,
                   device_type: str | None = None):
    """The plain steps' ``DeviceMesh`` (``train.pjit_step``): (``pod``,)
    ``data``, ``model``, the reference's production layout at any size,
    over the initialized process group (world ``pod * data * model``);
    global rank (p * data + d) * model + m sits at (p, d, m).  ``pod``
    is left out at 1, as the single-pod mesh has none."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(train.ranks.init)")
    shape, names = (data, model), ("data", "model")
    if pod > 1:
        shape, names = (pod,) + shape, ("pod",) + names
    if dist.get_world_size() != pod * data * model:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh over a "
                         f"world of {dist.get_world_size()} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return make_mesh(shape, names, device_type)


def make_pod_worker_mesh(pods: int = 8, data: int = 4,
                         model: int = 16) -> MeshShape:
    """The production mesh where the BFT worker is one pod: 512 chips as
    8 pods x 64 chips (the pod-granularity dry-run's; ROADMAP item 7b)."""
    return MeshShape(("pod", "data", "model"), (pods, data, model))
