"""The rank layer: the BFT workers as ranks of a ``torch.distributed``
process group over the mesh's ``data`` axis, each worker split over the
``model`` axis.

The reference runs each worker as one device of the ``data`` axis and
combines them with ``psum`` and ``all_gather`` inside a ``shard_map``
(``repro.train.steps``).  Here rank r of W holds the contiguous block
of n/W workers ``[r n/W, (r+1) n/W)`` (W = n is the reference's layout
exactly) and runs them in order; the steps (``train.steps``) combine
the ranks with the two collectives of this module:

  all_reduce_sum   f32 sum over the group, in place (the reference's
                   psum of the weighted gradients and the loss);
  all_gather_rows  each rank's rows of its workers -> (n, ...) in
                   worker order (the reference's all_gather of the
                   sketches and of every leaf).

The parameters are replicated over ``data``: every rank builds the
same ones and applies the same update from the same gathered or reduced
bits, so they stay equal with no broadcast; ``Ranks.agree`` checks it
by an all-gather of a per-leaf checksum over ``data`` (the ranks of one
``model`` coordinate hold the same shards).

With a ``model`` axis above 1 (``launch.mesh.make_worker_mesh(W,
model)``, global rank d * model + m) a BFT worker is a group of
``model`` ranks, each holding its shard of every leaf
(``sharding.tree_shardings`` under ``tp_only_rules``); ``Ranks.model``
is that axis (``ModelAxis``), which the model code reads as the
ambient mesh (``sharding.set_mesh``) for its collectives:

  all_reduce_sum   row-parallel outputs, partial gradients and sketches;
  all_reduce_max   the vote's relative differences, the CE's row max;
  all_gather_rows  the router's logits, kv columns.

The plain steps (``train.pjit_step``) run on a ``StepMesh`` instead: a
rank of a (``pod``,) ``data``, ``model`` mesh with every axis's
collectives, ``DataAxis`` for the batch axes (FSDP over ``data``: the
all-gather of a leaf's d_model dim and the reduce-scatter of its
gradient, both in rank order) and ``ModelAxis`` for ``model``.

Backends are named at init (``init``): ``nccl`` for one rank per card,
``gloo`` on the CPU.  Two ranks sharing one card run gloo on CUDA
tensors; PyTorch's backend table lists only ``broadcast`` and
``all_reduce`` for gloo on CUDA, so that form stages every operand
through host memory.  The route is chosen once, from the backend and
the device (``Ranks.staged``), and counted (``counts``).  The process
group's timeout is finite, so a collective that a failed rank never
joins ends the run instead of hanging it.
"""
from __future__ import annotations

import copy
import datetime

import torch
import torch.distributed as dist

from repro_torch.core import tree
from repro_torch.kernels import _account

TIMEOUT_S = 900
BACKENDS = ("nccl", "gloo")

# the same collective (c10d ``_allgather_base_``) under its current name
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def rank_device(backend: str, device: str, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or card ``local_rank`` mod the visible
    cards.  NCCL takes one card a rank and refuses two on one card, so
    it raises when the ranks outnumber the cards; gloo ranks may share
    one."""
    if torch.device(device).type == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU; the CPU "
                             f"runs gloo")
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is visible; pass device 'cpu' "
                           "to run the ranks on the CPU under gloo")
    if backend == "nccl" and local_rank >= cards:
        raise ValueError(f"NCCL rank {local_rank} with {cards} visible "
                         f"card(s): NCCL takes one card a rank; run gloo "
                         f"to share a card")
    return torch.device("cuda", local_rank % cards)


def init(backend: str, rank: int, world_size: int, *,
         init_method: str = "env://", timeout_s: float = TIMEOUT_S,
         device: torch.device | None = None) -> None:
    """``init_process_group`` with a named backend and a finite timeout;
    a CUDA ``device`` becomes the current one first (NCCL's)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch build has no NCCL")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _words(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers of its element size, flat."""
    kind = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.detach().contiguous().reshape(-1).view(kind)


def checksums(*trees, chunk: int = 1 << 24) -> torch.Tensor:
    """(leaves, 2) int64 on the leaves' device: per leaf the sum of its
    bit words and their sum weighted by (position mod 65521) + 1 (both
    modulo 2^64).  One ulp changed in one element changes the first."""
    leaves = [t for tr in trees for t in tree.leaves(tr)]
    out = torch.zeros((len(leaves), 2), dtype=torch.int64,
                      device=leaves[0].device if leaves else "cpu")
    for i, t in enumerate(leaves):
        words = _words(t)
        for s in range(0, words.numel(), chunk):
            w = words[s:s + chunk].to(torch.int64)
            pos = torch.arange(s, s + w.numel(), device=w.device) % 65521 + 1
            out[i, 0] += w.sum()
            out[i, 1] += (w * pos).sum()
    return out


class Ranks:
    """This process's place on one mesh axis (``axis``, ``data`` by
    default): its rank, the group's size W, its device and its
    collectives.  ``counts`` holds the calls of each collective, their
    result bytes, and the bytes staged through host memory.  ``model``
    is the worker's ``model`` axis (a ``ModelAxis``), None when it is
    1."""

    axis = "data"

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.device = torch.device(device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.counts = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0,
                       "bytes": 0, "staged_bytes": 0}
        self.disagree: torch.Tensor | None = None
        self.model: ModelAxis | None = None
        self.mesh = None

    @classmethod
    def of(cls, mesh, device) -> "Ranks":
        """The ``data`` axis of a ``launch.mesh.make_worker_mesh``, with
        its ``model`` axis when that is above 1."""
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out = cls(mesh.get_group("data"), device)
        out.mesh = mesh
        if sizes.get("model", 1) > 1:
            out.model = ModelAxis(mesh.get_group("model"), device)
        return out

    def block(self, n: int) -> range:
        """This rank's workers: n/W of them, contiguous."""
        if n % self.world:
            raise ValueError(f"{self.world} ranks do not divide n = {n} "
                             f"workers")
        b = n // self.world
        return range(self.rank * b, (self.rank + 1) * b)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.counts["bytes"] += t.numel() * t.element_size()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns it."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Max of ``t`` over the group, in place; returns it."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self._count("all_reduce", t)
        with _account.collective(self.axis, self.world):
            if self.staged:
                with _account.staging():
                    host = t.cpu()
                self.counts["staged_bytes"] += 2 * host.numel() * \
                    host.element_size()
                dist.all_reduce(host, op=op, group=self.group)
                with _account.staging():
                    t.copy_(host)
            else:
                dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(b, ...) rows of this rank's workers -> (W b, ...) on every
        rank, rank r's rows at [r b, (r+1) b)."""
        shape = (self.world * rows.shape[0],) + tuple(rows.shape[1:])
        with _account.collective(self.axis, self.world):
            if self.staged:
                with _account.staging():
                    src = rows.contiguous().cpu()
                out = torch.empty(shape, dtype=rows.dtype)
                _all_gather_into(out, src, group=self.group)
                self._count("all_gather", out)
                self.counts["staged_bytes"] += (src.numel() + out.numel()) \
                    * src.element_size()
                with _account.staging():
                    return out.to(self.device)
            out = rows.new_empty(shape)
            _all_gather_into(out, rows.contiguous(), group=self.group)
        self._count("all_gather", out)
        return out

    def gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        rows = self.all_gather_rows(t.movedim(dim, 0).contiguous())
        parts = rows.reshape((self.world, t.shape[dim]) + tuple(
            rows.shape[1:]))
        return parts.reshape((-1,) + tuple(parts.shape[2:])).movedim(0, dim)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def world_barrier(self) -> None:
        """A barrier over every rank of the process group (both axes)."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def agree(self, *trees) -> bool:
        """True when every rank holds the same bits in every leaf of
        ``trees``: an all-gather of ``checksums``; the (W, leaves) table
        of leaves that differ from rank 0's is kept in ``disagree``."""
        local = checksums(*trees).to(self.device)
        table = self.all_gather_rows(local[None]).cpu()
        self.disagree = (table != table[0]).any(dim=-1)
        return not bool(self.disagree.any())


class ModelAxis(Ranks):
    """A worker's ``model`` axis: its ranks hold one shard each of every
    leaf.  It is the ambient mesh of the model code (``sharding.set_mesh``):
    ``shape`` is {"model": size} and ``rank`` this rank's coordinate."""

    axis = "model"

    @property
    def shape(self) -> dict[str, int]:
        return {"model": self.world}


class DataAxis(Ranks):
    """A batch axis of the plain steps: ``data``, whose ranks hold one
    FSDP shard each of every leaf's d_model dim, or ``pod`` (pure data
    parallelism).  Beside ``Ranks``' collectives:

      reduce_scatter_sum  this rank's slice of the sum of every rank's
                          tensor, in f32, added in rank order (an
                          all-to-all of the slices, then the sums), so
                          it has the same bits on any backend and run;
      all_reduce_ordered  the sum in f32 in rank order, the same bits on
                          every rank (``reduce_scatter_sum``, then an
                          all-gather of the summed slices).
    """

    def __init__(self, group, device, axis: str = "data"):
        super().__init__(group, device)
        self.axis = axis

    def _all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """(W, ...) with slice j for rank j -> (W, ...) with rank i's
        slice for this rank at i."""
        with _account.collective(self.axis, self.world):
            if self.staged:
                with _account.staging():
                    src = send.cpu()
                out = torch.empty_like(src)
                dist.all_to_all_single(out, src, group=self.group)
                self.counts["staged_bytes"] += 2 * _nbytes(src)
                with _account.staging():
                    out = out.to(self.device)
            else:
                out = torch.empty_like(send)
                dist.all_to_all_single(out, send, group=self.group)
        self._count("all_to_all", out)
        return out

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the ranks of ``t``, this rank's 1/W slice along
        ``dim``, in f32: each rank's slice summed in rank order."""
        W = self.world
        n = t.shape[dim] // W
        if n * W != t.shape[dim]:
            raise ValueError(f"{W} ranks do not divide dim {dim} of "
                             f"{tuple(t.shape)}")
        moved = t.movedim(dim, 0)
        send = moved.reshape((W, n) + tuple(moved.shape[1:])).to(
            torch.float32).contiguous()
        parts = self._all_to_all(send)
        out = parts[0]
        for i in range(1, W):
            out = out + parts[i]
        return out.movedim(0, dim)

    def all_reduce_ordered(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` in f32, added in rank order and
        the same bits on every rank; a new tensor of ``t``'s dtype."""
        flat = t.reshape(-1).to(torch.float32)
        pad = -flat.numel() % self.world
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = self.reduce_scatter_sum(flat, 0)
        full = self.all_gather_rows(part)[:t.numel()]
        return full.reshape(t.shape).to(t.dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMesh:
    """A rank's place on the plain steps' mesh (``pod``, ``data``,
    ``model``; ``launch.mesh.make_step_mesh``): the ambient mesh of the
    model code under ``pjit_step`` (``sharding.set_mesh``).  ``shape``
    holds every axis's size and ``axes`` the collectives of each axis
    above 1 (``ModelAxis`` for ``model``, ``DataAxis`` for ``data`` and
    ``pod``); ``sharding.axis_of`` reads them.  The batch is split over
    ``batch_axes``, rank ``pod * data_size + data`` holding the
    ``batch_index``-th of ``batch_parts`` blocks of rows: every batch
    axis above 1 (``sharding.BATCH_AXES``), or, on the view of a given
    global batch (``for_batch``), the axes the reference's ``spec_for``
    keeps for it (a batch of 1 is replicated over them all, as
    ``long_500k``'s is).  ``placements`` is each parameter leaf's
    ``sharding.Placement`` on this rank (the optimizer's norm reads
    them)."""

    def __init__(self, mesh, device):
        from repro_torch.sharding import BATCH_AXES, mesh_coordinate

        self.mesh = mesh
        self.device = torch.device(device)
        self.shape = {n: int(s) for n, s in zip(mesh.mesh_dim_names,
                                                mesh.shape)}
        self.coords = mesh_coordinate(mesh)
        self.axes: dict[str, Ranks] = {}
        for name, size in self.shape.items():
            if size > 1:
                group = mesh.get_group(name)
                self.axes[name] = ModelAxis(group, device) \
                    if name == "model" else DataAxis(group, device, name)
        self.model = self.axes.get("model")
        self._split_batch(tuple(a for a in BATCH_AXES if a in self.axes))
        self.placements = None

    def _split_batch(self, axes: tuple) -> None:
        self.batch_axes = axes
        self.batch_parts, self.batch_index = 1, 0
        for a in axes:
            size = self.shape[a]
            self.batch_parts *= size
            self.batch_index = self.batch_index * size + self.coords.get(a, 0)

    def batch_split(self, batch: int) -> tuple:
        """The batch axes above 1 that split a global batch of ``batch``
        rows: the reference's ``spec_for(("batch",), ...)`` under
        ``ACT_RULES``, which drops an axis that does not divide it."""
        from repro_torch.sharding import ACT_RULES, spec_for

        entry = spec_for(("batch",), self, (batch,), ACT_RULES)[0]
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        return tuple(a for a in names if a in self.axes)

    def for_batch(self, batch: int) -> "StepMesh":
        """This mesh as the steps see a global batch of ``batch`` rows:
        the same axes and collectives, the batch split over
        ``batch_split(batch)`` only (replicated over the others, every
        rank of them holding the same rows)."""
        view = copy.copy(self)
        view._split_batch(self.batch_split(batch))
        return view

    @property
    def batch_whole(self) -> bool:
        """Whether the batch is split over every batch axis above 1 (a
        train step's gradients are summed over them)."""
        from repro_torch.sharding import BATCH_AXES

        return self.batch_axes == tuple(a for a in BATCH_AXES
                                        if a in self.axes)

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def local_rows(self, x):
        """This rank's block of rows of a global-batch tensor (dim 0),
        over ``batch_axes``; a batch that splits otherwise (the
        reference's ``spec_for`` drops an axis that does not divide it)
        raises: the steps take that batch on ``for_batch(B)``."""
        x = torch.as_tensor(x)
        if self.batch_split(x.shape[0]) != self.batch_axes:
            raise ValueError(
                f"a batch of {x.shape[0]} rows splits over "
                f"{self.batch_split(x.shape[0])}, not {self.batch_axes}: "
                f"take it on mesh.for_batch({x.shape[0]})")
        n = x.shape[0] // self.batch_parts
        return x[self.batch_index * n:(self.batch_index + 1) * n]

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axes that split the batch (``data``,
        then ``pod``), in f32, in rank order; the same bits on every
        rank."""
        for a in ("data", "pod"):
            if a in self.batch_axes:
                t = self.axes[a].all_reduce_ordered(t)
        return t

    def batch_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in global batch order (a replicated batch
        counted once)."""
        for a in ("data", "pod"):
            if a in self.batch_axes:
                rows = self.axes[a].all_gather_rows(rows)
        return rows

    def full_logits(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """Local logits (rows, V / model) of a vocab of ``vocab`` -> the
        global (B, V) on every rank: the vocab gathered over ``model``
        where it is split, the rows over the batch axes."""
        if logits.shape[-1] != vocab:
            logits = self.model.gather_dim(logits, -1)
        return self.batch_gather(logits)

    def counts(self) -> dict:
        return {a: dict(ax.counts) for a, ax in self.axes.items()}
