"""Dry-run of every (arch x shape) cell on one H100: a step traced on
``meta`` tensors, its FLOPs, bytes and peak memory, and its roofline.

Port of ``repro.launch.dryrun``, redesigned for PyTorch.  The reference
lowers and compiles each step with XLA over 512 forced host devices and
reads ``cost_analysis`` and ``memory_analysis``.  Here the step runs
eagerly on ``meta`` tensors (shapes and dtypes, no memory, no numbers)
under ``StepCounter``, a ``TorchDispatchMode`` that counts, per
operator:

  - FLOPs by ``torch.utils.flop_counter``'s formulas (the matrix
    products), split by the input dtype;
  - bytes accessed: input plus output bytes of every operator that
    moves data (views, aliases and empty allocations move none), the
    eager counterpart of XLA's "bytes accessed", without fusion;
  - live bytes: each storage the step creates is held by a weak
    reference from its creation to its release, and their peak (the
    composite backwards that autograd runs in place, but out of place
    under a dispatch mode, run in place here too: ``_IN_PLACE``);
  - a layer checkpointed under ``cfg.remat`` as it runs: its forward
    once in the forward pass and again, up to what the backward needs,
    in the backward (``torch.utils.checkpoint``), and the activations
    it drops in between;
  - the hand-written kernels as themselves: each reports its own FLOPs
    and bytes (``launch.roofline.kernel_cost``), on ``meta`` tensors
    through its shape-only form (``kernels.ops``), which makes none of
    the buffers K6 never makes;
  - the collectives (``torch.distributed``'s c10d operators) by kind,
    their calls and result bytes, priced as the bytes one rank puts on
    the wire (``roofline.ring_bytes`` over the group), which move no
    HBM bytes in the count; the copies that stage a gloo collective's
    operand through host memory on a card are left out (``Ranks.counts``
    holds them), so a staged step counts as an NCCL one.

The BFT steps run on one card (``--mesh single``: every worker in one
process) or as ranks (``--mesh workers``: n ranks on ``data``, one
worker each, ``train.ranks``; ``--mesh tp``: n ranks on ``data`` times
``--model`` ranks splitting each worker; ``--mesh production``: the
reference's 16x16 cell, 16 workers of 16 ``model`` ranks, and its
2x16x16 cell, 32 workers (``pod`` x ``data``) of 16, f = 3, at
``train_4k``): rank 0's step is traced under torch's ``fake`` process
group sized to the mesh's world, whose collectives reach the counter on
``meta`` tensors and move nothing; each collective is priced over its
own axis's group and reported per axis (``collective_by_axis``).  An
arch the model axis cannot split yet (cross-attention, an
encoder-decoder, a misaligned ssm split) is reported as skipped, with
the reason.

The plain cells run on one card (``run_cell``, ``--mesh single``) or,
as the reference lowers them, on its production meshes (``--mesh
production`` without ``--bft``): rank 0 of 16x16 and of 2x16x16 traced
under a ``fake`` process group (``lower_compile(mesh=)``), the plain
steps with FSDP + TP (``train.pjit_step`` on rank 0's blocks and rows,
``specs.input_specs(mesh=)``): per-rank FLOPs, bytes, peak and
``fits_hbm``, the collectives' wire bytes by axis (``data``, ``model``,
``pod``), a roofline over the mesh's 256 or 512 chips, the MFU numerator
at 16x16 only (as the reference gives it).  whisper and the VLM are
skipped with ``require_splittable``'s reason.  ``long_500k`` (the
sub-quadratic archs: mamba2-780m, jamba, gemma3-1b) decodes its batch of
1 on every rank (``StepMesh.for_batch``) against a KV cache whose
sequence is split over ``data`` (``specs.long_context``).

The same counter runs on the card, so a meta trace and a real step can
be compared count for count (``chip_smoke.py``'s ``phase_dryrun``).
Eager tracing visits every layer, so ``run_cell`` uses the full trace
(``"cost_method": "full_trace"``); the reference's decomposition into a
stem plus repeats of each layer pattern is kept as a cross-check
(``cost_by_decomposition``).  A train step updates the parameters and
optimizer state in place, as the reference donates them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --bft --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --bft --mesh workers
    PYTHONPATH=src python -m repro_torch.launch.dryrun --bft --mesh tp --model 2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --bft --mesh production
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh production
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import defaultdict

import numpy as np
import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (ASSIGNED, SHAPES, ShapeConfig, get_config,
                                 layer_groups, layer_kinds)
from repro_torch.configs.base import shape_applicable
from repro_torch.kernels import _account
from repro_torch.launch import roofline as RL
from repro_torch.launch.specs import input_specs, long_context
from repro_torch.optim import OptConfig
from repro_torch.train.pjit_step import (make_decode_step, make_prefill_step,
                                         make_train_step)

_aten = torch.ops.aten
# allocations that read and write nothing
_NO_DATA = {_aten.empty, _aten.empty_strided, _aten.empty_like,
            _aten.new_empty, _aten.new_empty_strided}
# the c10d collectives the steps issue (``train.ranks``); the first
# argument holds the result
_COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
                "alltoall_base_": "all-to-all"}
# operators whose CPU and CUDA kernels give the output the layout of the
# argument at this index where the meta kernel returns a dense one (the
# SSD's dt gradient arrives permuted, and the product after softplus's
# backward then copies it on a card): on meta the output is laid out so
_META_LAYOUT = {_aten.softplus_backward.default: 0}
# composite backwards (gather's, index_select's, indexing's) that fill a
# fresh ``new_zeros`` tensor: autograd runs them in place, but out of
# place under any dispatch mode (its tensor-subclass branch), which would
# count a second buffer of the parameter's size that a step run without
# a counter never holds; the counter runs them in place on the fresh
# zeros, as the uncounted step does
_IN_PLACE = {_aten.scatter_add.default: _aten.scatter_add_.default,
             _aten.index_add.default: _aten.index_add_.default,
             _aten.index_put.default: _aten.index_put_.default}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live storage of what runs
    under it (see the module's docstring).  ``device`` ("meta", "cuda",
    "cpu") picks the tensors that count: others (host values) are left
    out.  ``group``: the ranks a collective spans (the ``data`` axis).
    ``add_args`` registers the step's inputs, which count as arguments
    and never as temporaries.  Use it on meta tensors and on the card
    alike; time no wall inside it."""

    def __init__(self, device: str, group: int = 1):
        super().__init__()
        self.device = device
        self.group = group
        self.flops_by_dtype: dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.collectives: dict[str, dict] = {}
        self.collective_bytes = 0.0
        self.by_axis: dict[str, float] = defaultdict(float)
        self.kernels: dict[str, dict] = {}
        self.arg_bytes = 0
        self.live = 0
        self.peak = 0
        self._args: set[int] = set()
        self._live: dict[int, tuple] = {}
        self._in_kernel = 0
        self._fresh = None          # the last op's new_zeros result

    # -- inputs and storages --------------------------------------------
    def _counts(self, t: torch.Tensor) -> bool:
        return t.device.type == self.device

    def add_args(self, *trees) -> None:
        """Register the step's inputs.  A host int among them (the step,
        the decode position) counts as the 0-d int32 the reference
        passes to its compiled step."""
        for x in tree_flatten(trees)[0]:
            if isinstance(x, int) and not isinstance(x, bool):
                self.arg_bytes += 4
        for t in _tensors(trees):
            if not self._counts(t):
                continue
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args.add(id(st))
                self._live[id(st)] = (st, st.nbytes())   # held: an input
                self.arg_bytes += st.nbytes()

    def storage_bytes(self, x) -> int:
        """Bytes of the distinct storages of ``x``'s tensors that are
        not the step's inputs (an output that is an updated input
        counts once, as an argument)."""
        seen, total = set(), 0
        for t in _tensors(x):
            st = t.untyped_storage()
            if self._counts(t) and id(st) not in self._args \
                    and id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        return total

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live -= n

        self._live[key] = (weakref.ref(st, freed), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    # -- kernels ----------------------------------------------------------
    def kernel(self, name: str, cost: RL.KernelCost):
        """Context of one call of a hand-written kernel (or its meta
        form): its own FLOPs and bytes count, the operators its wrapper
        dispatches do not (their storages still do)."""
        counter = self

        class _Kernel:
            def __enter__(self):
                k = counter.kernels.setdefault(
                    name, {"calls": 0, "flops": 0, "bytes": 0})
                k["calls"] += 1
                k["flops"] += cost.flops
                k["bytes"] += cost.bytes
                counter.flops_by_dtype[cost.dtype] += cost.flops
                counter.bytes += cost.bytes
                counter._in_kernel += 1

            def __exit__(self, *exc):
                counter._in_kernel -= 1

        return _Kernel()

    def __enter__(self):
        if _account.COUNTER is not None:
            raise RuntimeError("a StepCounter is already active")
        _account.COUNTER = self
        return super().__enter__()

    def __exit__(self, *exc):
        _account.COUNTER = None
        return super().__exit__(*exc)

    # -- the operators ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh, self._fresh = self._fresh, None
        if func in _IN_PLACE and fresh is not None and args[0] is fresh():
            func = _IN_PLACE[func]
        out = func(*args, **kwargs)
        if func is _aten.new_zeros.default:
            self._fresh = weakref.ref(out)
        if func in _META_LAYOUT and out.device.type == "meta":
            out = torch.empty_like(args[_META_LAYOUT[func]], dtype=out.dtype)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        ins = [t for t in _tensors((args, kwargs)) if self._counts(t)]
        outs = [t for t in _tensors(out) if self._counts(t)]
        if not (ins or outs):
            return out
        for t in outs:
            self._track(t)
        if self._in_kernel or _account.STAGING or \
                func.overloadpacket in _NO_DATA or \
                self._moves_nothing(func, ins, outs):
            return out
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        formula = flop_counter.flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            first = ins[0] if ins else outs[0]
            self.flops_by_dtype[_dtype_name(first.dtype)] += int(flops)
        return out

    def _collective(self, func, args) -> None:
        """One c10d collective: its kind, its result's bytes, and the
        bytes one rank puts on the wire for it (none in a group of
        one), over the group of the axis it runs on (``train.ranks``
        marks it, ``_account.collective``; ``group`` otherwise)."""
        name = func.overloadpacket.__name__
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"the dry-run does not price c10d."
                                      f"{name}")
        kind = _COLLECTIVES[name]
        axis, size = _account.AXIS or ("data", self.group)
        nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0,
                                               "wire_bytes": 0.0})
        c["calls"] += 1
        c["bytes"] += nbytes
        wire = RL.ring_bytes(kind, nbytes, size) if size > 1 else 0.0
        c["wire_bytes"] += wire
        self.collective_bytes += wire
        self.by_axis[axis] += wire

    @staticmethod
    def _moves_nothing(func, ins, outs) -> bool:
        """A view or alias: every output lies in an input's storage and
        the operator mutates nothing."""
        if func.is_view:
            return True
        if func._schema.is_mutable or not outs:
            return False
        inputs = {id(t.untyped_storage()) for t in ins}
        return all(id(t.untyped_storage()) in inputs for t in outs)

    # -- the readings -----------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def result(self, outputs=None) -> dict:
        return {
            "flops": float(self.flops),
            "flops_by_dtype": {k: float(v) for k, v in
                               sorted(self.flops_by_dtype.items())},
            "bytes": float(self.bytes),
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.storage_bytes(outputs),
            "temp_bytes": self.peak,
            "peak_bytes": self.arg_bytes + self.peak,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collective_bytes": self.collective_bytes,
            "collective_detail": {k: v["wire_bytes"] for k, v in
                                  sorted(self.collectives.items())},
            "collective_counts": {k: self.collectives.get(k, {}).get(
                "calls", 0) for k in RL.COLLECTIVES},
            "collective_result_bytes": {k: v["bytes"] for k, v in
                                        sorted(self.collectives.items())},
            "collective_by_axis": dict(sorted(self.by_axis.items())),
        }


def count_step(step, args, device: str, group: int = 1):
    """Run ``step(*args)`` under a ``StepCounter`` counting ``device``'s
    tensors (collectives over ``group`` ranks); returns (the step's
    outputs, the counter's readings with ``compile_s``, the trace's
    seconds)."""
    counter = StepCounter(device, group)
    counter.add_args(args)
    t0 = time.perf_counter()
    with counter:
        out = step(*args)
    seconds = time.perf_counter() - t0
    res = counter.result(out)
    res["compile_s"] = seconds
    return out, res


def step_args(specs: dict, kind: str) -> tuple:
    """The step's positional arguments from ``input_specs``; the step
    and the decode position are host ints in the port's steps."""
    if kind == "train":
        return (specs["params"], specs["opt_state"], specs["batch"],
                int(specs["step"]))
    if kind == "prefill":
        return (specs["params"], specs["batch"])
    return (specs["params"], specs["token"], int(specs["pos"]),
            specs["cache"])


def step_for(cfg, kind: str, opt: OptConfig, impl: str | None = None,
             mesh=None, long_context: bool = False):
    if kind == "train":
        return make_train_step(cfg, opt, impl=impl, mesh=mesh)
    if kind == "prefill":
        return make_prefill_step(cfg, impl=impl, mesh=mesh)
    return make_decode_step(cfg, mesh=mesh, long_context=long_context)


def lower_compile(cfg, shape: ShapeConfig, opt: OptConfig | None = None,
                  mesh=None, impl: str | None = None,
                  pos: int | None = None, rank: int = 0) -> dict:
    """Trace one step on meta tensors; the reference's keys, plus
    ``flops_by_dtype``, ``kernels`` and the collectives by axis.  With
    ``mesh`` (a ``sharding.MeshShape``, e.g. a production mesh) the step
    is rank 0's (``train.pjit_step`` on its blocks, ``specs.input_specs``)
    under a ``fake`` process group of the mesh's world.  ``impl="torch"``
    traces the kernels' plain versions (what a CPU rank runs); ``pos`` a
    decode step's position (the cache's last by default); ``rank`` the
    rank of ``mesh`` traced (0 by default: its blocks, its rows)."""
    opt = opt or OptConfig()
    if mesh is None:
        specs = input_specs(cfg, shape, opt, pos=pos)
        _, res = count_step(step_for(cfg, shape.kind, opt, impl),
                            step_args(specs, shape.kind), "meta")
        return res
    step_mesh = _fake_step_mesh(mesh, rank)
    try:
        specs = input_specs(cfg, shape, opt, mesh=mesh,
                            coords=step_mesh.coords, pos=pos)
        step = step_for(cfg, shape.kind, opt, impl,
                        mesh=step_mesh.for_batch(shape.global_batch),
                        long_context=long_context(shape))
        _, res = count_step(step, step_args(specs, shape.kind), "meta",
                            group=step_mesh.world)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return res


def _fake_step_mesh(mesh, rank: int = 0):
    """Rank ``rank`` of a ``fake`` process group over the axes of
    ``mesh`` (a ``MeshShape``), as the plain steps' ``train.ranks.StepMesh``
    on ``meta``: its collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.train.ranks import StepMesh

    if dist.is_initialized():
        raise RuntimeError("the mesh dry-run needs its own process group; "
                           "one is already initialized")
    sizes = dict(mesh.shape)
    world = int(np.prod(list(sizes.values())))
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return StepMesh(make_step_mesh(sizes["data"], sizes.get("model", 1),
                                   sizes.get("pod", 1), device_type="cpu"),
                    "meta")


def cost_by_decomposition(cfg, shape: ShapeConfig,
                          opt: OptConfig | None = None) -> dict:
    """The reference's cost(stem) + sum over layer groups of repeats x
    (cost(one pattern) - cost(stem)), each part traced in full (the
    encoder's layer likewise); a cross-check of the full trace, which
    eager tracing makes exact already."""
    keys = ("flops", "bytes", "collective_bytes")
    for g in layer_groups(cfg):
        if tuple(layer_kinds(cfg, len(g.pattern))) != g.pattern:
            c = lower_compile(cfg, shape, opt)
            c["method"] = "full_trace_fallback"
            return c
    stem = lower_compile(
        dataclasses.replace(cfg, num_layers=0, encoder_layers=0), shape, opt)
    out = {k: stem[k] for k in keys}
    for g in layer_groups(cfg):
        gc = lower_compile(dataclasses.replace(
            cfg, num_layers=len(g.pattern), encoder_layers=0), shape, opt)
        for k in keys:
            out[k] += g.repeats * max(0.0, gc[k] - stem[k])
    if cfg.encoder_layers:
        ec = lower_compile(dataclasses.replace(
            cfg, num_layers=0, encoder_layers=1), shape, opt)
        for k in keys:
            out[k] += cfg.encoder_layers * max(0.0, ec[k] - stem[k])
    out["method"] = "period_decomposition"
    return out


def tokens_of(shape: ShapeConfig) -> int:
    return shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)


def roofline_of(cfg, shape: ShapeConfig, cost: dict,
                chips: int = 1, model_flops: bool = True) -> RL.Roofline:
    """The cell's roofline; ``model_flops`` False leaves out the MFU
    numerator (the reference gives it at 16x16 only)."""
    return RL.Roofline(
        flops_per_device=cost["flops"], bytes_per_device=cost["bytes"],
        collective_bytes_per_device=cost.get("collective_bytes", 0.0),
        model_flops_total=RL.model_flops(
            cfg, tokens=tokens_of(shape), training=shape.kind == "train")
        if model_flops else 0.0,
        chips=chips, flops_by_dtype=cost.get("flops_by_dtype"))


#: the plain steps' production meshes (``--mesh production``)
PLAIN_PRODUCTION = ("16x16", "2x16x16")


def run_cell(arch: str, shape_name: str, *, opt: OptConfig | None = None,
             with_cost: bool = True, mesh: str = "single") -> dict:
    """One (arch x shape) cell: on one card (``mesh`` "single"), or rank 0
    of the reference's production mesh ("16x16" or "2x16x16", the plain
    steps with FSDP + TP, ``lower_compile(mesh=)``): the full trace
    (per-rank FLOPs, bytes, peak, collective bytes by axis), whether the
    peak fits a card's memory, and the roofline over the mesh's chips,
    with the MFU numerator on one card and at 16x16, as the reference
    gives it.  A model the model axis cannot split (whisper, the VLM) is
    skipped on a mesh, with the reason; ``long_500k`` runs its batch of
    1 on every rank and its cache's sequence split over ``data``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    if mesh == "single":
        full = lower_compile(cfg, shape, opt)
        chips, label, pm = 1, "1xH100", None
    else:
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models.transformer import require_splittable

        if mesh not in PLAIN_PRODUCTION:
            raise ValueError(f"mesh {mesh!r}: single or one of "
                             f"{PLAIN_PRODUCTION}")
        pm = make_production_mesh(multi_pod=mesh == "2x16x16")
        chips, label = int(np.prod(pm.axis_sizes)), mesh
        base = {"arch": arch, "shape": shape_name, "mesh": label,
                "chips": chips}
        try:
            require_splittable(cfg, pm.shape["model"])
        except ValueError as e:
            return {**base, "skipped": str(e)}
        full = lower_compile(cfg, shape, opt, mesh=pm)
    res = {"arch": arch, "shape": shape_name, "mesh": label, "chips": chips,
           "full": full, "fits_hbm": full["peak_bytes"] <= RL.HBM_PER_CARD}
    if with_cost:
        res["cost_method"] = "full_trace"
        res["roofline"] = roofline_of(
            cfg, shape, full, chips,
            model_flops=mesh in ("single", "16x16")).as_dict()
        res["collective_detail"] = full["collective_detail"]
        res["collective_by_axis"] = full["collective_by_axis"]
    return res


MESHES = ("single", "workers", "tp", "production")
# the reference's production BFT cells: (label, workers, model, f)
PRODUCTION = (("16x16", 16, 16, 3), ("2x16x16", 32, 16, 3))


def run_bft_cells(arch: str, n: int = 8, f: int = 2, *,
                  global_batch: int | None = None,
                  seq_len: int | None = None,
                  opt: OptConfig | None = None,
                  mesh: str = "single", model: int = 2,
                  label: str | None = None, cfg=None,
                  data_ranks: int | None = None, active=None,
                  modes: tuple = ("fast", "check", "check_full",
                                  "identify"),
                  impl: str | None = None) -> dict:
    """The BFT steps (fast, check with sketch and with full detection,
    identify) traced on meta tensors with n workers and the protocol's
    assignments (``core.assignment``), at ``train_4k`` unless a global
    batch and sequence are given.  ``mesh``: "single", every worker on
    one card; "workers", n ranks on ``data`` with one worker each; "tp",
    n ranks on ``data`` times ``model`` ranks splitting each worker
    (``label`` names the mesh); rank 0's step traced under a ``fake``
    process group of the mesh's world (its collectives counted per axis;
    ``roofline.collective_s`` at NVLink's rate).  Every worker is honest
    and every host read of a meta tensor reads as no fault and no
    mismatch: the common branch (``"assumed": "honest"``).  A model that
    attends to a context raises: the steps never pass one, as the
    reference's do not; under "tp" an arch the model axis cannot split
    returns ``{"skipped": reason}``.  ``cfg`` replaces ``arch``'s config
    (a cut one), ``data_ranks`` the n data ranks of "tp" (W, each then
    running n / W workers), ``active`` the active workers (all), and
    ``modes`` the steps traced; ``impl="torch"`` traces the kernels'
    plain versions (what a CPU rank runs)."""
    from repro_torch.core.assignment import (check_assignment,
                                             fast_assignment, group_members,
                                             identify_assignment)
    from repro_torch.core import prngkey
    from repro_torch.data.pipeline import worker_batches
    from repro_torch.models import model as M
    from repro_torch.models.transformer import uses_context
    from repro_torch.optim import abstract_opt_state
    from repro_torch.train.steps import (AttackConfig, StepConfig,
                                         make_check_step, make_fast_step,
                                         make_identify_step)

    from repro_torch.models.transformer import require_splittable

    if mesh not in MESHES[:3]:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES[:3]}")
    cfg = cfg or get_config(arch)
    W = n if data_ranks is None else data_ranks
    if mesh == "tp":
        try:
            require_splittable(cfg, model)
        except ValueError as e:
            return {"arch": arch, "mesh": label or f"{n}x{model} data,model",
                    "skipped": str(e)}
    if uses_context(cfg):
        raise ValueError(f"{cfg.name} attends to a context, which the BFT "
                         f"steps never pass")
    opt = opt or OptConfig()
    train = SHAPES["train_4k"]
    B = train.global_batch if global_batch is None else global_batch
    S = train.seq_len if seq_len is None else seq_len
    shape = ShapeConfig("bft", S, B, "train")
    params = M.abstract_params(cfg)
    opt_state = abstract_opt_state(opt, params)
    sc, attack = StepConfig(detection="sketch"), AttackConfig("sign_flip")
    active = np.ones(n, bool) if active is None else np.asarray(active, bool)
    byz = np.zeros(n, bool)
    key = prngkey.PRNGKey(0)
    host = {"tokens": np.zeros((B, S), np.int32),
            "labels": np.zeros((B, S), np.int32)}
    ranks, chips = None, 1
    if mesh == "workers":
        ranks, chips = _fake_ranks(n), n
    elif mesh == "tp":
        ranks, chips = _fake_ranks(W, model), W * model
        from repro_torch.core import tree as tree_mod
        from repro_torch.models import convert
        from repro_torch.sharding import (tp_only_rules, tree_structs)

        ann = M.annotated_params(cfg)
        params = tree_structs(ann, ranks.mesh, tp_only_rules())
        opt_state = abstract_opt_state(opt, params)
        ranks.model.placements = tree_mod.leaves(
            convert.placements(cfg, ranks.mesh))
    out = {"arch": arch, "mesh": "1xH100" if ranks is None else
           label or f"{W}x{model if mesh == 'tp' else 1} data,model",
           "chips": chips, "n": n, "f": f, "model": model
           if mesh == "tp" else 1,
           "global_batch": B, "seq_len": S, "assumed": "honest"}
    try:
        for mode in modes:
            kw = {"ranks": ranks, "impl": impl}
            if mode == "fast":
                a = fast_assignment(active)
                fn = make_fast_step(cfg, opt, sc, attack, **kw)
            elif mode.startswith("check"):
                a = check_assignment(active, f)
                sc_m = sc if mode == "check" else dataclasses.replace(
                    sc, detection="full")
                fn = make_check_step(cfg, opt, sc_m, attack, a.num_shards,
                                     **kw)
            else:
                a = identify_assignment(active, f)
                fn = make_identify_step(cfg, opt, sc, attack,
                                        np.stack(group_members(a)), **kw)
            args = (params, opt_state, worker_batches(host, a), a.weight,
                    byz)
            if mode.startswith("check"):
                args = args + (a.group_of_worker,)
            _, c = count_step(fn, args + (key, 0), "meta",
                              group=chips if mesh != "tp" else W)
            rl = roofline_of(cfg, shape, c, chips)
            out[mode] = {
                "compile_s": c["compile_s"], "flops": c["flops"],
                "flops_by_dtype": c["flops_by_dtype"], "bytes": c["bytes"],
                "collective_bytes": c["collective_bytes"],
                "collective_counts": c["collective_counts"],
                "collective_detail": c["collective_detail"],
                "collective_result_bytes": c["collective_result_bytes"],
                "collective_by_axis": c["collective_by_axis"],
                "peak_bytes": c["peak_bytes"], "kernels": c["kernels"],
                "replication": int(a.replication),
                "num_shards": int(a.num_shards),
                "roofline": rl.as_dict(), "bound_s": rl.bound_s}
    finally:
        if ranks is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return out


def _fake_ranks(n: int, model: int = 1):
    """Rank 0 of a ``fake`` process group of world n x ``model`` on
    ``meta``: its collectives return at once and move nothing.  With
    ``model`` above 1 its ``Ranks`` hold both axes of an n x ``model``
    worker mesh (``ranks.mesh``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.train.ranks import Ranks

    if dist.is_initialized():
        raise RuntimeError("the workers dry-run needs its own process "
                           "group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n * model)
    if model == 1:
        return Ranks(dist.group.WORLD, "meta")
    return Ranks.of(make_worker_mesh(n, model, device_type="cpu"), "meta")


def decoder_only(archs) -> list:
    """The archs that attend to no context: the ones the BFT steps run
    (and every one a model axis splits)."""
    from repro_torch.models.transformer import uses_context

    return [a for a in archs if not uses_context(get_config(a))]


def run_production_cells(arch: str, *, global_batch: int | None = None,
                         seq_len: int | None = None,
                         opt: OptConfig | None = None) -> dict:
    """The reference's ``run_bft_cells`` on the production meshes
    (``PRODUCTION``: 16x16 with the workers on ``data``, n = 16, and
    2x16x16 with the workers on (``pod``, ``data``), n = 32; ``model`` =
    16, f = 3, ``train_4k``), rank 0 of each traced as ``tp``: every
    decoder-only arch splits (``--bft --arch all`` takes those); an arch
    that cannot split is listed as skipped with its reason."""
    out = {"arch": arch, "cells": {}}
    for label, n, model, f in PRODUCTION:
        out["cells"][label] = run_bft_cells(
            arch, n, f, global_batch=global_batch, seq_len=seq_len,
            opt=opt, mesh="tp", model=model, label=label)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=MESHES,
                    help="single: one card (every BFT worker in one "
                         "process); workers (with --bft): n ranks on the "
                         "data axis, one worker each, collectives counted; "
                         "tp: n x --model ranks; production: the "
                         "reference's 16x16 and 2x16x16 cells, rank 0 of "
                         "the plain steps with FSDP + TP (with --bft: "
                         "the BFT cells)")
    ap.add_argument("--model", type=int, default=2,
                    help="ranks a worker is split over (--mesh tp)")
    ap.add_argument("--bft", action="store_true",
                    help="dry-run the BFT steps instead")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh in ("workers", "tp") and not args.bft:
        raise SystemExit(f"--mesh {args.mesh} traces the BFT steps: add "
                         f"--bft")
    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    if args.bft and args.arch == "all":       # the steps never pass a ctx
        archs = decoder_only(archs)
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.out, exist_ok=True)

    def write(tag: str, base: dict, fn) -> None:
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip] {tag}")
            return
        t0 = time.time()
        try:
            res = fn()
        except Exception as e:  # noqa: BLE001 - recorded in the cell
            res = {**base, "mesh": args.mesh, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}: {e}")
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1)
        status = res.get("skipped") or res.get("error") or (
            " ".join(f"{m}={res[m]['bound_s'] * 1e3:.1f}ms" for m in
                     ("fast", "check", "check_full", "identify"))
            if "fast" in res else
            " ".join(f"{k}: {v.get('skipped') or 'traced'}"
                     for k, v in res["cells"].items()) if "cells" in res else
            f"fits={res.get('fits_hbm')} "
            f"dom={res.get('roofline', {}).get('dominant', '-')}")
        print(f"[done] {tag} ({time.time() - t0:.1f}s) {status}",
              flush=True)

    if args.bft:
        for arch in archs:
            if args.mesh == "production":
                fn = lambda arch=arch: run_production_cells(arch)  # noqa
            else:
                fn = lambda arch=arch: run_bft_cells(  # noqa: E731
                    arch, mesh=args.mesh, model=args.model)
            write(f"bft_{arch}_{args.mesh}", {"arch": arch}, fn)
        return
    meshes = PLAIN_PRODUCTION if args.mesh == "production" else ("single",)
    for arch in archs:
        for name in shapes:
            for m in meshes:
                write(f"{arch}_{name}_{m}", {"arch": arch, "shape": name},
                      lambda arch=arch, name=name, m=m: run_cell(
                          arch, name, with_cost=not args.no_cost, mesh=m))

if __name__ == "__main__":
    main()
