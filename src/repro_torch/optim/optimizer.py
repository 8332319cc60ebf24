"""Optimizers: SGD / momentum / AdamW with warmup + cosine schedule.

Port of ``repro.optim.optimizer``.  The state mirrors the parameter
tree (``{"mu": ..., "nu": ...}``, float32 whatever the parameters'
dtype); every update is computed in float32 from the parameter's f32
value and cast back to its dtype (mixed precision).  The reference is
functional; here ``opt_update`` writes the new parameters and state
into the given tensors, leaf by leaf (a 1.2 B-parameter model has no
room for a second copy of its AdamW state), and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: Literal["sgd", "momentum", "adamw"] = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def lr_at(opt: OptConfig, step) -> np.float32:
    """The learning rate at ``step``, in float32 as the reference
    computes it: linear warmup, then cosine to min_lr_ratio * peak."""
    f = np.float32
    step = f(step)
    if step < opt.warmup_steps:
        return f(opt.peak_lr) * (step + f(1)) / f(max(1, opt.warmup_steps))
    prog = np.clip((step - f(opt.warmup_steps))
                   / f(max(1, opt.total_steps - opt.warmup_steps)),
                   f(0), f(1))
    cos = f(1) + np.cos(f(math.pi) * prog)
    return f(opt.peak_lr) * (f(opt.min_lr_ratio)
                             + f((1 - opt.min_lr_ratio) * 0.5) * cos)


def abstract_opt_state(opt: OptConfig, abstract_params):
    """The state's shapes without memory: ``{}`` (sgd), ``{"mu"}``
    (momentum) or ``{"mu", "nu"}`` (adamw), f32 meta tensors shaped like
    the parameters (the reference's ``abstract_opt_state``)."""
    meta = tree.tree_map(lambda p: p.to("meta"), abstract_params)
    return init_opt_state(opt, meta)


def init_opt_state(opt: OptConfig, params):
    if opt.kind == "sgd":
        return {}

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if opt.kind == "momentum":
        return {"mu": tree.tree_map(zeros, params)}
    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params)}


def global_norm(grads, axis=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.
    ``axis``: the mesh the leaves are shards on, with each leaf's
    ``placements``: the worker's model axis (a ``train.ranks.ModelAxis``)
    or the plain steps' ``train.ranks.StepMesh``.  Each leaf's squares
    are summed over exactly the axes it is split on, so every element
    counts once: the leaves are grouped by those axes, each group's sum
    reduced over them (``model`` by ``all_reduce_sum``, ``data`` in rank
    order), the groups added in a fixed order, the replicated leaves
    last; every rank reads the same bits."""
    sq = [g.to(torch.float32).square().sum() for g in tree.leaves(grads)]
    if axis is None:
        return torch.sqrt(torch.stack(sq).sum())
    groups: dict[tuple, list] = {}
    for s, pl in zip(sq, axis.placements):
        groups.setdefault(tuple(sorted(pl.split_axes)), []).append(s)
    total = None
    for names in sorted(n for n in groups if n):
        part = torch.stack(groups[names]).sum().reshape(1)
        for name in names:
            part = _sum_over(axis, name, part)
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros(1, dtype=torch.float32, device=sq[0].device)
    if () in groups:
        total = total + torch.stack(groups[()]).sum()
    return torch.sqrt(total[0])


def _sum_over(axis, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over mesh axis ``name`` of ``axis`` (a one-axis
    ``Ranks`` or a ``StepMesh``)."""
    from repro_torch.sharding import axis_of

    ax = axis_of(axis, name)
    if hasattr(ax, "all_reduce_ordered"):
        return ax.all_reduce_ordered(t)
    return ax.all_reduce_sum(t)


@torch.no_grad()
def opt_update(opt: OptConfig, grads, state, params, step, *, axis=None):
    """Update ``params`` and ``state`` in place from ``grads``; returns
    (params, state, {"grad_norm", "lr"}) with 0-d f32 tensors.  ``axis``
    as ``global_norm``'s: the clip reads the whole worker's norm."""
    gnorm = global_norm(grads, axis)
    dev = gnorm.device
    # an operator on the device (not a host tensor lifted and copied), so
    # the dry-run counts it on every device alike
    lr = torch.full((), float(lr_at(opt, step)), dtype=torch.float32,
                    device=dev)
    if opt.grad_clip:
        scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=dev)
    ps, gs = tree.leaves(params), tree.leaves(grads)

    if opt.kind == "sgd":
        step_size = lr * scale
        for p, g in zip(ps, gs):
            p.copy_(p.to(torch.float32) - step_size * g.to(torch.float32))
    elif opt.kind == "momentum":
        for p, g, m in zip(ps, gs, tree.leaves(state["mu"])):
            m.mul_(opt.momentum).add_(g.to(torch.float32) * scale)
            p.copy_(p.to(torch.float32) - lr * m)
    else:
        t = np.float32(step) + np.float32(1.0)
        b1, b2 = opt.beta1, opt.beta2
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        for p, g, m, v in zip(ps, gs, tree.leaves(state["mu"]),
                              tree.leaves(state["nu"])):
            g = g.to(torch.float32) * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square_())
            del g
            p32 = p.to(torch.float32)
            upd = (m / c1).div_(torch.sqrt(v / c2).add_(opt.eps))
            upd.add_(opt.weight_decay * p32)
            p.copy_(p32.sub_(lr * upd))
    return params, state, {"grad_norm": gnorm, "lr": lr}
