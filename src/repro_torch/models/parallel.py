"""Tensor and expert parallelism inside a BFT worker: the model code's
collectives over the ambient ``model`` axis (``sharding.set_mesh``,
``train.ranks.ModelAxis``), Megatron-style.

The reference leaves the ``model`` axis to GSPMD; here each rank of a
worker holds its shard of every leaf (``sharding.tree_shardings`` under
``tp_only_rules``) and computes its part, and these autograd functions
join the parts:

  copy      forward the identity, backward a sum over ``model``: the
            input of a column-parallel product (wq / wk / wv, gate /
            up, the unembed, the experts, the router), whose input
            gradient is partial on each rank; also a replicated leaf
            that only this rank's heads read (the qk-norm scales, a
            replicated wk / wv), whose gradient is partial likewise;
  reduce    forward a sum over ``model``, backward the identity: the
            output of a row-parallel product (wo, down, the experts'
            combine) and the masked vocab-parallel lookups;
  gather    forward an all-gather along a dim, backward this rank's
            slice: the router's logits, which every rank then routes
            alike;
  gather_scatter  forward an all-gather, backward a sum over ``model``
            and this rank's slice: kv columns that cut a head, and q's
            columns and the attention's output when wq's cut one
            (``heads_forced``);
  all_reduce  forward and backward a sum over ``model``: a statistic of
            a split dim that every rank's slice then reads (the gated
            RMSNorm's sum of squares over mamba's split ``d_inner``).

FSDP over the ambient ``data`` axis (the plain steps, ``PARAM_RULES``'
``embed`` on ``data``; ``train.ranks.DataAxis``):

  fsdp_gather  forward an all-gather of a leaf's d_model dim over
            ``data``, backward a reduce-scatter sum over ``data`` in f32
            in rank order, keeping this rank's slice: each data rank's
            rows add their part of the gradient.  A leaf split on both
            axes (wq's (D / data, H hd / model)) is gathered to its
            ``model`` shard, which the TP code above then reads; its
            gradient passes TP's ``copy`` / ``reduce`` backward first,
            as autograd orders it, then the reduce-scatter;
  batch_sum  forward a sum over the axes that split the batch
            (``data``, ``pod``; none where it is replicated) in rank
            order, backward the identity: the loss's share of each data
            rank, whose gradient is each rank's own.

Every sum runs in f32 and is cast back to its operand's dtype.  The
backward of ``copy`` and ``reduce`` keeps the loss's gradient the same
bits on every rank of a worker, so the replicated leaves' gradients
need no collective of their own.
"""
from __future__ import annotations

import torch

from repro_torch import sharding


def axis():
    """The ambient ``model`` axis, or None outside one."""
    return sharding.axis_of(sharding.ambient_mesh(), "model")


def data_axis():
    """The ambient ``data`` axis (above 1), or None."""
    return sharding.axis_of(sharding.ambient_mesh(), "data")


def require_axis():
    ax = axis()
    if ax is None:
        raise RuntimeError("a leaf is split over the model axis but no "
                           "model axis is installed (sharding.set_mesh)")
    return ax


def _sum(ax, t: torch.Tensor) -> torch.Tensor:
    """Sum over ``model`` in f32, cast back to ``t``'s dtype."""
    out = t.to(torch.float32, copy=True).contiguous()
    ax.all_reduce_sum(out)
    return out.to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.ax, g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _sum(ax, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, scatter):
        ctx.ax, ctx.dim, ctx.n, ctx.scatter = ax, dim, x.shape[dim], scatter
        return ax.gather_dim(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            g = _sum(ctx.ax, g)
        return g.narrow(ctx.dim, ctx.ax.rank * ctx.n, ctx.n), None, None, \
            None


def copy(x: torch.Tensor, ax=None) -> torch.Tensor:
    ax = ax or require_axis()
    return _Copy.apply(x, ax)


def reduce(x: torch.Tensor, ax=None) -> torch.Tensor:
    ax = ax or require_axis()
    return _Reduce.apply(x, ax)


def all_reduce(x: torch.Tensor, ax=None) -> torch.Tensor:
    ax = ax or require_axis()
    return _Copy.apply(_Reduce.apply(x, ax), ax)


def gather(x: torch.Tensor, dim: int, ax=None) -> torch.Tensor:
    ax = ax or require_axis()
    return _Gather.apply(x, ax, dim % x.dim(), False)


def gather_scatter(x: torch.Tensor, dim: int, ax=None) -> torch.Tensor:
    ax = ax or require_axis()
    return _Gather.apply(x, ax, dim % x.dim(), True)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.dtype = ax, dim, x.dtype
        return ax.gather_dim(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.reduce_scatter_sum(g, ctx.dim).to(ctx.dtype), None, \
            None


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.batch_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fsdp_gather(x: torch.Tensor, dim: int, ax=None) -> torch.Tensor:
    """The leaf ``x``, this rank's d_model slice along ``dim``, gathered
    over ``data``; under autograd its gradient is reduce-scattered back."""
    ax = ax or data_axis()
    return _FsdpGather.apply(x, ax, dim % x.dim())


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ambient mesh's batch axes (identity
    without them); its gradient is each rank's own."""
    mesh = sharding.batch_mesh()
    return x if mesh is None else _BatchSum.apply(x, mesh)
