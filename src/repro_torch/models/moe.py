"""Mixture-of-Experts layer: top-k routing with capacity-bounded gather
dispatch.

Port of ``repro.models.moe``: its global path (``_moe_global``), which
the reference takes on one device and inside the trainer's worker
bodies (``LOCAL_DISPATCH`` below).

Expert-parallel over the ambient ``model`` axis (``models.parallel``)
when the expert leaves are split (the reference's ``experts`` on
``model``): each rank holds E / model experts and its columns of the
router; the router's logits (N, E / model) are all-gathered, so every
rank routes alike and assigns the same slots; each rank fills and runs
its own experts' buffers, combines their choices in f32 and the
partial outputs are summed over ``model``.

Each (token, choice) gets a slot in its expert's capacity buffer from
an exclusive cumulative sum over the routing one-hots, token-major and
choice-minor; choices past the capacity C are dropped and their gate is
zero.  Under the plain steps' batch split (``pod``, ``data``) the
routing stays the global one: the global C, slots counted across the
data ranks (``route_logits``), each rank's kept choices in a buffer of
its own and the aux loss its share of the global one.  The expert FFNs
are three batched products over the (E, C, D) buffer.  Precision follows the reference: routing (the router product,
softmax, top-k, renormalization) in f32; the expert products in the
config's dtype, the SiLU in f32 cast back; the combine an f32 weighted
sum over the choices, cast to the input's dtype; the shared expert
added after, in the dtype.

The dispatch and the combine are row gathers (``_Gather``) whose
backward is the gather by the inverse map, summed over the choices in a
fixed order: every slot holds at most one choice, so no gradient is
added by a scatter, and the backward adds no floats atomically (honest
replicas stay bitwise equal on the card).  No kernel: the reference
computes these products as einsums outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch import sharding
from repro_torch.models import parallel
from repro_torch.models.layers import dtype_of, init_weight, mlp

#: opt-in local (per-batch-shard) dispatch, the reference's constant:
#: each batch shard of a pure-pjit step routes its own tokens under a
#: nested ``shard_map``, so only the expert contraction crosses chips.
#: Off there by default (the XLA CPU partitioner fails on nested
#: shard_map + scan + remat at 256 devices); inside a BFT worker body,
#: the trainer's path, the reference takes the global dispatch either
#: way, as this port does.  The local path waits for FSDP inside a worker
#: (ROADMAP item 7b).
LOCAL_DISPATCH = False


def capacity(cfg, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` routed tokens, a multiple of
    8 and at least 8 (the reference's rule)."""
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def init_moe(cfg, gen: torch.Generator, device):
    """The reference's ``abstract_moe`` leaves with its distribution
    (``layers.materialize``): truncated normal on [-2, 2] times
    1/sqrt(shape[-2]), in the config's dtype."""
    m = cfg.moe
    E, F, D = m.num_experts, m.d_ff, cfg.d_model

    def w(*shape):
        return init_weight(shape, dtype_of(cfg), gen, device)

    p = {"router": w(D, E), "gate": w(E, D, F), "up": w(E, D, F),
         "down": w(E, F, D)}
    if m.shared_expert:
        p["shared"] = {"gate": w(D, F), "up": w(D, F), "down": w(F, D)}
    return p


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``src`` (n, D) at ``idx`` (any shape, values in [0, n]);
    index n reads a zero row.  Returns idx.shape + (D,)."""
    n = src.shape[0]
    flat = idx.reshape(-1)
    out = src.index_select(0, flat.clamp(max=n - 1))
    out.masked_fill_((flat == n)[:, None], 0)
    return out.reshape(*idx.shape, src.shape[1])


class _Gather(torch.autograd.Function):
    """out = ``_take(src, fwd)``; the gradient of src row i is the sum
    over j, in order, of grad rows ``bwd[i, j]`` (index len(out) reads
    zero).  ``bwd`` must list, for each row of src, every position of
    ``fwd`` that reads it."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _take(src, fwd)

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        g = _take(grad.reshape(-1, grad.shape[-1]), bwd)
        out = g[:, 0]
        for j in range(1, g.shape[1]):
            out = out + g[:, j]
        return out, None, None


def routing(params, xt: torch.Tensor, cfg):
    """The routing pass of ``xt`` (N, D): (probs (N, E) f32, expert_idx
    (N, K), gates (N, K) f32 renormalized and zeroed where dropped, slot
    (N, K) within the expert, keep (N, K) bool, C, local (N, K): the
    slot within this rank's choices of the expert, ``slot`` itself with
    no batch split)."""
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    if logits.shape[-1] != cfg.moe.num_experts:       # router columns split
        logits = parallel.gather(logits, -1)
    return route_logits(logits, cfg)


def exclusive_slots(expert_idx: torch.Tensor, E: int):
    """(the routing one-hots (N*K, E) int64, each choice's count of the
    earlier choices of its expert in (token, choice) order (N, K)): an
    exclusive cumulative sum over the one-hots, token-major and
    choice-minor."""
    N, K = expert_idx.shape
    # the one-hots by a compare: ``one_hot`` takes other operators on
    # each device (the dry-run holds meta and card counts equal)
    flat = (expert_idx[..., None] == torch.arange(
        E, device=expert_idx.device)).to(torch.int64).reshape(N * K, E)
    return flat, ((flat.cumsum(dim=0) - flat) * flat).sum(dim=-1).reshape(
        N, K)


def route_logits(logits: torch.Tensor, cfg):
    """``routing`` from the router's f32 logits (N, E).  Under a batch
    split the routing is the reference's global one (``LOCAL_DISPATCH``
    off): C is the capacity of the global N, and a choice's slot counts
    the earlier choices of its expert over the global (token, choice)
    order, the data ranks before this one included (their per-expert
    counts all-gathered over the axes that split the batch, an exclusive
    scan).  A batch those axes replicate (``StepMesh.for_batch``: the
    batch of 1 of ``long_500k``'s decode) is routed as one process
    routes it, on every rank alike: its tokens are counted once."""
    m = cfg.moe
    N = logits.shape[0]
    E, K = m.num_experts, m.top_k
    mesh = sharding.batch_mesh()
    C = capacity(cfg, N * (mesh.batch_parts if mesh else 1))
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat, local = exclusive_slots(expert_idx, E)
    slot = local
    if mesh is not None:
        counts = mesh.batch_gather(flat.sum(dim=0)[None])
        slot = local + counts[:mesh.batch_index].sum(dim=0)[expert_idx]
    keep = slot < C
    gates = gates * keep.to(gates.dtype)
    return probs, expert_idx, gates, slot, keep, C, local


def moe(params, x: torch.Tensor, cfg):
    """x (B, S, D) -> (y (B, S, D), aux () f32): the B * S tokens routed
    as one group, as the reference's global path does."""
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    El = params["gate"].shape[0]
    split = El != E                    # experts split over the model axis
    xt = x.reshape(N, D)
    if split:
        ax = parallel.require_axis()
        xt = parallel.copy(xt, ax)
    probs, expert_idx, gates, _, keep, C, slot = routing(params, xt, cfg)
    mesh = sharding.batch_mesh()
    if mesh is not None:
        # this rank's kept choices fill its buffer from 0 (``local``), in
        # the global order: at most N of its tokens reach one expert
        C = min(C, N)

    # (token, choice) -> its row of this rank's (El*C) buffer, El*C where
    # dropped or another rank's; each row's token (N where empty) and
    # (token, choice) (N*K)
    dest = torch.where(keep, expert_idx * C + slot, E * C)
    if split:
        dest = dest - ax.rank * El * C
        dest = torch.where((dest >= 0) & (dest < El * C), dest, El * C)
    dest = dest.reshape(-1)
    ids = torch.arange(N * K, device=x.device)
    src = torch.full((El * C + 1,), N * K, dtype=ids.dtype, device=x.device)
    src.scatter_(0, dest, ids)
    src = src[:El * C]
    token_of_row = torch.where(src < N * K, src // K, N)

    xe = _Gather.apply(xt, token_of_row, dest.reshape(N, K))
    xe = xe.reshape(El, C, D)
    g = torch.bmm(xe, params["gate"])
    u = torch.bmm(xe, params["up"])
    h = torch.nn.functional.silu(g.to(torch.float32)).to(xe.dtype) * u
    ye = torch.bmm(h, params["down"]).reshape(El * C, D)

    ytk = _Gather.apply(ye, dest, src[:, None]).reshape(N, K, D)
    # the gates' gradient from this rank's choices only: summed over model
    gw = parallel.copy(gates, ax) if split else gates
    y = ytk[:, 0].to(torch.float32) * gw[:, :1]
    for k in range(1, K):
        y = y + ytk[:, k].to(torch.float32) * gw[:, k:k + 1]
    if split:
        y = parallel.reduce(y, ax)
    y = y.to(x.dtype)
    if m.shared_expert:
        y = y + mlp(params["shared"], x.reshape(N, D), m.d_ff)

    # every top-k choice counts, dropped ones included; a scatter-add of
    # ones, not ``bincount``, whose output length waits on the host
    choices = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, choices, torch.ones_like(choices))
    if mesh is None:
        frac = counts.to(torch.float32) / (N * K)
        aux = E * torch.sum(frac * probs.mean(dim=0))
    else:
        # this rank's share of the global aux: the global fractions times
        # its rows' probabilities over the global N (``train_loss`` sums
        # the shares over the axes that split the batch)
        Ng = N * mesh.batch_parts
        frac = mesh.batch_sum(counts.to(torch.float32)) / (Ng * K)
        aux = E * torch.sum(frac * probs.sum(dim=0) / Ng)
    return y.reshape(B, S, D), aux
