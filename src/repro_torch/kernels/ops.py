"""Dispatch over the port's kernels: the hand-written CUDA kernel or its
plain PyTorch version.

``impl`` is ``"cuda"`` (the hand-written kernel), ``"torch"`` (the plain
version) or ``None``.  ``None`` follows the tensor: a CUDA tensor goes
to the CUDA kernel, a CPU tensor to the plain version, a ``meta`` tensor
(the dry-run, ``launch.dryrun``) to the kernel's shape-only form, which
returns empty outputs of the kernel's shapes and dtypes.  Only the
kernels of the model and trainer paths have one (``flash_attention``,
``sketch``, ``sketch_shard``, ``pairwise_relmax`` / ``vote``,
``batched_pairwise_relmax``
/ ``batched_vote``); the others raise on a meta tensor.  ``"torch"`` on
a CUDA tensor is an explicit choice (the chip check compares the two
with it) and is never made automatically; ``"cuda"`` on a CPU tensor
raises.  A CUDA kernel that fails to build or launch raises — nothing
falls back.  A kernel runs on the device of its operands, whichever
device is current (``_build.on_operand_device``), so the trials split
(``core.engineplan.shard``) needs no rule of its own for the kernels.

Each kernel wrapper counts the calls in which it launched its kernel
(``launch_counts``), so a run can show that it went through them; a
shape-only call launches nothing and is not counted.  While a dry-run
counter is active, the kernels and shape-only forms of those paths
report their own FLOPs and bytes to it (``kernels._account``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _account
from repro_torch.kernels import coded_encode as _enc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_step as _fs
from repro_torch.kernels import gram as _gm
from repro_torch.kernels import majority_vote as _mv
from repro_torch.kernels import sketch as _sk
from repro_torch.launch.roofline import kernel_cost

IMPLS = ("cuda", "torch")


def resolve_impl(impl: str | None, device) -> str:
    """Resolve a kernel impl choice against the device the data lies on."""
    device = torch.device(device)
    if impl is None:
        return device.type if device.type in ("cuda", "meta") else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; allowed values: "
                         f"{list(IMPLS)} (or None to follow the device)")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f'kernel impl "cuda" needs CUDA tensors, got '
                         f"device {device}")
    return impl


_KERNEL_MODULES = (_gm, _mv, _fs, _sk, _enc, _fa)


def launch_counts() -> dict[str, int]:
    """{kernel: wrapper calls that launched it} since the last reset;
    one entry per kernel form (batched and single count apart)."""
    out: dict[str, int] = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES:
        for key in mod.LAUNCHES:
            mod.LAUNCHES[key] = 0


def gram_factors(rows: torch.Tensor, W0: torch.Tensor | None, keys, *,
                 k: int = 256, impl: str | None = None,
                 with_gram: bool = True):
    """(rows (Ie, d) f32, W0 (B, d) f32 or None, keys (T,) uint32) ->
    (G (Ie, Ie) or None, S0 (B, Ie) or None, SK (T, Ie, k)); see
    :mod:`repro_torch.kernels.gram`."""
    use = resolve_impl(impl, rows.device)
    if use == "meta":
        _account.refuse_meta("gram_factors")
    if use == "cuda":
        return _gm.gram_factors_cuda(rows, W0, keys, k, with_gram)
    return _gm.gram_factors_plain(rows, W0, keys, k, with_gram)


def batched_pairwise_relmax(replicas: torch.Tensor, *,
                            impl: str | None = None) -> torch.Tensor:
    """(B, R, d) -> (B, R, R) relative max-difference matrices."""
    use = resolve_impl(impl, replicas.device)
    if use == "torch":
        return _mv.pairwise_relmax_batched_plain(replicas)
    x = replicas.to(torch.float32)
    B, R, d = x.shape
    fn = _mv.pairwise_relmax_batched_cuda if use == "cuda" else \
        (lambda t: t.new_empty((B, R, R)))
    return _account.run(
        "pairwise_relmax_batched",
        lambda: kernel_cost("pairwise_relmax_batched", B=B, R=R, d=d),
        lambda: fn(x))


def pairwise_relmax(replicas: torch.Tensor, *,
                    impl: str | None = None) -> torch.Tensor:
    """(R, d) -> (R, R) relative max-difference matrix (K3 at B = 1)."""
    use = resolve_impl(impl, replicas.device)
    if use == "torch":
        return _mv.pairwise_relmax_plain(replicas)
    x = replicas.to(torch.float32)
    R, d = x.shape
    fn = _mv.pairwise_relmax_cuda if use == "cuda" else \
        (lambda t: t.new_empty((R, R)))
    return _account.run("pairwise_relmax",
                        lambda: kernel_cost("pairwise_relmax", R=R, d=d),
                        lambda: fn(x))


def vote(replicas: torch.Tensor, tau: float = 1e-5, *,
         impl: str | None = None):
    """Majority vote over R replicas (R, d): (value (d,), faulty (R,)
    bool, has_majority () bool) — the reference's ``ops.vote``
    (``repro/kernels/ops.py:117-132``) with the pairwise compare on
    ``pairwise_relmax``."""
    R = replicas.shape[0]
    rel = pairwise_relmax(replicas.to(torch.float32), impl=impl)
    agree = rel <= tau
    is_major = agree.sum(dim=1) > (R // 2)
    has_majority = is_major.any()
    winner = torch.argmax(is_major.to(torch.int8))
    return replicas[winner], ~agree[winner] & has_majority, has_majority


def batched_vote(replicas: torch.Tensor, group_of_worker: torch.Tensor,
                 tau: float = 1e-5, *, impl: str | None = None):
    """Majority votes for all replica groups of all trials at once.

    replicas (B, n, d); group_of_worker (B, n) int (-1 = idle).  Per
    group, the winner is the lowest-indexed worker that agrees with a
    strict in-group majority.  Returns (winner_coeff (B, n) f32, one-hot
    per group, faulty (B, n) bool) — the reference's epilogue
    (``repro/kernels/ops.py:175-208``) in torch.
    """
    rel = batched_pairwise_relmax(replicas, impl=impl)
    valid = group_of_worker >= 0
    same = (group_of_worker[:, :, None] == group_of_worker[:, None, :]) \
        & valid[:, None, :] & valid[:, :, None]
    agree = (rel <= tau) & same
    counts = agree.sum(dim=2)
    gsize = same.sum(dim=2)
    is_major = valid & (counts > gsize // 2)
    n = replicas.shape[1]
    idx = torch.arange(n, device=replicas.device)
    cand = torch.where(is_major, idx[None, :], n)
    first = torch.where(same, cand[:, None, :], n).amin(dim=2)
    winner_coeff = (valid & (idx[None, :] == first)).to(torch.float32)
    is_winner_row = torch.gather(
        agree, 2, first.clamp(max=n - 1)[:, :, None])[:, :, 0]
    faulty = valid & ~is_winner_row & (first < n)
    return winner_coeff, faulty


def batched_regroup(keys: torch.Tensor, active: torch.Tensor,
                    repl: torch.Tensor):
    """Masked replica regroup, the device control plane's assignment.

    keys (B, n) uint32 values in int64 (the PERM stream); active (B, n)
    bool; repl (B,) int replication factor.  Each trial's active workers
    are ordered by (key, worker id), the stable argsort of the host's
    ``CounterPermuter``, and the first m*r of that order form m =
    n_active // r groups of r consecutive workers.  One sort on the
    composite int64 key ``inactive << (32 + s) | key << s | w`` (s bits
    hold a worker id) gives the reference's lexsort order, ties in the
    keys included.  Returns (shard (B, n) int32, group (B, n) int32 with
    -1 = idle, m (B,) int32); inactive workers and the < r leftovers get
    group -1 and shard 0 (``ops.py:211`` of the reference).
    """
    B, n = active.shape
    s = max(1, (n - 1).bit_length())
    wi = torch.arange(n, dtype=torch.int64, device=keys.device)
    inact = (~active).to(torch.int64)
    comp = (inact << (32 + s)) | (keys.to(torch.int64) << s) | wi[None]
    order = torch.sort(comp, dim=1).indices
    rank = torch.empty_like(order).scatter_(
        1, order, wi[None].expand(B, n).contiguous())
    r = torch.clamp(repl.to(torch.int64), min=1)
    m = active.sum(dim=1) // r
    member = active & (rank < (m * r)[:, None])
    gid = rank // r[:, None]
    shard = torch.where(member, gid, 0).to(torch.int32)
    group = torch.where(member, gid, -1).to(torch.int32)
    return shard, group, m.to(torch.int32)


def batched_vote_masked(replicas: torch.Tensor, keys: torch.Tensor,
                        active: torch.Tensor, repl: torch.Tensor,
                        tau: float = 1e-5, *, gate: torch.Tensor | None = None,
                        impl: str | None = None):
    """Regroup each trial's active workers by the key permutation, then
    majority-vote per group (``batched_vote``: K3 on a CUDA tensor).
    ``gate`` (B,) bool idles whole trials.  Returns (winner_coeff,
    faulty, shard, group, m)."""
    shard, group, m = batched_regroup(keys, active, repl)
    gv = group if gate is None else torch.where(gate[:, None], group, -1)
    wc, faulty = batched_vote(replicas, gv, tau=tau, impl=impl)
    return wc, faulty, shard, group, m


def batched_detect_masked(symbols: torch.Tensor, keys: torch.Tensor,
                          active: torch.Tensor, repl: torch.Tensor,
                          tau: float = 1e-9, *,
                          gate: torch.Tensor | None = None):
    """Regroup, then flag trials whose replica groups mismatch on their
    detection symbols.  Returns (trial_fault (B,), worker_mismatch
    (B, n), shard, group, m)."""
    from repro_torch.core.detection import detect_groups_batched

    shard, group, m = batched_regroup(keys, active, repl)
    gv = group if gate is None else torch.where(gate[:, None], group, -1)
    fault, mism = detect_groups_batched(symbols, gv, tau=tau)
    return fault, mism, shard, group, m


def batched_sketch(flat_g: torch.Tensor, key_scalar, k: int = 256, *,
                   impl: str | None = None) -> torch.Tensor:
    """(B, d) -> (B, k) CountSketches under one shared key."""
    use = resolve_impl(impl, flat_g.device)
    if use == "meta":
        _account.refuse_meta("batched_sketch")
    if use == "cuda":
        return _sk.sketch_batched_cuda(flat_g.to(torch.float32), key_scalar, k)
    return _sk.sketch_batched_plain(flat_g, key_scalar, k)


def sketch(flat_g: torch.Tensor, key_scalar, k: int = 256, *,
           impl: str | None = None) -> torch.Tensor:
    """(d,) -> (k,) CountSketch (K4 at B = 1)."""
    use = resolve_impl(impl, flat_g.device)
    if use == "torch":
        return _sk.sketch_plain(flat_g, key_scalar, k)
    x = flat_g.to(torch.float32)
    fn = _sk.sketch_cuda if use == "cuda" else \
        (lambda t, key, kk: t.new_empty(kk))
    return _account.run("sketch",
                        lambda: kernel_cost("sketch", d=x.shape[0], k=k),
                        lambda: fn(x, key_scalar, k))


def sketch_shard(block: torch.Tensor, key_scalar, k: int, cfull: int,
                 c0: int, *, impl: str | None = None) -> torch.Tensor:
    """(rows, cols) block of a leaf viewed as (rows, cfull) from column
    c0 -> (k,) CountSketch under the full leaf's flat index (K4s's shard
    form): the shards' sketches of a leaf sum to its ``sketch``.  The
    kernel reads an f32 or bf16 block in its own dtype (no f32 copy)."""
    use = resolve_impl(impl, block.device)
    if use == "torch":
        return _sk.sketch_block_plain(block, key_scalar, k, cfull, c0)
    if block.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the shard form reads float32 or bfloat16 blocks, "
                        f"got {block.dtype}")
    fn = _sk.sketch_block_cuda if use == "cuda" else \
        (lambda t, key, kk, cf, c: torch.empty(kk, dtype=torch.float32,
                                               device=t.device))
    return _account.run("sketch_shard",
                        lambda: kernel_cost(
                            "sketch_shard", d=block.numel(), k=k,
                            dtype=str(block.dtype).removeprefix("torch.")),
                        lambda: fn(block, key_scalar, k, cfull, c0))


def batched_coded_encode(coeffs: torch.Tensor, grads: torch.Tensor, *,
                         impl: str | None = None) -> torch.Tensor:
    """(B, n_sym, m) @ (B, m, d) -> (B, n_sym, d) f32 per-trial encode."""
    use = resolve_impl(impl, grads.device)
    if use == "meta":
        _account.refuse_meta("batched_coded_encode")
    if use == "cuda":
        return _enc.coded_encode_batched_cuda(coeffs.to(torch.float32),
                                              grads.to(torch.float32))
    return _enc.coded_encode_batched_plain(coeffs, grads)


def coded_encode(coeffs: torch.Tensor, grads: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """(n_sym, m) @ (m, d) -> (n_sym, d) f32 (K5 at B = 1)."""
    use = resolve_impl(impl, grads.device)
    if use == "meta":
        _account.refuse_meta("coded_encode")
    if use == "cuda":
        return _enc.coded_encode_cuda(coeffs.to(torch.float32),
                                      grads.to(torch.float32))
    return _enc.coded_encode_plain(coeffs, grads)


def fused_step(rows: torch.Tensor, W: torch.Tensor, cw: torch.Tensor,
               key_scalar, *, k: int = 256, impl: str | None = None):
    """One fused protocol-step pass over the data plane: (rows (Ie, d)
    f32|bf16, W (B, d) f32, cw (B, Ie) f32, key) -> (W - cw @ rows,
    (W - cw @ rows) @ rows^T, CountSketch_k(rows)).  The CUDA route
    overwrites W with W' (see :mod:`repro_torch.kernels.fused_step`)."""
    use = resolve_impl(impl, W.device)
    if use == "meta":
        _account.refuse_meta("fused_step")
    if use == "cuda":
        return _fs.fused_step_cuda(rows, W, cw.to(torch.float32), key_scalar,
                                   k)
    return _fs.fused_step_plain(rows, W, cw, key_scalar, k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """GQA attention forward (K6): q (B, Sq, H, hd), k / v (B, Sk, K, hd)
    with K | H -> (B, Sq, H, hd) in q's dtype; causal with the queries
    aligned to the end of the keys, optional sliding ``window``.  Where
    autograd records (an input requires grad), the call goes through
    ``flash_attention.FlashAttention``: the same forward, with the plain
    version's gradient."""
    use = resolve_impl(impl, q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window, scale, use)
    return _fa.attend(q, k, v, causal, window, scale, use)
