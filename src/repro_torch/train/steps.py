"""The BFT train steps (paper §4): fast, check, identify and filter.

Port of ``repro.train.steps``.  The reference runs each worker as one
shard of a ``shard_map`` over the ``data`` mesh axis and combines them
with ``psum`` / ``all_gather``.  Here the workers run as ranks of a
``torch.distributed`` group over that axis (``ranks=train.ranks.Ranks``):
each rank runs its block of n/W workers one after another on its
device; what the reference psums is a weighted f32 sum over the block
in worker order, then an all-reduce per leaf; what it gathers is each
rank's rows, all-gathered to (n, d) in worker order, one leaf at a
time.  Every rank then detects and votes on the same gathered bits, as
every device does in the reference, so the replicated parameters stay
equal with no broadcast.  With ``ranks=None`` one process runs all n
workers in order on one device, and the sums and stacks need no
collective.

With a ``model`` axis above 1 (``ranks.model``, a ``ModelAxis`` whose
``placements`` give each leaf's shard) a worker is that axis's ranks:
the model runs tensor- and expert-parallel over it (the ambient mesh,
``sharding.set_mesh``; ``models.parallel``), every per-leaf collective
over ``data`` moves this rank's shards, and what needs a whole leaf
reduces over ``model``: the check's symbol (the shards' partial
sketches, ``detection.sketch_tree``), the identify vote (K3 on the
shard, then a max over ``model``: exact, max has no order), full
detection's flags (an OR), the filters' distances and the clip's norm
(sums).  The tamper coin and key are the worker's, the same on each of
its ranks.

  fast_step      plain parallelized SGD (efficiency 1).
  check_step     replicated computation (r = f_t+1) + detection; the
                 update is applied iff NO fault is detected, otherwise
                 params and optimizer state are left bitwise unchanged
                 and grad_norm and lr are reported as 0 (the reference's
                 ``lax.cond``), and the trainer escalates.
  identify_step  reactive redundancy (r = 2f_t+1) + majority vote per
                 leaf on K3: the voted (exact) gradient is applied and
                 the per-worker Byzantine verdicts returned.
  filter_step    gradient-filter baselines over every worker's gradient.

Each worker's key is ``fold_in(fold_in(key, step), w)``; the identify
round reuses the check round's step, so a Byzantine worker that
tampered in the check tampers again.  A worker outside every replica
group (weight 0, group -1) computes nothing: the reference computes its
gradient and gives it weight 0 or masks it out, and the efficiency
meter does not count it.  Every step function takes (params, opt_state,
wbatch {tokens, labels (n, rows, S)}, weights (n,), byz_mask (n,),
[group_of_worker (n,),] key, step) and returns (params, opt_state,
metrics), updating the first two in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.core import byzantine, detection, prngkey, tree
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, opt_update


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    kind: str = "sign_flip"
    p_tamper: float = 1.0        # the paper's p_i: per-iteration tamper prob
    scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class StepConfig:
    detection: str = "sketch"    # "sketch" | "full"
    sketch_k: int = 256
    tau: float = 1e-5


def num_workers(weights) -> int:
    """Workers of a step: one weight each (the reference's product of
    the worker mesh axes)."""
    return len(weights)


class PhaseClock:
    """Seconds per phase of the step functions (forward, backward,
    tamper, sketch, detect, aggregate, vote, update), for the card's
    breakdown.  Each phase starts and ends with a device synchronize, so
    a clocked step serializes host and device; leave it off (None) for
    the step's own wall."""

    def __init__(self):
        self.s: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        sync = torch.cuda.synchronize if torch.cuda.is_available() \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.s[name] += time.perf_counter() - t0


def _phase(clock, name):
    return contextlib.nullcontext() if clock is None else clock(name)


def worker_key(key, step: int, w: int):
    return prngkey.fold_in(prngkey.fold_in(key, step), w)


def per_worker_grad(params, tokens, labels, byz, key, cfg, attack, *,
                    impl=None, clock=None, axis=None):
    """(loss () f32, gradient tree, did_tamper) of one worker's rows:
    the loss's gradient with respect to every leaf of ``params``
    (detached aliases, so ``params`` themselves need no grad), tampered
    as the worker's attack and coin say.  ``axis``: the worker's model
    axis, over which ``params`` are shards."""
    req = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with sharding.set_mesh(axis):
        with _phase(clock, "forward"):
            loss, _ = M.train_loss(tree.unflatten(params, req),
                                   {"tokens": tokens, "labels": labels}, cfg,
                                   impl=impl)
        with _phase(clock, "backward"):
            grads = torch.autograd.grad(loss, req)
    del req
    with _phase(clock, "tamper"):
        gtree, did = byzantine.maybe_tamper(
            tree.unflatten(params, list(grads)), is_byz=byz, key=key,
            attack=attack.kind, p_tamper=attack.p_tamper, scale=attack.scale,
            placements=None if axis is None else axis.placements)
    return loss.detach(), gtree, did


class _Workers:
    """Runs this rank's workers of one step in order and sums what the
    reference psums: w * loss and w * g (f32), in worker order; with
    ``ranks``, ``reduce_loss`` and ``aggregate`` then sum the ranks'
    partial sums and ``gather_rows`` gathers what the reference
    gathers."""

    def __init__(self, params, wbatch, weights, byz_mask, key, step, cfg,
                 attack, impl, clock, ranks=None):
        dev = tree.leaves(params)[0].device
        self.params, self.cfg, self.attack = params, cfg, attack
        self.impl, self.clock, self.key, self.step = impl, clock, key, step
        self.ranks = ranks
        self.axis = None if ranks is None else ranks.model
        n = len(weights)
        self.mine = range(n) if ranks is None else ranks.block(n)
        lo, hi = self.mine.start, self.mine.stop
        self.tokens = torch.as_tensor(np.asarray(wbatch["tokens"])[lo:hi],
                                      device=dev)
        self.labels = torch.as_tensor(np.asarray(wbatch["labels"])[lo:hi],
                                      device=dev)
        self.weights = np.asarray(weights, np.float32)
        self.byz = np.asarray(byz_mask, bool)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.gagg = None

    def local(self, workers) -> list[int]:
        """The ones of ``workers`` this rank runs, in order."""
        return [int(w) for w in workers if int(w) in self.mine]

    def grad(self, w: int):
        i = w - self.mine.start
        loss, g, _ = per_worker_grad(
            self.params, self.tokens[i], self.labels[i], self.byz[w],
            worker_key(self.key, self.step, w), self.cfg, self.attack,
            impl=self.impl, clock=self.clock, axis=self.axis)
        self.loss += float(self.weights[w]) * loss
        return g

    def accumulate(self, w: int, g) -> None:
        with _phase(self.clock, "aggregate"):
            wt = float(self.weights[w])
            scaled = [gl.to(torch.float32) * wt for gl in tree.leaves(g)]
            if self.gagg is None:
                self.gagg = scaled
            else:
                for a, s in zip(self.gagg, scaled):
                    a.add_(s)

    def reduce_loss(self) -> torch.Tensor:
        """The loss summed over the ranks (in place)."""
        if self.ranks is not None:
            with _phase(self.clock, "collective"):
                self.ranks.all_reduce_sum(self.loss.view(1))
        return self.loss

    def aggregate(self):
        """The weighted gradient sum, over the ranks one leaf at a time
        (a rank whose workers all sit out adds zeros)."""
        if self.ranks is not None:
            if self.gagg is None:
                self.gagg = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                             for p in tree.leaves(self.params)]
            with _phase(self.clock, "collective"):
                for leaf in self.gagg:
                    self.ranks.all_reduce_sum(leaf)
        return tree.unflatten(self.params, self.gagg)

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(n/W, ...) rows of this rank's workers -> (n, ...) in worker
        order."""
        if self.ranks is None:
            return rows
        with _phase(self.clock, "collective"):
            return self.ranks.all_gather_rows(rows)

    def split(self, i: int):
        """The model axis when leaf ``i`` is split over it, else None."""
        if self.axis is not None and self.axis.placements[i].sharded:
            return self.axis
        return None


def _members(weights) -> list[int]:
    return [int(w) for w in np.flatnonzero(np.asarray(weights) > 0)]


def _update(opt, gagg, opt_state, params, step, clock, run):
    with _phase(clock, "update"):
        return opt_update(opt, gagg, opt_state, params, step, axis=run.axis)


def make_fast_step(cfg, opt: OptConfig, sc: StepConfig, attack: AttackConfig,
                   *, impl: str | None = None, clock: PhaseClock | None = None,
                   ranks=None):
    """step_fn(params, opt_state, wbatch, weights, byz_mask, key, step):
    each rank sums its workers' weighted gradients, then one all-reduce
    a leaf."""

    def step_fn(params, opt_state, wbatch, weights, byz_mask, key, step):
        run = _Workers(params, wbatch, weights, byz_mask, key, step, cfg,
                       attack, impl, clock, ranks)
        for w in run.local(_members(weights)):
            run.accumulate(w, run.grad(w))
        params, opt_state, om = _update(opt, run.aggregate(), opt_state,
                                        params, step, clock, run)
        return params, opt_state, {"loss": run.reduce_loss(), **om}

    return step_fn


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; a ``meta`` tensor (the dry-run, ``launch.dryrun``)
    reads as zeros, i.e. no fault and no mismatch: the common branch."""
    return torch.zeros(t.shape, dtype=t.dtype) if t.is_meta else t.cpu()


def _leaf_rows(grads: dict, i: int, workers, like: torch.Tensor):
    """(len(workers), like.numel()) f32: row j is worker j's leaf ``i``
    (``grads``: {worker: [leaves]}), zero for a worker not in
    ``grads``; each copied leaf is released (one leaf at a time)."""
    rows = torch.zeros((len(workers), like.numel()), dtype=torch.float32,
                       device=like.device)
    for j, w in enumerate(workers):
        if w in grads:
            rows[j] = grads[w][i].reshape(-1)
            grads[w][i] = None
    return rows


def _detect_full(run, full: dict, group_of_worker, num_groups: int,
                 tau: float):
    """Paper-faithful detection: ``detect_groups`` on each leaf's full
    gradients gathered to (n, d), idle workers' rows zero (masked), the
    flags OR'ed over the leaves.  ``full``: {worker: [leaves]} of this
    rank's members.  A split leaf's flags are OR'ed over the model
    axis."""
    n = len(group_of_worker)
    fault = torch.zeros(num_groups, dtype=torch.bool)
    mism = torch.zeros(n, dtype=torch.bool)
    gow = torch.as_tensor(group_of_worker, device=run.loss.device)
    for i, leaf in enumerate(tree.leaves(run.params)):
        g_all = run.gather_rows(_leaf_rows(full, i, list(run.mine), leaf))
        f_leaf, m_leaf = detection.detect_groups(g_all, gow, num_groups, tau)
        del g_all
        ax = run.split(i)
        if ax is not None:
            flags = torch.cat([f_leaf, m_leaf]).to(torch.int32)
            ax.all_reduce_max(flags)
            f_leaf, m_leaf = flags[:num_groups] > 0, flags[num_groups:] > 0
        fault |= _to_host(f_leaf)
        mism |= _to_host(m_leaf)
    return fault, mism


def make_check_step(cfg, opt: OptConfig, sc: StepConfig, attack: AttackConfig,
                    num_groups: int, *, impl: str | None = None,
                    clock: PhaseClock | None = None, ranks=None):
    """step_fn(params, opt_state, wbatch, weights, byz_mask,
    group_of_worker, key, step); metrics hold any_fault (bool),
    group_fault (G,) and mismatch (n,).  Each rank sketches its members'
    gradients; the (n, k) sketches (or, with full detection, each leaf's
    (n, d) gradients) are gathered and every rank detects on them."""

    def step_fn(params, opt_state, wbatch, weights, byz_mask,
                group_of_worker, key, step):
        run = _Workers(params, wbatch, weights, byz_mask, key, step, cfg,
                       attack, impl, clock, ranks)
        gow = np.asarray(group_of_worker)
        dev = run.loss.device
        ks = detection.key_scalar_for_step(prngkey.fold_in(key, step))
        rows = torch.zeros((len(run.mine), sc.sketch_k),
                           dtype=torch.float32, device=dev)
        full = {}
        for w in run.local(np.flatnonzero(gow >= 0)):
            g = run.grad(w)
            if sc.detection == "sketch":
                with _phase(clock, "sketch"):
                    rows[w - run.mine.start] = detection.sketch_tree(
                        g, ks, sc.sketch_k, impl=impl, axis=run.axis)
            else:
                full[w] = [leaf.to(torch.float32) for leaf in tree.leaves(g)]
            run.accumulate(w, g)
            del g
        if sc.detection == "sketch":
            sketches = run.gather_rows(rows)
        with _phase(clock, "detect"):
            if sc.detection == "sketch":
                group_fault, mismatch = detection.detect_groups(
                    sketches, torch.as_tensor(gow, device=dev), num_groups,
                    sc.tau)
            else:
                group_fault, mismatch = _detect_full(run, full, gow,
                                                     num_groups, sc.tau)
            any_fault = not group_fault.is_meta and bool(group_fault.any())
        del full
        loss = run.reduce_loss()
        if any_fault:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            om = {"grad_norm": zero, "lr": zero}
        else:
            params, opt_state, om = _update(opt, run.aggregate(), opt_state,
                                            params, step, clock, run)
        return params, opt_state, {
            "loss": loss, "any_fault": any_fault,
            "group_fault": group_fault, "mismatch": mismatch, **om}

    return step_fn


def vote_leaf(reps: torch.Tensor, tau: float, *, impl: str | None = None,
              axis=None):
    """Majority vote per replica group of one leaf: reps (G, r, d) f32 ->
    (value (d,): the mean over groups of each group's winner, faulty
    (G, r) bool).

    agree[g, i, j] = rel <= tau with rel from ``ops.batched_pairwise_
    relmax`` (K3 on a CUDA tensor): max over the leaf of |a - b| / (1 +
    min(|a|, |b|)).  The reference tests |a - b| <= tau * (1 + min(|a|,
    |b|)) elementwise; the two agree except where a quotient lies within
    an ulp of tau.  The winner is the first row with a strict majority
    (row 0 when none has one), faulty = not agree[winner].  ``axis``:
    the model axis when ``reps`` hold one shard of the leaf: the shard's
    (G, r, r) maxima are maxed over it, the whole leaf's exactly."""
    G, r = reps.shape[:2]
    rel = ops.batched_pairwise_relmax(reps, impl=impl)
    if axis is not None:
        axis.all_reduce_max(rel)
    agree = rel <= tau
    counts = agree.sum(dim=-1)
    winner = torch.argmax((counts > r // 2).to(torch.int8), dim=-1)
    rows = torch.arange(G, device=reps.device)
    faulty = ~agree[rows, winner]
    return reps[rows, winner].mean(dim=0), faulty


def make_identify_step(cfg, opt: OptConfig, sc: StepConfig,
                       attack: AttackConfig, members: np.ndarray, *,
                       impl: str | None = None,
                       clock: PhaseClock | None = None, ranks=None):
    """``members``: (G, r) worker ids per replica group.  Metrics hold
    byz (n,) bool, the workers the vote found faulty.  The update uses
    the voted (exact) gradient: the paper's recovery.  Each leaf's
    gradients are gathered to (n, d) and every rank votes on them."""
    members = np.asarray(members)
    G, r = members.shape
    order = members.reshape(-1)

    def step_fn(params, opt_state, wbatch, weights, byz_mask, key, step):
        run = _Workers(params, wbatch, weights, byz_mask, key, step, cfg,
                       attack, impl, clock, ranks)
        n = num_workers(weights)
        grads = {w: tree.leaves(run.grad(w))
                 for w in run.local(sorted(order))}
        dev = run.loss.device
        pick = torch.as_tensor(order, device=dev)
        faulty_all = torch.zeros((G, r), dtype=torch.bool, device=dev)
        voted = []
        for i, leaf in enumerate(tree.leaves(params)):
            with _phase(clock, "vote"):
                if ranks is None:
                    reps = _leaf_rows(grads, i, [int(w) for w in order],
                                      leaf)
                else:
                    g_all = run.gather_rows(
                        _leaf_rows(grads, i, list(run.mine), leaf))
                    reps = g_all[pick]
                    del g_all
                value, faulty = vote_leaf(reps.reshape(G, r, -1), sc.tau,
                                          impl=impl, axis=run.split(i))
                del reps
                faulty_all |= faulty
                voted.append(value.reshape(leaf.shape))
        byz = np.zeros(n, bool)
        byz[order] = _to_host(faulty_all.reshape(-1)).numpy()
        params, opt_state, om = _update(opt, tree.unflatten(params, voted),
                                        opt_state, params, step, clock, run)
        return params, opt_state, {"loss": run.reduce_loss(), "byz": byz,
                                   **om}

    return step_fn


def make_filter_step(cfg, opt: OptConfig, sc: StepConfig, attack: AttackConfig,
                     filter_name: str, f: int, *, impl: str | None = None,
                     clock: PhaseClock | None = None, ranks=None):
    """Gradient-filter baseline (paper §3 related work / §5 combo): every
    worker's gradient, robust-aggregated leafwise (KRUM / median /
    trimmed mean / GMoM / norm clip); no redundancy, no exact fault
    tolerance.  Every worker computes, as in the reference (an inactive
    one reads shard 0's rows); each leaf's (n, d) gradients are gathered
    and every rank filters them."""
    from repro_torch.core.filters import FILTERS

    fn_filter = FILTERS[filter_name]

    def step_fn(params, opt_state, wbatch, weights, byz_mask, key, step):
        run = _Workers(params, wbatch, weights, byz_mask, key, step, cfg,
                       attack, impl, clock, ranks)
        grads = {w: tree.leaves(run.grad(w)) for w in run.mine}
        filtered = []
        for i, leaf in enumerate(tree.leaves(params)):
            with _phase(clock, "aggregate"):
                g_all = run.gather_rows(
                    _leaf_rows(grads, i, list(run.mine), leaf))
                ax = run.split(i)
                filtered.append(fn_filter(
                    g_all, f, reduce=None if ax is None else
                    ax.all_reduce_sum).reshape(leaf.shape))
                del g_all
        params, opt_state, om = _update(opt, tree.unflatten(params, filtered),
                                        opt_state, params, step, clock, run)
        return params, opt_state, {"loss": run.reduce_loss(), **om}

    return step_fn
