"""Closed-form testbed for the paper's claims: the full master/worker
protocol on a noiseless least-squares problem (w* known exactly).

Port of ``repro.core.simulation``.  ``run_protocol`` is the SERIAL
reference: one trial, one Python loop, pure numpy.  Wide sweeps go
through the batched engine (``engine.run_batch``), which reproduces it
bitwise for matching configurations: both share the gradient primitives
of ``core.engine``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import filters as filters_mod
from repro_torch.core.assignment import (
    Assignment,
    group_members,
    identify_assignment,
)
from repro_torch.core.engine import (
    Attack,
    aggregate,
    losses_of,
    residuals,
    shard_gradients,
    worker_gradients,
)
from repro_torch.core.identification import majority_vote_np
from repro_torch.core.randomized import BFTConfig, ProtocolState

ATTACKS: dict[str, Attack] = {
    "none": lambda g: g,
    "sign_flip": lambda g: -5.0 * g,
    "scale": lambda g: 10.0 * g,
    "noise": lambda g: g + np.random.default_rng(0).normal(size=g.shape),
    "drift": lambda g: g + 1.0,
    "zero": lambda g: np.zeros_like(g),
}


def make_problem(n_data=256, d=8, seed=0):
    """Noiseless least squares: A ~ N(0, 1) (n_data, d), w* ~ N(0, 1),
    y = A w* — drawn in the reference's order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_data, d))
    w_true = rng.normal(size=d)
    return A, A @ w_true, w_true


@dataclasses.dataclass
class SimResult:
    w: np.ndarray
    w_true: np.ndarray
    state: ProtocolState
    losses: list
    q_trace: list
    identify_step: dict  # worker -> step identified

    @property
    def final_error(self) -> float:
        return float(np.linalg.norm(self.w - self.w_true))

    @property
    def efficiency(self) -> float:
        return self.state.meter.overall


def run_protocol(
    *,
    n: int = 8,
    f: int = 2,
    byz=(),
    attack: Attack | str = "sign_flip",
    p_tamper: float = 0.8,
    steps: int = 400,
    q: float | None = 0.4,
    mode: str = "randomized",
    filter_name: str = "median",
    selective: bool = False,
    lr: float = 0.05,
    seed: int = 1,
    problem_seed: int = 0,
    n_data: int = 256,
    d: int = 8,
) -> SimResult:
    if isinstance(attack, str):
        attack = ATTACKS[attack]
    A, y, w_true = make_problem(n_data=n_data, d=d, seed=problem_seed)
    A1, y1 = A[None], y[None]            # length-1 batch for the primitives
    bft_mode = "filter" if mode.startswith("filter") else mode
    bft = BFTConfig(n=n, f=f, mode=bft_mode, q=q, p_assumed=p_tamper,
                    selective=selective, seed=seed)
    st = ProtocolState.create(bft)
    rng = np.random.default_rng(seed + 1)
    w = np.zeros(A.shape[1])
    losses, q_trace = [], []
    ident_step: dict[int, int] = {}

    def tampered(a: Assignment, resid: np.ndarray) -> np.ndarray:
        """All n worker gradients for assignment ``a`` (the B=1 case of
        the engine's batched shard-gradient matmul), then the Byzantine
        attack."""
        m = a.num_shards
        rows = len(A) // m
        Ar = A[: m * rows].reshape(1, m, rows, A.shape[1])
        rr = resid[:, : m * rows].reshape(1, m, 1, rows)
        sg = shard_gradients(Ar, rr, rows)                 # (1, m, d)
        grads = worker_gradients(sg, a.shard_of_worker[None],
                                 a.group_of_worker[None])[0]
        for b in byz:
            if st.active[b] and rng.random() < p_tamper:
                grads[b] = attack(grads[b])
        return grads

    for t in range(steps):
        resid = residuals(A1, y1, w[None])                 # (1, n_data)
        loss = float(losses_of(resid)[0])
        losses.append(loss)
        used = computed = 0
        checked = identified = False

        if mode == "draco":
            # DRACO (Chen et al. 2018): PROACTIVE 2f+1 correction code in
            # every iteration — efficiency pinned at 1/(2f+1), no reactive
            # phase, no elimination (the paper's comparison point).
            a = identify_assignment(st.active, max(1, f), st.rng)
            grads = tampered(a, resid)
            votes = []
            for g in group_members(a):
                val, faulty, _ = majority_vote_np(grads[g], tau=1e-9)
                votes.append(val)
                for b in np.asarray(g)[np.asarray(faulty)]:
                    ident_step.setdefault(int(b), t)
            grad = np.mean(votes, axis=0)
            used, computed = a.num_shards, a.gradients_computed()
            checked = True
        elif mode in ("deterministic", "randomized") and st.decide_check(loss):
            checked = True
            a = st.assignment_check()
            grads = tampered(a, resid)
            used, computed = a.num_shards, a.gradients_computed()
            fault = any(
                np.abs(grads[g] - grads[g[0]]).max() > 1e-9
                for g in group_members(a)
            )
            if fault:
                identified = True
                ai = st.assignment_identify()
                grads_i = tampered(ai, resid)
                used += ai.num_shards
                computed += ai.gradients_computed()
                votes, newly = [], set()
                for g in group_members(ai):
                    val, faulty, ok = majority_vote_np(grads_i[g], tau=1e-9)
                    votes.append(val)
                    newly |= {int(x) for x in np.asarray(g)[np.asarray(faulty)]}
                if newly:
                    st.on_identified(np.asarray(sorted(newly)))
                    for b in newly:
                        ident_step[b] = t
                grad = np.mean(votes, axis=0)
            else:
                st.on_clean_check(np.flatnonzero(a.group_of_worker >= 0))
                grad = aggregate(a.weight[None], grads[None])[0]
        else:
            a = st.assignment_fast()
            grads = tampered(a, resid)
            used, computed = a.num_shards, a.gradients_computed()
            if mode.startswith("filter"):
                name = mode.split(":", 1)[1] if ":" in mode else filter_name
                # float32, as the reference's JAX filters compute
                grad = filters_mod.FILTERS[name](
                    torch.from_numpy(grads[st.active].astype(np.float32)),
                    max(1, f)).numpy()
            else:
                grad = aggregate(a.weight[None], grads[None])[0]

        st.meter.record(used, computed, checked=checked, identified=identified)
        q_trace.append(st.last_q)
        # float64 update regardless of grad provenance (votes and filters
        # come back float32) — keeps the serial reference bitwise aligned
        # with the engine's float64 batched update
        w = w - lr * np.asarray(grad, dtype=np.float64)
        st.step += 1
    return SimResult(w, w_true, st, losses, q_trace, ident_step)
