"""Batched scenario engine: B independent protocol trials in one pass,
on the host, in numpy.

Port of ``repro.core.engine``.  ``run_batch`` (``backend="numpy"``) is
the reference's host engine copied as it stands: worker gradients for
all trials come from batched matmuls that keep the serial path's
per-item operand shapes, protocol state is held as (B, n) arrays whose
rows are the trials' ``ProtocolState`` views, the check coins and
tamper draws are pre-drawn from the trials' seeded streams, and the
efficiency accounting is vectorized.  The same numpy arithmetic on the
same inputs gives the reference's bits: the engine is the bitwise
parity oracle of ``simulation.run_protocol`` and the control plane of
the "oracle" and "proxy" schedules of ``engine_torch.build_schedule``,
which hand its recorded schedule (``ScheduleRecorder``) to the device
data plane.  Its only step out of numpy is the filter baselines, which
run ``core.filters`` on a float32 CPU tensor (the reference's JAX
filters compute in float32).  ``backend="torch"`` dispatches to the
device engine ``engine_torch.run_batch``.

Also here: ``replay_control_fast``, the control-only replay of
value-independent trials (the "vector" schedule), under both stream
contracts — the host's numpy generators (``rng="host"``) and the
counter-RNG streams of ``rng="device"`` (``core.rngstream``) — and
``replay_control_from_trace``, which rebuilds the whole control plane
from the device control plane's decision trace.  ``ScenarioMatrix`` is
the declarative front end (a named grid of attacks x modes x fault
patterns x seeds) and ``SCENARIOS`` the reference's named matrices;
``ScenarioMatrix.run`` goes to the card unless the caller asks for the
host (``backend="numpy"``, or ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import adaptive, filters as filters_mod, rngstream
from repro_torch.core.assignment import (
    Assignment,
    BatchedAssignment,
    fast_assignment_batched,
)
from repro_torch.core.engineplan.plan import (
    ExecutionPlan,
    device_schedulable,
    spec_display_names,
    value_independent_control,
)
from repro_torch.core.identification import majority_vote_np
from repro_torch.core.randomized import BFTConfig, ProtocolState, decide_generator
from repro_torch.obs.telemetry import Telemetry, zero_counts

Attack = Callable[[np.ndarray], np.ndarray]

# ---------------------------------------------------------------------------
# Shared numerical primitives (used by BOTH run_protocol and the engine).
#
# All batched contractions are np.matmul with leading batch dimensions:
# numpy iterates the batch dims and issues the SAME per-item BLAS call
# the serial (B=1) path issues, so results are bitwise identical no
# matter how many trials share the pass (one big GEMM would change the
# accumulation pattern).
# ---------------------------------------------------------------------------


def residuals(A_b: np.ndarray, y_b: np.ndarray, W: np.ndarray,
              out: np.ndarray | None = None) -> np.ndarray:
    """(B, I, d), (B, I), (B, d) -> (B, I) residual A w - y per trial.

    ``out``: optional (B, I, 1) scratch buffer (the engine reuses one
    across steps; the result aliases it)."""
    prod = np.matmul(A_b, W[:, :, None], out=out)
    return np.subtract(prod[:, :, 0], y_b, out=prod[:, :, 0])


def losses_of(resid: np.ndarray) -> np.ndarray:
    """(B, I) residuals -> (B,) mean-squared losses."""
    return (resid ** 2).mean(axis=1)


def shard_gradients(A_chunks: np.ndarray, resid_chunks: np.ndarray,
                    rows: int) -> np.ndarray:
    """Least-squares shard gradients, one contraction per (trial, shard).

    A_chunks: (B|1, m, rows, d) — the global batch cut into m contiguous
    shards of ``rows`` rows (remainder dropped); resid_chunks:
    (B, m, 1, rows).  Returns (B, m, d): 2/rows * A_s^T resid_s.
    """
    return 2.0 * np.matmul(resid_chunks, A_chunks)[:, :, 0, :] / rows


def worker_gradients(shard_g: np.ndarray, shard_of_worker: np.ndarray,
                     group_of_worker: np.ndarray) -> np.ndarray:
    """Scatter shard gradients to the workers that computed them.

    shard_g: (B, m, d); shard/group_of_worker: (B, n).  Every member of
    a replica group receives (a copy of) its shard's gradient; idle
    workers (group -1) get zeros.  -> (B, n, d)
    """
    B = shard_g.shape[0]
    g = shard_g[_arange(B)[:, None], shard_of_worker]
    idle = group_of_worker < 0
    if not idle.any():            # nobody idle: the mask is all-ones
        return g
    g[idle] = 0.0
    return g


@functools.lru_cache(maxsize=64)
def _arange(k: int) -> np.ndarray:
    """Cached read-only ``np.arange(k)`` (``lru_cache`` is thread-safe)."""
    out = np.arange(k)
    out.setflags(write=False)
    return out


def aggregate(weight: np.ndarray, grads: np.ndarray) -> np.ndarray:
    """(B, n) float32 weights x (B, n, d) grads -> (B, d) updates.

    Mixed-dtype matmul promotes the weights to float64 internally —
    verified bitwise-identical to an explicit astype."""
    return np.matmul(weight[:, None, :], grads)[:, 0, :]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Membership-churn event applied at the START of ``step``."""

    step: int
    kind: str                    # "crash" | "recover"
    workers: tuple[int, ...]

    def __post_init__(self):
        if self.kind not in ("crash", "recover"):
            raise ValueError(f"unknown fault event kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One protocol trial.  Fields mirror ``run_protocol``'s keyword
    arguments exactly; ``onset``/``events`` are engine-only extensions
    (late-onset Byzantine behavior, crash/recover churn).  ``attack`` is
    a name of ``simulation.ATTACKS`` or a callable on one gradient row
    (the numpy engine runs any callable; the device engine takes the
    affine table)."""

    n: int = 8
    f: int = 2
    byz: tuple[int, ...] = ()
    attack: "Attack | str" = "sign_flip"
    p_tamper: float = 0.8
    steps: int = 400
    q: float | None = 0.4
    mode: str = "randomized"
    filter_name: str = "median"
    selective: bool = False
    lr: float = 0.05
    seed: int = 1
    problem_seed: int = 0
    n_data: int = 256            # least-squares problem rows
    d: int = 8                   # gradient dimension
    onset: int = 0               # byz workers behave honestly before this step
    events: tuple[FaultEvent, ...] = ()
    label: str = ""

    def __post_init__(self):
        object.__setattr__(self, "byz", tuple(self.byz))
        object.__setattr__(self, "events", tuple(self.events))

    def protocol_kwargs(self) -> dict:
        """The run_protocol(**kwargs) equivalent of this spec (drops the
        engine-only fields)."""
        return {k: getattr(self, k) for k in (
            "n", "f", "byz", "attack", "p_tamper", "steps", "q", "mode",
            "filter_name", "selective", "lr", "seed", "problem_seed",
            "n_data", "d")}


class BatchedProtocolState:
    """Protocol state for B trials as (B, n_max) arrays; ``trial(b)`` is a
    ``ProtocolState`` whose array fields are row views into them."""

    def __init__(self, cfgs: list[BFTConfig]):
        B = len(cfgs)
        self.n_max = max(c.n for c in cfgs)
        self.active = np.zeros((B, self.n_max), bool)
        self.identified = np.zeros((B, self.n_max), bool)
        self.crashed = np.zeros((B, self.n_max), bool)
        self.alpha = np.full((B, self.n_max), 0.5)
        self.beta = np.full((B, self.n_max), 0.5)
        self.states: list[ProtocolState] = []
        for b, cfg in enumerate(cfgs):
            k = cfg.n
            self.active[b, :k] = True
            self.states.append(ProtocolState(
                cfg=cfg,
                active=self.active[b, :k],
                identified=self.identified[b, :k],
                crashed=self.crashed[b, :k],
                alpha=self.alpha[b, :k],
                beta=self.beta[b, :k],
                rng=np.random.default_rng(cfg.seed),
                decide_rng=decide_generator(cfg.seed),
            ))

    def trial(self, b: int) -> ProtocolState:
        return self.states[b]


# Vectorized attack application: ATTACKS semantics row by row, applied to
# a (k, d) stack of tampered gradient rows at once.  "noise" reseeds a
# generator PER ROW in the serial path, so it (and custom callables)
# falls back to the per-row loop.
_VEC_ATTACKS: dict[str, Callable] = {
    "none": lambda g: g,
    "sign_flip": lambda g: -5.0 * g,
    "scale": lambda g: 10.0 * g,
    "drift": lambda g: g + 1.0,
    "zero": lambda g: np.zeros_like(g),
}


def _attack_table():
    from repro_torch.core.simulation import ATTACKS

    return ATTACKS


def _grouped_rows(n: int, act_idx: np.ndarray, r: int,
                  rng: np.random.Generator):
    """``build_assignment(active, r, rng)`` without the per-group loop —
    one permutation of the active indices, as the reference draws it.
    Returns (Assignment, members (m, r) sorted within each group)."""
    perm = rng.permutation(act_idx)
    m = len(perm) // r
    if m == 0:
        raise ValueError(
            f"not enough active workers ({len(perm)}) for replication {r}"
        )
    shard = np.zeros(n, np.int32)
    group = np.full(n, -1, np.int32)
    weight = np.zeros(n, np.float32)
    mem = perm[: m * r]
    gid = _gid(m, r)
    shard[mem] = gid
    group[mem] = gid
    weight[mem] = 1.0 / (r * m)
    a = Assignment(shard, group, weight, m, r, np.zeros(n, np.int32))
    return a, np.sort(mem.reshape(m, r), axis=1)


@functools.lru_cache(maxsize=256)
def _gid(m: int, r: int) -> np.ndarray:
    """Cached read-only group-id pattern [0,0,..,1,1,..]."""
    out = np.repeat(np.arange(m, dtype=np.int32), r)
    out.setflags(write=False)
    return out


def _grouped_rows_into(batch_a: BatchedAssignment, b: int,
                       act_idx: np.ndarray, r: int,
                       rng: np.random.Generator) -> tuple:
    """In-place ``_grouped_rows``: writes trial b's rows of the batch
    assignment (same RNG consumption) and returns (m, members(m, r))."""
    perm = rng.permutation(act_idx)
    m = len(perm) // r
    if m == 0:
        raise ValueError(
            f"not enough active workers ({len(perm)}) for replication {r}"
        )
    mem = perm[: m * r]
    gid = _gid(m, r)
    shard = batch_a.shard_of_worker[b]
    group = batch_a.group_of_worker[b]
    weight = batch_a.weight[b]
    shard[:] = 0
    group[:] = -1
    weight[:] = 0.0
    shard[mem] = gid
    group[mem] = gid
    weight[mem] = 1.0 / (r * m)
    batch_a.num_shards[b] = m
    return m, np.sort(mem.reshape(m, r), axis=1)


class _Trial:
    """Per-trial runtime bookkeeping."""

    __slots__ = ("spec", "st", "attack_name", "attack_fn", "ident_step",
                 "events_by_step", "act_idx", "m1", "r1", "mem1")

    def __init__(self, spec: TrialSpec, st: ProtocolState):
        self.spec = spec
        self.st = st
        if isinstance(spec.attack, str):
            if spec.attack not in _attack_table():
                raise KeyError(spec.attack)   # eager, like run_protocol
            self.attack_name = spec.attack
            self.attack_fn = None         # resolved lazily for fallback rows
        else:
            self.attack_name = None
            self.attack_fn = spec.attack
        self.ident_step: dict[int, int] = {}
        self.events_by_step: dict[int, list[FaultEvent]] = {}
        for ev in spec.events:
            self.events_by_step.setdefault(ev.step, []).append(ev)


class _TamperStreams:
    """Pre-drawn Byzantine tamper streams for the whole batch: one uniform
    per (phase, active Byzantine worker), in ``byz`` order, from
    default_rng(seed + 1), held as a (B, max_draws) matrix with
    per-trial cursors."""

    def __init__(self, specs, trials):
        B = len(specs)
        self.p = np.array([s.p_tamper for s in specs])
        self.onset = np.array([s.onset for s in specs])
        max_draws = max((2 * s.steps * len(s.byz) for s in specs), default=0)
        self.u = np.zeros((B, max(1, max_draws)))
        for b, s in enumerate(specs):
            k = 2 * s.steps * len(s.byz)
            if k:
                self.u[b, :k] = np.random.default_rng(s.seed + 1).random(k)
        self.cursor = np.zeros(B, np.int64)
        self.trials = trials
        self.specs = specs
        self.nb = np.zeros(B, np.int64)
        self.wid = np.zeros((B, 1), np.int64)
        self.refresh()

    def refresh(self, only: "list[int] | None" = None):
        """Rebuild the active-byz view for all trials, or just ``only``."""
        if only is not None and self.wid.size:
            for b in only:
                lst = [w for w in self.specs[b].byz
                       if self.trials[b].st.active[w]]
                self.nb[b] = len(lst)
                self.wid[b, :len(lst)] = lst
                self.wid[b, len(lst):] = 0
            return
        lists = [[w for w in s.byz if self.trials[b].st.active[w]]
                 for b, s in enumerate(self.specs)]
        self.nb = np.fromiter((len(x) for x in lists), np.int64, len(lists))
        width = max(1, int(self.nb.max()) if len(lists) else 1)
        self.wid = np.zeros((len(lists), width), np.int64)
        for b, x in enumerate(lists):
            self.wid[b, :len(x)] = x

    def phase1_hits(self, t: int, live: np.ndarray):
        """Vectorized phase-1 decisions: (hit_b, hit_w) index arrays."""
        elig = live & (self.nb > 0) & (t >= self.onset)
        if not elig.any():
            return None
        hb, hw = [], []
        for j in range(int(self.nb[elig].max())):
            rows = np.flatnonzero(elig & (self.nb > j))
            u = self.u[rows, self.cursor[rows] + j]
            hit = rows[u < self.p[rows]]
            if hit.size:
                hb.append(hit)
                hw.append(self.wid[hit, j])
        self.cursor[elig] += self.nb[elig]
        if not hb:
            return None
        return np.concatenate(hb), np.concatenate(hw)

    def phase2_hits(self, b: int, t: int) -> list[int]:
        """Per-trial phase-2 (identify pass) decisions."""
        if t < self.onset[b] or not self.nb[b]:
            return []
        k = int(self.nb[b])
        u = self.u[b, self.cursor[b]: self.cursor[b] + k]
        self.cursor[b] += k
        return [int(w) for w, ui in zip(self.wid[b, :k], u)
                if ui < self.p[b]]


def _install_device_streams(specs, trials) -> rngstream.StepClock:
    """Swap every trial's permutation generator for the counter-indexed
    ``CounterPermuter`` (the PERM stream) and return the shared step
    clock the replay advances once per iteration."""
    clock = rngstream.StepClock()
    for s, tr in zip(specs, trials):
        tr.st.rng = rngstream.CounterPermuter(
            rngstream.perm_keys(s.seed, s.steps, s.n), clock)
    return clock


class _DeviceTamperStreams(_TamperStreams):
    """``rng="device"`` tamper decisions: a worker's coin at (t, phase)
    is the TAMPER stream's pure function of (seed, t, phase, w), compared
    in float32 against p as the device does, and never depends on which
    other workers are active."""

    def __init__(self, specs, trials):
        B = len(specs)
        self.p32 = np.array([s.p_tamper for s in specs], np.float32)
        self.onset = np.array([s.onset for s in specs])
        self.u = [rngstream.tamper_uniforms(s.seed, s.steps, s.n)
                  if s.byz else None for s in specs]
        self.trials = trials
        self.specs = specs
        self.nb = np.zeros(B, np.int64)
        self.wid = np.zeros((B, 1), np.int64)
        self.refresh()

    def phase1_hits(self, t: int, live: np.ndarray):
        elig = live & (self.nb > 0) & (t >= self.onset)
        if not elig.any():
            return None
        hb, hw = [], []
        for b in np.flatnonzero(elig):
            w = self.wid[b, : self.nb[b]]
            hit = w[self.u[b][t, 0, w] < self.p32[b]]
            if hit.size:
                hb.append(np.full(hit.size, b, np.int64))
                hw.append(hit)
        if not hb:
            return None
        return np.concatenate(hb), np.concatenate(hw)

    def phase2_hits(self, b: int, t: int) -> list[int]:
        if t < self.onset[b] or not self.nb[b]:
            return []
        w = self.wid[b, : self.nb[b]]
        return [int(x) for x in w[self.u[b][t, 1, w] < self.p32[b]]]


_VEC_ATTACK_ORDER = list(_VEC_ATTACKS)


def attack_codes(trials) -> np.ndarray:
    """(B,) int codes: index into _VEC_ATTACK_ORDER, -1 = per-row
    fallback ("noise", custom callables)."""
    return np.array([
        _VEC_ATTACK_ORDER.index(t.attack_name)
        if t.attack_name in _VEC_ATTACKS else -1
        for t in trials
    ])


def _apply_attacks(grads: np.ndarray, hit_b: np.ndarray, hit_w: np.ndarray,
                   trials, codes: np.ndarray) -> None:
    """Apply attacks for tamper hits in place — vectorized per attack
    kind, per-row for non-vectorizable attacks ("noise", callables)."""
    hc = codes[hit_b]
    for c in np.unique(hc):
        sel = hc == c
        bi, wi = hit_b[sel], hit_w[sel]
        if c >= 0:
            grads[bi, wi] = _VEC_ATTACKS[_VEC_ATTACK_ORDER[c]](grads[bi, wi])
        else:
            for b, w in zip(bi, wi):
                tr = trials[b]
                fn = tr.attack_fn or _attack_table()[tr.attack_name]
                grads[b, w] = fn(grads[b, w])


@dataclasses.dataclass
class BatchResult:
    """Results of one engine pass, in spec order, with the device run's
    extras: the resolved plan, the host schedule, and the scan's
    per-step detection verdicts."""

    specs: list[TrialSpec]
    results: list                # list[SimResult]
    elapsed_s: float = 0.0
    plan: "ExecutionPlan | None" = None
    telemetry: "Telemetry | None" = None   # run_batch(telemetry=True)
    schedule: object = None      # engine_torch.Schedule
    detect_flags: "np.ndarray | None" = None   # (T, B) bool
    device_trace: "dict | None" = None  # schedule="device": the decisions
    fused_used: bool = False
    phase_s: "dict[str, float] | None" = None  # wall seconds per phase

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]

    def by_label(self) -> dict:
        return {s.label or str(i): r
                for i, (s, r) in enumerate(zip(self.specs, self.results))}

    def summarize(self, key=lambda s: s.label.rsplit("/", 1)[0]) -> list[dict]:
        """Aggregate trials sharing ``key(spec)`` (default: label minus
        the trailing /sN seed suffix) into mean error/efficiency/kappa
        rows — the shape of the paper's comparison tables."""
        groups: dict[str, list] = {}
        for s, r in zip(self.specs, self.results):
            groups.setdefault(key(s), []).append(r)
        rows = []
        for name, rs in groups.items():
            rows.append({
                "scenario": name,
                "trials": len(rs),
                "final_error": float(np.mean([r.final_error for r in rs])),
                "efficiency": float(np.mean([r.efficiency for r in rs])),
                "identified": float(np.mean([r.state.kappa for r in rs])),
                "exact": bool(np.mean([r.final_error for r in rs]) < 1e-3),
            })
        return rows



def _q_fixed(spec: TrialSpec, f_t: int) -> float:
    """check_probability for the pre-drawable trial classes."""
    if spec.mode == "none" or f_t == 0:
        return 0.0
    if spec.mode == "deterministic":
        return 1.0
    return float(spec.q)


class ScheduleRecorder:
    """Per-step control trace: one dict of (B, ...) arrays per iteration
    (check decisions, assignments, tamper hits of both phases, identify
    events, aggregation weights, live/active masks)."""

    def __init__(self):
        self.steps: list[dict] = []

    def on_step(self, **arrays) -> None:
        self.steps.append(arrays)


def run_batch(specs: list[TrialSpec], *, backend: str = "numpy",
              rng: str = "host", telemetry: bool = False,
              _recorder: "ScheduleRecorder | None" = None,
              **backend_kwargs) -> BatchResult:
    """Run B independent protocol trials in one vectorized pass.

    ``backend="numpy"`` (default) is the host engine below, the bitwise
    parity oracle.  ``backend="torch"`` dispatches to the device engine
    (``engine_torch.run_batch``, on the CUDA device unless
    ``device="cpu"`` is passed): same protocol, exact on control
    quantities and float-tolerance close on values.

    ``telemetry=True`` accumulates the per-trial protocol counters
    (``obs.telemetry``) into ``BatchResult.telemetry``; the primary
    outputs are bitwise identical either way.

    ``rng`` selects the decision-stream contract: ``"host"`` (default)
    is the PCG64 streams shared with ``run_protocol``; ``"device"``
    swaps in the counter-indexed threefry streams of ``core.rngstream``
    that the device control plane (``schedule="device"``) reproduces bit
    for bit, defined only for ``device_schedulable`` trials.

    ``_recorder``: a ``ScheduleRecorder`` that receives every step's
    control arrays (the "oracle" / "proxy" schedules).

    Rare, trial-local work (check-iteration detection, reactive votes,
    state transitions) stays per trial, replaying each trial's seeded
    streams exactly; the every-step path (residuals, shard gradients,
    fixed-q check decisions, fast-mode assignments, aggregation,
    efficiency accounting) is batched.
    """
    from repro_torch.core.simulation import SimResult, make_problem

    if backend == "torch":
        from repro_torch.core.engine_torch import run_batch as run_batch_torch

        if rng != "host":
            raise ValueError(
                'backend="torch" takes schedule="device" instead of '
                'rng="device" (the device scan IS the device stream)')
        return run_batch_torch(specs, telemetry=telemetry, **backend_kwargs)
    if backend != "numpy":
        raise ValueError(f"unknown engine backend {backend!r}")
    if backend_kwargs:
        raise TypeError(
            f"numpy backend takes no extra kwargs: {sorted(backend_kwargs)}")
    if rng not in ("host", "device"):
        raise ValueError(f"unknown rng stream contract {rng!r}")
    device_rng = rng == "device"

    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    B = len(specs)
    if B == 0:
        return BatchResult([], [], 0.0,
                           telemetry=Telemetry.from_counts(zero_counts(0))
                           if telemetry else None)

    # -- problems (cached by (problem_seed, dims); trials share n_data, d) --
    dims = {(s.n_data, s.d) for s in specs}
    if len(dims) != 1:
        raise ValueError(f"trials must share (n_data, d), got {sorted(dims)}")
    problems: dict[tuple, tuple] = {}
    for s in specs:
        key = (s.problem_seed, s.n_data, s.d)
        if key not in problems:
            problems[key] = make_problem(n_data=s.n_data, d=s.d,
                                         seed=s.problem_seed)
    shared_problem = len(problems) == 1

    def _problem(s: TrialSpec) -> tuple:
        return problems[(s.problem_seed, s.n_data, s.d)]

    A0 = _problem(specs[0])[0]
    n_data, d = A0.shape
    if shared_problem:
        _, y0, wt0 = _problem(specs[0])
        A_b = np.broadcast_to(A0, (B, n_data, d))
        y_b = np.broadcast_to(y0, (B, n_data))
        w_true = [wt0] * B
    else:
        A_b = np.empty((B, n_data, d))
        y_b = np.empty((B, n_data))
        w_true = []
        for b, s in enumerate(specs):
            A, y, wt = _problem(s)
            A_b[b], y_b[b] = A, y
            w_true.append(wt)

    # -- batched protocol state ------------------------------------------
    cfgs = []
    for s in specs:
        bft_mode = "filter" if s.mode.startswith("filter") else s.mode
        cfgs.append(BFTConfig(n=s.n, f=s.f, mode=bft_mode, q=s.q,
                              p_assumed=s.p_tamper, selective=s.selective,
                              seed=s.seed))
    bstate = BatchedProtocolState(cfgs)
    n_max = bstate.n_max
    trials = [_Trial(s, bstate.trial(b)) for b, s in enumerate(specs)]
    if device_rng:
        bad = [not device_schedulable(s) for s in specs]
        if any(bad):
            raise ValueError(
                "device RNG streams undefined for trials: "
                f"{spec_display_names(specs, bad)}")
        clock = _install_device_streams(specs, trials)
        streams = _DeviceTamperStreams(specs, trials)
    else:
        clock = None
        streams = _TamperStreams(specs, trials)
    att_codes = attack_codes(trials)
    for tr in trials:
        tr.act_idx = np.flatnonzero(tr.st.active)

    steps_arr = np.array([s.steps for s in specs])
    T_max = int(steps_arr.max())
    lr = np.array([s.lr for s in specs])
    W = np.zeros((B, d))

    # -- trial classes & pre-drawn decision streams ----------------------
    # decide_rng advances once per iteration for deterministic/randomized
    # trials; pre-draw those streams and decide fixed-q trials in one
    # vectorized compare per step.  Adaptive (q=None) trials share the
    # pre-drawn stream but compute q_t from the step's loss; selective
    # trials draw (n,) vectors per step and stay on ProtocolState.
    is_decider = np.array([s.mode in ("deterministic", "randomized")
                           for s in specs])
    is_selective = np.array([s.selective and bool(is_decider[b])
                             for b, s in enumerate(specs)])
    is_adaptive = np.array([s.q is None and s.mode == "randomized"
                            and not is_selective[b]
                            for b, s in enumerate(specs)])
    is_vec = is_decider & ~is_selective & ~is_adaptive
    u_mat = np.zeros((B, T_max))
    for b, s in enumerate(specs):
        if (is_vec[b] or is_adaptive[b]) and s.steps:
            # consume the trial's own decide stream: same values as
            # step-wise draws, and the stream is not used elsewhere for
            # non-selective trials
            u_mat[b, :s.steps] = (
                rngstream.decide_uniforms(s.seed, s.steps)
                if device_rng
                else bstate.trial(b).decide_rng.random(s.steps))
    q_eff = np.array([_q_fixed(s, s.f) if is_vec[b] else 0.0
                      for b, s in enumerate(specs)])
    if device_rng:          # device compares in f32; fixed-q bits agree
        q_eff = q_eff.astype(np.float32).astype(np.float64)
    vec_idx = np.flatnonzero(is_vec)
    adaptive_idx = np.flatnonzero(is_adaptive)
    selective_idx = np.flatnonzero(is_selective)
    filter_trials = np.flatnonzero(
        [s.mode.startswith("filter") for s in specs])
    draco_trials = [b for b, s in enumerate(specs) if s.mode == "draco"]
    draco_mask = np.zeros(B, bool)
    draco_mask[draco_trials] = True
    has_byz = [b for b, s in enumerate(specs) if s.byz]
    has_events = [b for b, s in enumerate(specs) if s.events]

    # -- vectorized efficiency accounting --------------------------------
    used_acc = np.zeros(B, np.int64)
    comp_acc = np.zeros(B, np.int64)
    check_acc = np.zeros(B, np.int64)
    ident_acc = np.zeros(B, np.int64)
    eff_hist = np.zeros((B, T_max))
    losses_mat = np.zeros((B, T_max))
    q_trace_mat = np.zeros((B, T_max))
    last_q = np.zeros(B)
    if telemetry:
        # the oracle side of the cross-backend counter-equality contract
        # (see obs.telemetry for the per-key semantics)
        tel_np = zero_counts(B)
        byz_mask = np.zeros((B, n_max), bool)
        for b, s in enumerate(specs):
            if s.byz:
                byz_mask[b, list(s.byz)] = True

    # residual fault budget per trial (f - kappa, floored at 0), kept as
    # an array so the adaptive/fixed-q hot paths never touch ProtocolState
    f_t_arr = np.array([s.f for s in specs])
    uniform_steps = bool((steps_arr == T_max).all())
    vec_all = bool(is_vec.all())

    # fast-mode assignments change only when membership changes
    # (identification / crash / recover) — cache them between changes
    fast_cache = fast_assignment_batched(bstate.active)
    n_active = bstate.active.sum(axis=1)
    dirty_trials: list[int] = []

    # finished-trial rows are never read (weights zeroed, W frozen), so
    # the gradient buffer can stay uninitialized between steps
    grads = np.empty((B, n_max, d))
    resid_buf = np.empty((B, n_data, 1))

    live_const = np.ones(B, bool)

    for t in range(T_max):
        if uniform_steps:
            live, live_all = live_const, True
        else:
            live = steps_arr > t
            live_all = bool(live.all())

        if clock is not None:
            clock.t = t

        if _recorder is not None:  # phase-2 capture buffers for this step
            rec_sh2 = np.zeros((B, n_max), np.int32)
            rec_gr2 = np.full((B, n_max), -1, np.int32)
            rec_m2 = np.ones(B, np.int64)
            rec_tam2 = np.zeros((B, n_max), bool)

        # -- membership churn events (engine-only) ------------------------
        for b in has_events:
            if live[b]:
                for ev in trials[b].events_by_step.get(t, ()):
                    ws = np.asarray(ev.workers)
                    if ev.kind == "crash":
                        trials[b].st.on_crash(ws)
                    else:
                        trials[b].st.on_recover(ws)
                    dirty_trials.append(b)

        if dirty_trials:
            fast_cache = fast_assignment_batched(
                bstate.active | ~live[:, None])
            n_active = (bstate.active & live[:, None]).sum(axis=1)
            streams.refresh(only=dirty_trials)
            for b in dirty_trials:
                trials[b].act_idx = np.flatnonzero(trials[b].st.active)
            dirty_trials = []

        # -- losses (shared residual also feeds the gradients) ------------
        resid = residuals(A_b, y_b, W, out=resid_buf)        # (B, I)
        loss_col = losses_of(resid)                          # (B,)
        losses_mat[:, t] = loss_col

        # -- check decisions ----------------------------------------------
        if vec_all:
            checks = u_mat[:, t] < q_eff
            last_q[:] = q_eff
        else:
            checks = np.zeros(B, bool)
            if vec_idx.size:
                checks[vec_idx] = u_mat[vec_idx, t] < q_eff[vec_idx]
                last_q[vec_idx] = q_eff[vec_idx]
            for b in adaptive_idx:
                if live[b]:
                    f_t = f_t_arr[b]
                    if f_t <= 0:
                        q_t = 0.0
                    else:
                        lam = adaptive.lam_from_loss(float(loss_col[b]))
                        trials[b].st.last_lambda = lam
                        q_t = adaptive.q_star(int(f_t), specs[b].p_tamper,
                                              lam)
                        if device_rng:  # device compares q*_t in f32
                            q_t = float(np.float32(q_t))
                    last_q[b] = q_t
                    checks[b] = u_mat[b, t] < q_t
            for b in selective_idx:
                if live[b]:
                    checks[b] = trials[b].st.decide_check(float(loss_col[b]))
                    last_q[b] = trials[b].st.last_q
        if not live_all:
            checks &= live
        q_trace_mat[:, t] = last_q

        # -- phase-1 assignments ------------------------------------------
        # cached fast rows for everyone, then overwrite the RNG-permuted
        # check / draco rows trial-by-trial (copy-on-write)
        check_idx = np.flatnonzero(checks)
        if check_idx.size or draco_trials:
            batch_a = BatchedAssignment(
                fast_cache.shard_of_worker.copy(),
                fast_cache.group_of_worker.copy(),
                fast_cache.weight.copy(),
                fast_cache.num_shards.copy(),
            )
            for b in check_idx:
                tr = trials[b]
                r1 = max(1, int(f_t_arr[b])) + 1
                m1, mem = _grouped_rows_into(batch_a, b, tr.act_idx, r1,
                                             tr.st.rng)
                tr.m1, tr.r1, tr.mem1 = m1, r1, mem
            for b in draco_trials:
                if live[b]:
                    tr, s = trials[b], specs[b]
                    r1 = 2 * max(1, s.f) + 1
                    m1, mem = _grouped_rows_into(batch_a, b, tr.act_idx, r1,
                                                 tr.st.rng)
                    tr.m1, tr.r1, tr.mem1 = m1, r1, mem
        else:
            batch_a = fast_cache

        is_fast = np.ones(B, bool)
        is_fast[check_idx] = False
        for b in draco_trials:
            is_fast[b] = False

        if live_all:
            group_all = batch_a.group_of_worker
        else:
            group_all = np.where(live[:, None], batch_a.group_of_worker, -1)
        shard_all = batch_a.shard_of_worker
        m_all = batch_a.num_shards

        # -- shard gradients: one batched matmul per distinct m -----------
        for m in np.unique(m_all if live_all else m_all[live]):
            m = int(m)
            is_m = m_all == m
            if not live_all:
                is_m &= live
            sub = np.flatnonzero(is_m)
            rows = n_data // m
            if shared_problem:
                Ar = A0[: m * rows].reshape(1, m, rows, d)
            else:
                Ar = A_b[sub, : m * rows].reshape(len(sub), m, rows, d)
            rr = resid[sub, : m * rows].reshape(len(sub), m, 1, rows)
            sg = shard_gradients(Ar, rr, rows)               # (S, m, d)
            if m == n_max and (group_all[sub] >= 0).all():
                # fast mode, nobody eliminated: worker w owns shard w —
                # the gather is the identity, skip it
                if sub.size == B:
                    grads = sg
                else:
                    grads[sub] = sg
            else:
                grads[sub] = worker_gradients(sg, shard_all[sub],
                                              group_all[sub])

        # -- Byzantine tampering (phase 1) --------------------------------
        hits = streams.phase1_hits(t, live) if has_byz else None
        if hits is not None:
            _apply_attacks(grads, hits[0], hits[1], trials, att_codes)

        # -- verdicts ------------------------------------------------------
        # fast-path counters vectorized; check/draco/filter per trial
        fast_live = is_fast if live_all else (is_fast & live)
        used_t = np.where(fast_live, m_all, 0)
        comp_t = np.where(fast_live, n_active, 0)
        identified_t = np.zeros(B, bool)
        agg_weight = np.where(fast_live[:, None], batch_a.weight,
                              np.float32(0.0))
        voted: dict[int, np.ndarray] = {}

        for b in draco_trials:
            if not live[b]:
                continue
            tr = trials[b]
            votes = []
            for g in tr.mem1:
                val, faulty, _ = majority_vote_np(grads[b][g], tau=1e-9)
                votes.append(val)
                for w_id in g[faulty]:
                    tr.ident_step.setdefault(int(w_id), t)
            # mean of a single vote is the vote (bitwise): skip the stack
            voted[b] = votes[0] if len(votes) == 1 else np.mean(votes,
                                                               axis=0)
            used_t[b] = tr.m1
            comp_t[b] = tr.m1 * tr.r1

        for b in check_idx:
            tr, st, s = trials[b], trials[b].st, specs[b]
            used_t[b] = tr.m1
            comp_t[b] = tr.m1 * tr.r1
            gm = grads[b][tr.mem1]               # (m, r, d) replica groups
            if np.abs(gm - gm[:, :1]).max() > 1e-9:
                identified_t[b] = True
                ai, mem_i = _grouped_rows(s.n, tr.act_idx,
                                          2 * max(1, int(f_t_arr[b])) + 1,
                                          st.rng)
                rows = n_data // ai.num_shards
                Ar = (A0 if shared_problem else A_b[b])[: ai.num_shards *
                                                        rows]
                Ar = Ar.reshape(1, ai.num_shards, rows, d)
                rr = resid[b, : ai.num_shards * rows].reshape(
                    1, ai.num_shards, 1, rows)
                sg = shard_gradients(Ar, rr, rows)
                g2 = worker_gradients(sg, ai.shard_of_worker[None],
                                      ai.group_of_worker[None])[0]
                tam = streams.phase2_hits(b, t)
                if tam:
                    _apply_attacks(g2[None], np.zeros(len(tam), np.int64),
                                   np.asarray(tam), [tr], att_codes[b:b + 1])
                    if telemetry:
                        tel_np["tamper_events"][b] += len(tam)
                if _recorder is not None:
                    k = len(ai.shard_of_worker)
                    rec_sh2[b, :k] = ai.shard_of_worker
                    rec_gr2[b, :k] = ai.group_of_worker
                    rec_m2[b] = ai.num_shards
                    if tam:
                        rec_tam2[b, tam] = True
                used_t[b] += ai.num_shards
                comp_t[b] += ai.num_shards * ai.replication
                votes, newly = [], set()
                for g in mem_i:
                    val, faulty, _ = majority_vote_np(g2[g], tau=1e-9)
                    votes.append(val)
                    newly |= {int(x) for x in g[faulty]}
                if telemetry:
                    tel_np["eliminations"][b] += len(newly)
                if newly:
                    st.on_identified(np.asarray(sorted(newly)))
                    for w_id in newly:
                        tr.ident_step[w_id] = t
                    f_t_arr[b] = max(0, s.f - st.kappa)
                    dirty_trials.append(b)
                    if is_vec[b]:
                        q_eff[b] = _q_fixed(s, int(f_t_arr[b]))
                        if device_rng:
                            q_eff[b] = np.float32(q_eff[b])
                voted[b] = (votes[0] if len(votes) == 1
                            else np.mean(votes, axis=0))
                agg_weight[b] = 0.0
            else:
                st.on_clean_check(tr.mem1.ravel())
                agg_weight[b] = batch_a.weight[b]

        for b in filter_trials:
            if not live[b]:
                continue
            st, s = trials[b].st, specs[b]
            name = (s.mode.split(":", 1)[1] if ":" in s.mode
                    else s.filter_name)
            # float32, as the reference's JAX filters compute
            act = np.flatnonzero(st.active)
            voted[b] = filters_mod.FILTERS[name](
                torch.from_numpy(grads[b][act].astype(np.float32)),
                max(1, s.f)).numpy()
            agg_weight[b] = 0.0

        if _recorder is not None:
            tam1 = np.zeros((B, n_max), bool)
            if hits is not None:
                tam1[hits[0], hits[1]] = True
            _recorder.on_step(
                live=live.copy(), checks=checks.copy(),
                vote1=(draco_mask & live),
                shard1=np.array(shard_all), group1=np.array(group_all),
                m1=np.asarray(m_all, np.int64).copy(),
                aggw=agg_weight.copy(), tam1=tam1,
                identify=identified_t.copy(),
                shard2=rec_sh2, group2=rec_gr2, m2=rec_m2, tam2=rec_tam2,
                active=bstate.active.copy(),
            )

        # -- accounting + update ------------------------------------------
        used_acc += used_t
        comp_acc += comp_t
        check_acc += (checks | draco_mask) & live
        ident_acc += identified_t
        eff_hist[:, t] = used_t / np.maximum(1, comp_t)
        if telemetry:
            draco_live = draco_mask & live
            tel_np["steps"] += live
            tel_np["checks"] += checks
            tel_np["redundant_steps"] += checks | draco_live
            tel_np["detects"] += identified_t
            tel_np["identify_rounds"] += identified_t
            tel_np["vote_rounds"] += identified_t | draco_live
            if hits is not None:
                np.add.at(tel_np["tamper_events"], hits[0], 1)
            # post-elimination, matching the recorder's `active` capture
            tel_np["byz_active_steps"] += np.where(
                live, (byz_mask & bstate.active).sum(axis=1), 0)

        grad_upd = aggregate(agg_weight, grads)
        for b, v in voted.items():
            grad_upd[b] = v
        W = np.where(live[:, None], W - lr[:, None] * grad_upd, W)

    # -- materialize per-trial results ------------------------------------
    results = []
    for b, s in enumerate(specs):
        tr, st = trials[b], trials[b].st
        st.step = s.steps
        meter = st.meter
        meter.used = int(used_acc[b])
        meter.computed = int(comp_acc[b])
        meter.iterations = s.steps
        meter.check_iterations = int(check_acc[b])
        meter.identify_iterations = int(ident_acc[b])
        meter.history = eff_hist[b, :s.steps].tolist()
        st.last_q = float(q_trace_mat[b, s.steps - 1]) if s.steps else 0.0
        results.append(SimResult(
            w=W[b].copy(),
            w_true=w_true[b],
            state=st,
            losses=losses_mat[b, :s.steps].tolist(),
            q_trace=q_trace_mat[b, :s.steps].tolist(),
            identify_step=tr.ident_step,
        ))
    tel_obj = None
    if telemetry:
        tel_obj = Telemetry.from_counts(
            tel_np, specs=specs,
            q_traces=[q_trace_mat[b, :s.steps]
                      for b, s in enumerate(specs)])
    return BatchResult(specs, results, time.perf_counter() - t_start,
                       telemetry=tel_obj)


def _control_results(specs, trials, used_acc, comp_acc, check_acc,
                     ident_acc, eff_hist, q_trace_mat,
                     t_start: float) -> BatchResult:
    """The replays' control results (no float quantities): each trial's
    meters, q-trace, identify steps and final state."""
    from repro_torch.core.simulation import SimResult

    empty = np.zeros(0)
    results = []
    for b, s in enumerate(specs):
        tr, st = trials[b], trials[b].st
        st.step = s.steps
        meter = st.meter
        meter.used = int(used_acc[b])
        meter.computed = int(comp_acc[b])
        meter.iterations = s.steps
        meter.check_iterations = int(check_acc[b])
        meter.identify_iterations = int(ident_acc[b])
        meter.history = eff_hist[b, :s.steps].tolist()
        st.last_q = float(q_trace_mat[b, s.steps - 1]) if s.steps else 0.0
        results.append(SimResult(
            w=empty,
            w_true=empty,
            state=st,
            losses=[],
            q_trace=q_trace_mat[b, :s.steps].tolist(),
            identify_step=tr.ident_step,
        ))
    return BatchResult(specs, results, time.perf_counter() - t_start)


def replay_control_fast(specs: list[TrialSpec],
                        recorder: "ScheduleRecorder | None" = None,
                        *, rng: str = "host") -> BatchResult:
    """Control-plane-only replay of value-independent trials.

    Detection is decided analytically: a replica group mismatches iff
    it mixes tampered and honest workers (affine attacks act
    identically on identical shard copies), and the majority vote flags
    the group's minority side.  ``rng="device"`` draws the decide,
    tamper and permutation variates from the counter-RNG streams
    (``core.rngstream``) in place of the numpy generators, with the
    fixed q compared in float32 as the device compares it.  Results
    carry control quantities only: ``w``/``w_true`` are empty and
    ``losses`` is ``[]``.
    """
    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    bad = [not value_independent_control(s) for s in specs]
    if any(bad):
        raise ValueError(
            "control-only replay invalid for value-dependent trials: "
            f"{spec_display_names(specs, bad)}")
    if rng not in ("host", "device"):
        raise ValueError(f"unknown rng stream contract {rng!r}")
    device_rng = rng == "device"
    if device_rng:
        bad = [not device_schedulable(s) for s in specs]
        if any(bad):
            raise ValueError("device RNG streams undefined for trials: "
                             f"{spec_display_names(specs, bad)}")
    B = len(specs)
    if B == 0:
        return BatchResult([], [], 0.0)

    cfgs = []
    for s in specs:
        bft_mode = "filter" if s.mode.startswith("filter") else s.mode
        cfgs.append(BFTConfig(n=s.n, f=s.f, mode=bft_mode, q=s.q,
                              p_assumed=s.p_tamper, selective=s.selective,
                              seed=s.seed))
    bstate = BatchedProtocolState(cfgs)
    n_max = bstate.n_max
    trials = [_Trial(s, bstate.trial(b)) for b, s in enumerate(specs)]
    clock = _install_device_streams(specs, trials) if device_rng else None
    streams = (_DeviceTamperStreams if device_rng
               else _TamperStreams)(specs, trials)
    for tr in trials:
        tr.act_idx = np.flatnonzero(tr.st.active)

    steps_arr = np.array([s.steps for s in specs])
    T_max = int(steps_arr.max()) if B else 0

    is_decider = np.array([s.mode in ("deterministic", "randomized")
                           for s in specs])
    is_selective = np.array([s.selective and bool(is_decider[b])
                             for b, s in enumerate(specs)])
    is_vec = is_decider & ~is_selective
    u_mat = np.zeros((B, T_max))
    for b, s in enumerate(specs):
        if is_vec[b] and s.steps:
            u_mat[b, :s.steps] = (
                rngstream.decide_uniforms(s.seed, s.steps) if device_rng
                else bstate.trial(b).decide_rng.random(s.steps))
    q_eff = np.array([_q_fixed(s, s.f) if is_vec[b] else 0.0
                      for b, s in enumerate(specs)])
    if device_rng:          # the device compares in f32
        q_eff = q_eff.astype(np.float32).astype(np.float64)
    vec_idx = np.flatnonzero(is_vec)
    selective_idx = np.flatnonzero(is_selective)
    filter_trials = np.flatnonzero(
        [s.mode.startswith("filter") for s in specs])
    draco_trials = [b for b, s in enumerate(specs) if s.mode == "draco"]
    draco_mask = np.zeros(B, bool)
    draco_mask[draco_trials] = True
    has_byz = [b for b, s in enumerate(specs) if s.byz]
    has_events = [b for b, s in enumerate(specs) if s.events]
    # does the trial's attack change a tampered gradient at all?
    perturbs = np.array([bool(s.byz) and s.attack != "none" for s in specs])

    used_acc = np.zeros(B, np.int64)
    comp_acc = np.zeros(B, np.int64)
    check_acc = np.zeros(B, np.int64)
    ident_acc = np.zeros(B, np.int64)
    eff_hist = np.zeros((B, T_max))
    q_trace_mat = np.zeros((B, T_max))
    last_q = np.zeros(B)

    f_t_arr = np.array([s.f for s in specs])
    uniform_steps = bool((steps_arr == T_max).all())
    vec_all = bool(is_vec.all())

    fast_cache = fast_assignment_batched(bstate.active)
    n_active = bstate.active.sum(axis=1)
    dirty_trials: list[int] = []
    live_const = np.ones(B, bool)

    # shared read-only templates for identify-free / tamper-free steps
    zero_sh2 = np.zeros((B, n_max), np.int32)
    zero_gr2 = np.full((B, n_max), -1, np.int32)
    zero_m2 = np.ones(B, np.int64)
    zero_tam = np.zeros((B, n_max), bool)
    zero_ident = np.zeros(B, bool)
    for a in (zero_sh2, zero_gr2, zero_m2, zero_tam, zero_ident):
        a.setflags(write=False)

    def _vote_minority(members: np.ndarray, tam_row: np.ndarray) -> set:
        """Majority-vote faulty set over (m, r) replica groups, decided
        combinatorially (odd r => no ties)."""
        hit = tam_row[members]
        cnt = hit.sum(axis=1)
        r = members.shape[1]
        newly: set[int] = set()
        for g in range(members.shape[0]):
            if 0 < cnt[g]:
                flag = hit[g] if cnt[g] <= r // 2 else ~hit[g]
                newly |= {int(w) for w in members[g][flag]}
        return newly

    for t in range(T_max):
        if uniform_steps:
            live, live_all = live_const, True
        else:
            live = steps_arr > t
            live_all = bool(live.all())

        rec_sh2 = rec_gr2 = rec_m2 = rec_tam2 = None   # allocated on use
        if clock is not None:
            clock.t = t

        for b in has_events:
            if live[b]:
                for ev in trials[b].events_by_step.get(t, ()):
                    ws = np.asarray(ev.workers)
                    if ev.kind == "crash":
                        trials[b].st.on_crash(ws)
                    else:
                        trials[b].st.on_recover(ws)
                    dirty_trials.append(b)

        if dirty_trials:
            fast_cache = fast_assignment_batched(
                bstate.active | ~live[:, None])
            n_active = (bstate.active & live[:, None]).sum(axis=1)
            streams.refresh(only=dirty_trials)
            for b in dirty_trials:
                trials[b].act_idx = np.flatnonzero(trials[b].st.active)
            dirty_trials = []

        # -- check decisions (every trial is loss-independent)
        if vec_all:
            checks = u_mat[:, t] < q_eff
            last_q[:] = q_eff
        else:
            checks = np.zeros(B, bool)
            if vec_idx.size:
                checks[vec_idx] = u_mat[vec_idx, t] < q_eff[vec_idx]
                last_q[vec_idx] = q_eff[vec_idx]
            for b in selective_idx:
                if live[b]:
                    checks[b] = trials[b].st.decide_check(None)
                    last_q[b] = trials[b].st.last_q
        if not live_all:
            checks &= live
        q_trace_mat[:, t] = last_q

        # -- phase-1 assignments (copy-on-write over the fast layout)
        check_idx = np.flatnonzero(checks)
        if check_idx.size or draco_trials:
            batch_a = BatchedAssignment(
                fast_cache.shard_of_worker.copy(),
                fast_cache.group_of_worker.copy(),
                fast_cache.weight.copy(),
                fast_cache.num_shards.copy(),
            )
            for b in check_idx:
                tr = trials[b]
                r1 = max(1, int(f_t_arr[b])) + 1
                m1, mem = _grouped_rows_into(batch_a, b, tr.act_idx, r1,
                                             tr.st.rng)
                tr.m1, tr.r1, tr.mem1 = m1, r1, mem
            for b in draco_trials:
                if live[b]:
                    tr, s = trials[b], specs[b]
                    r1 = 2 * max(1, s.f) + 1
                    m1, mem = _grouped_rows_into(batch_a, b, tr.act_idx, r1,
                                                 tr.st.rng)
                    tr.m1, tr.r1, tr.mem1 = m1, r1, mem
        else:
            batch_a = fast_cache

        is_fast = np.ones(B, bool)
        is_fast[check_idx] = False
        for b in draco_trials:
            is_fast[b] = False

        if live_all:
            group_all = batch_a.group_of_worker
        else:
            group_all = np.where(live[:, None], batch_a.group_of_worker, -1)
        shard_all = batch_a.shard_of_worker
        m_all = batch_a.num_shards

        # -- Byzantine tampering (phase 1), decision bits only
        hits = streams.phase1_hits(t, live) if has_byz else None
        if hits is None:
            tam1 = zero_tam
        else:
            tam1 = np.zeros((B, n_max), bool)
            tam1[hits[0], hits[1]] = True

        # -- verdicts, decided analytically
        all_fast = not check_idx.size and not draco_trials \
            and not filter_trials.size
        if all_fast and live_all:
            used_t, comp_t = m_all, n_active
            identified_t = zero_ident
            agg_weight = batch_a.weight
        else:
            fast_live = is_fast if live_all else (is_fast & live)
            used_t = np.where(fast_live, m_all, 0)
            comp_t = np.where(fast_live, n_active, 0)
            identified_t = np.zeros(B, bool)
            agg_weight = np.where(fast_live[:, None], batch_a.weight,
                                  np.float32(0.0))

        for b in draco_trials:
            if not live[b]:
                continue
            tr = trials[b]
            used_t[b] = tr.m1
            comp_t[b] = tr.m1 * tr.r1
            if perturbs[b]:
                for w_id in sorted(_vote_minority(tr.mem1, tam1[b])):
                    tr.ident_step.setdefault(int(w_id), t)

        for b in check_idx:
            tr, st, s = trials[b], trials[b].st, specs[b]
            used_t[b] = tr.m1
            comp_t[b] = tr.m1 * tr.r1
            # replica mismatch iff some group mixes tampered + honest
            hit = tam1[b][tr.mem1]
            cnt = hit.sum(axis=1)
            if perturbs[b] and bool(((0 < cnt) & (cnt < tr.r1)).any()):
                identified_t[b] = True
                ai, mem_i = _grouped_rows(s.n, tr.act_idx,
                                          2 * max(1, int(f_t_arr[b])) + 1,
                                          st.rng)
                tam = streams.phase2_hits(b, t)
                tam2_row = np.zeros(n_max, bool)
                if tam:
                    tam2_row[tam] = True
                if recorder is not None:
                    if rec_sh2 is None:
                        rec_sh2 = zero_sh2.copy()
                        rec_gr2 = zero_gr2.copy()
                        rec_m2 = zero_m2.copy()
                        rec_tam2 = zero_tam.copy()
                    k = len(ai.shard_of_worker)
                    rec_sh2[b, :k] = ai.shard_of_worker
                    rec_gr2[b, :k] = ai.group_of_worker
                    rec_m2[b] = ai.num_shards
                    if tam:
                        rec_tam2[b, tam] = True
                used_t[b] += ai.num_shards
                comp_t[b] += ai.num_shards * ai.replication
                newly = _vote_minority(mem_i, tam2_row)
                if newly:
                    st.on_identified(np.asarray(sorted(newly)))
                    for w_id in newly:
                        tr.ident_step[w_id] = t
                    f_t_arr[b] = max(0, s.f - st.kappa)
                    dirty_trials.append(b)
                    if is_vec[b]:
                        q_eff[b] = _q_fixed(s, int(f_t_arr[b]))
                        if device_rng:
                            q_eff[b] = np.float32(q_eff[b])
                agg_weight[b] = 0.0
            else:
                st.on_clean_check(tr.mem1.ravel())
                agg_weight[b] = batch_a.weight[b]

        for b in filter_trials:
            if live[b]:
                agg_weight[b] = 0.0

        if recorder is not None:
            # only the in-place-updated active mask needs a snapshot;
            # every other recorded array is fresh or copy-on-write
            recorder.on_step(
                live=live, checks=checks,
                vote1=(draco_mask & live),
                shard1=shard_all, group1=group_all,
                m1=np.asarray(m_all, np.int64),
                aggw=agg_weight, tam1=tam1,
                identify=identified_t,
                shard2=zero_sh2 if rec_sh2 is None else rec_sh2,
                group2=zero_gr2 if rec_gr2 is None else rec_gr2,
                m2=zero_m2 if rec_m2 is None else rec_m2,
                tam2=zero_tam if rec_tam2 is None else rec_tam2,
                active=bstate.active.copy(),
            )

        used_acc += used_t
        comp_acc += comp_t
        check_acc += (checks | draco_mask) & live
        ident_acc += identified_t
        eff_hist[:, t] = used_t / np.maximum(1, comp_t)

    return _control_results(specs, trials, used_acc, comp_acc, check_acc,
                            ident_acc, eff_hist, q_trace_mat, t_start)


def replay_control_from_trace(specs: list[TrialSpec | dict], trace: dict,
                              recorder: "ScheduleRecorder | None" = None,
                              ) -> BatchResult:
    """Rebuild the full control plane from a device decision trace.

    ``trace`` is the device control plane's per-step record under the
    ``rng="device"`` streams: ``q`` (T, B) float, the q*_t each trial
    compared against; ``check`` (T, B) bool, the checks that fired;
    ``detect`` (T, B) bool, the checks whose replicas mismatched;
    ``faulty2`` (T, B, n) bool, the workers the identify vote flagged.
    Everything else (replica-group permutations, tamper bits, shard
    assignments, efficiency meters, eliminations) is a pure function of
    (seed, t, phase, worker) through the counter streams, so the replay
    recomputes it exactly without a data plane.  Value-dependent trials
    are fine here: their value-dependent decisions arrive in the trace.
    Results carry control quantities only (``w``/``w_true`` empty,
    ``losses == []``); the engine grafts the device's values on.
    """
    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    bad = [not device_schedulable(s) for s in specs]
    if any(bad):
        raise ValueError("device RNG streams undefined for trials: "
                         f"{spec_display_names(specs, bad)}")
    B = len(specs)
    if B == 0:
        return BatchResult([], [], 0.0)

    cfgs = [BFTConfig(n=s.n, f=s.f, mode=s.mode, q=s.q, p_assumed=s.p_tamper,
                      selective=s.selective, seed=s.seed) for s in specs]
    bstate = BatchedProtocolState(cfgs)
    n_max = bstate.n_max
    trials = [_Trial(s, bstate.trial(b)) for b, s in enumerate(specs)]
    clock = _install_device_streams(specs, trials)
    streams = _DeviceTamperStreams(specs, trials)
    for tr in trials:
        tr.act_idx = np.flatnonzero(tr.st.active)

    steps_arr = np.array([s.steps for s in specs])
    T_max = int(steps_arr.max())

    tr_q = np.asarray(trace["q"], np.float64)
    tr_check = np.asarray(trace["check"], bool)
    tr_detect = np.asarray(trace["detect"], bool)
    tr_faulty2 = np.asarray(trace["faulty2"], bool)
    want = {"q": (T_max, B), "check": (T_max, B), "detect": (T_max, B),
            "faulty2": (T_max, B, n_max)}
    for name, arr in (("q", tr_q), ("check", tr_check),
                      ("detect", tr_detect), ("faulty2", tr_faulty2)):
        if arr.shape != want[name]:
            raise ValueError(f"trace[{name!r}] has shape {arr.shape}, "
                             f"expected {want[name]}")

    used_acc = np.zeros(B, np.int64)
    comp_acc = np.zeros(B, np.int64)
    check_acc = np.zeros(B, np.int64)
    ident_acc = np.zeros(B, np.int64)
    eff_hist = np.zeros((B, T_max))
    q_trace_mat = np.zeros((B, T_max))

    f_t_arr = np.array([s.f for s in specs])
    uniform_steps = bool((steps_arr == T_max).all())

    fast_cache = fast_assignment_batched(bstate.active)
    n_active = bstate.active.sum(axis=1)
    dirty_trials: list[int] = []
    live_const = np.ones(B, bool)

    zero_sh2 = np.zeros((B, n_max), np.int32)
    zero_gr2 = np.full((B, n_max), -1, np.int32)
    zero_m2 = np.ones(B, np.int64)
    zero_tam = np.zeros((B, n_max), bool)
    for a in (zero_sh2, zero_gr2, zero_m2, zero_tam):
        a.setflags(write=False)

    for t in range(T_max):
        if uniform_steps:
            live, live_all = live_const, True
        else:
            live = steps_arr > t
            live_all = bool(live.all())

        rec_sh2 = rec_gr2 = rec_m2 = rec_tam2 = None   # allocated on use
        clock.t = t

        if dirty_trials:
            fast_cache = fast_assignment_batched(
                bstate.active | ~live[:, None])
            n_active = (bstate.active & live[:, None]).sum(axis=1)
            streams.refresh(only=dirty_trials)
            for b in dirty_trials:
                trials[b].act_idx = np.flatnonzero(trials[b].st.active)
            dirty_trials = []

        # -- decisions come from the trace
        checks = tr_check[t] & live
        q_trace_mat[:, t] = np.where(live, tr_q[t], 0.0)

        # -- phase-1 assignments (copy-on-write over the fast layout)
        check_idx = np.flatnonzero(checks)
        if check_idx.size:
            batch_a = BatchedAssignment(
                fast_cache.shard_of_worker.copy(),
                fast_cache.group_of_worker.copy(),
                fast_cache.weight.copy(),
                fast_cache.num_shards.copy(),
            )
            for b in check_idx:
                tr = trials[b]
                r1 = max(1, int(f_t_arr[b])) + 1
                m1, mem = _grouped_rows_into(batch_a, b, tr.act_idx, r1,
                                             tr.st.rng)
                tr.m1, tr.r1, tr.mem1 = m1, r1, mem
        else:
            batch_a = fast_cache

        if live_all:
            group_all = batch_a.group_of_worker
        else:
            group_all = np.where(live[:, None], batch_a.group_of_worker, -1)
        shard_all = batch_a.shard_of_worker
        m_all = batch_a.num_shards

        # -- tamper bits (phase 1)
        hits = streams.phase1_hits(t, live)
        if hits is None:
            tam1 = zero_tam
        else:
            tam1 = np.zeros((B, n_max), bool)
            tam1[hits[0], hits[1]] = True

        is_fast = np.ones(B, bool)
        is_fast[check_idx] = False
        fast_live = is_fast if live_all else (is_fast & live)
        used_t = np.where(fast_live, m_all, 0)
        comp_t = np.where(fast_live, n_active, 0)
        identified_t = tr_detect[t] & checks
        agg_weight = np.where(fast_live[:, None], batch_a.weight,
                              np.float32(0.0))

        for b in check_idx:
            tr, st, s = trials[b], trials[b].st, specs[b]
            used_t[b] = tr.m1
            comp_t[b] = tr.m1 * tr.r1
            if identified_t[b]:
                ai, mem_i = _grouped_rows(s.n, tr.act_idx,
                                          2 * max(1, int(f_t_arr[b])) + 1,
                                          st.rng)
                tam = streams.phase2_hits(b, t)
                if recorder is not None:
                    if rec_sh2 is None:
                        rec_sh2 = zero_sh2.copy()
                        rec_gr2 = zero_gr2.copy()
                        rec_m2 = zero_m2.copy()
                        rec_tam2 = zero_tam.copy()
                    k = len(ai.shard_of_worker)
                    rec_sh2[b, :k] = ai.shard_of_worker
                    rec_gr2[b, :k] = ai.group_of_worker
                    rec_m2[b] = ai.num_shards
                    if tam:
                        rec_tam2[b, tam] = True
                used_t[b] += ai.num_shards
                comp_t[b] += ai.num_shards * ai.replication
                newly = np.flatnonzero(tr_faulty2[t, b])
                if newly.size:
                    st.on_identified(newly)
                    for w_id in newly:
                        tr.ident_step[int(w_id)] = t
                    f_t_arr[b] = max(0, s.f - st.kappa)
                    dirty_trials.append(b)
                agg_weight[b] = 0.0
            else:
                st.on_clean_check(tr.mem1.ravel())
                agg_weight[b] = batch_a.weight[b]

        if recorder is not None:
            recorder.on_step(
                live=live, checks=checks,
                vote1=np.zeros(B, bool),
                shard1=shard_all, group1=group_all,
                m1=np.asarray(m_all, np.int64),
                aggw=agg_weight, tam1=tam1,
                identify=identified_t,
                shard2=zero_sh2 if rec_sh2 is None else rec_sh2,
                group2=zero_gr2 if rec_gr2 is None else rec_gr2,
                m2=zero_m2 if rec_m2 is None else rec_m2,
                tam2=zero_tam if rec_tam2 is None else rec_tam2,
                active=bstate.active.copy(),
            )

        used_acc += used_t
        comp_acc += comp_t
        check_acc += checks
        ident_acc += identified_t
        eff_hist[:, t] = used_t / np.maximum(1, comp_t)

    return _control_results(specs, trials, used_acc, comp_acc, check_acc,
                            ident_acc, eff_hist, q_trace_mat, t_start)


# ---------------------------------------------------------------------------
# Declarative scenario matrices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPattern:
    """Who misbehaves and how membership churns."""

    name: str
    byz: tuple[int, ...] = ()
    onset: int = 0
    events: tuple[FaultEvent, ...] = ()


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """A named protocol/baseline configuration."""

    name: str
    mode: str = "randomized"
    q: float | None = None
    selective: bool = False
    filter_name: str = "median"


@dataclasses.dataclass(frozen=True)
class ScenarioMatrix:
    """Named grid of attacks x modes x fault patterns x seeds.

    ``expand()`` produces one ``TrialSpec`` per cell, labelled
    ``mode/attack/fault/sSEED`` so ``BatchResult.summarize()`` can
    aggregate over seeds.  See docs/scenarios.md.
    """

    name: str
    modes: tuple[ModeSpec, ...]
    attacks: tuple[str, ...] = ("sign_flip",)
    faults: tuple[FaultPattern, ...] = (FaultPattern("byz25", (2, 5)),)
    seeds: tuple[int, ...] = (0,)
    n: int = 8
    f: int = 2
    steps: int = 300
    p_tamper: float = 0.8
    lr: float = 0.05
    problem_seed: int = 0
    n_data: int = 256
    d: int = 8

    def expand(self) -> list[TrialSpec]:
        out = []
        for mo, at, fp, sd in itertools.product(
            self.modes, self.attacks, self.faults, self.seeds
        ):
            out.append(TrialSpec(
                n=self.n, f=self.f, byz=fp.byz, attack=at,
                p_tamper=self.p_tamper, steps=self.steps, q=mo.q,
                mode=mo.mode, filter_name=mo.filter_name,
                selective=mo.selective, lr=self.lr, seed=sd,
                problem_seed=self.problem_seed, n_data=self.n_data,
                d=self.d, onset=fp.onset, events=fp.events,
                label=f"{mo.name}/{at}/{fp.name}/s{sd}",
            ))
        return out

    def run(self, **kwargs) -> BatchResult:
        """Run every cell on the card (``backend="torch"``) unless the
        caller asks for the host's numpy engine (``backend="numpy"``) or
        the CPU (``device="cpu"``)."""
        kwargs.setdefault("backend", "torch")
        return run_batch(self.expand(), **kwargs)


_RAND = ModeSpec("randomized_q0.2", "randomized", q=0.2)

SCENARIOS: dict[str, ScenarioMatrix] = {
    # the paper's core comparison table (§2/§3): every scheme vs the same
    # sign-flip adversary — exactness, efficiency, identification
    "paper_core": ScenarioMatrix(
        name="paper_core",
        modes=(
            ModeSpec("none", "none"),
            ModeSpec("filter_median", "filter:median"),
            ModeSpec("filter_krum", "filter:krum"),
            ModeSpec("draco", "draco"),
            ModeSpec("deterministic", "deterministic"),
            _RAND,
            ModeSpec("adaptive", "randomized", q=None),
        ),
        seeds=(0, 1, 2),
    ),
    # every attack in the table vs the randomized scheme
    "attack_sweep": ScenarioMatrix(
        name="attack_sweep",
        modes=(_RAND, ModeSpec("adaptive", "randomized", q=None)),
        attacks=("sign_flip", "scale", "drift", "zero"),
        seeds=(0, 1),
    ),
    # late-onset Byzantine behavior: workers turn after a clean prefix —
    # the randomized schedule must still identify them (§4.2 holds from
    # the onset step on)
    "late_onset": ScenarioMatrix(
        name="late_onset",
        modes=(ModeSpec("randomized_q0.3", "randomized", q=0.3),),
        attacks=("sign_flip", "drift"),
        faults=(
            FaultPattern("onset50", (2, 5), onset=50),
            FaultPattern("onset150", (4,), onset=150),
        ),
        seeds=(0, 1, 2),
    ),
    # elastic membership churn: crash mid-run, recover later
    # (ProtocolState.on_crash / on_recover)
    "elastic_churn": ScenarioMatrix(
        name="elastic_churn",
        modes=(ModeSpec("randomized_q0.3", "randomized", q=0.3),),
        attacks=("none", "sign_flip"),
        faults=(
            FaultPattern(
                "crash17_recover1",
                byz=(5,),
                events=(
                    FaultEvent(60, "crash", (1, 7)),
                    FaultEvent(140, "recover", (1,)),
                ),
            ),
        ),
        seeds=(0, 1),
    ),
    # §5 selective checks: reliability-weighted per-worker probabilities
    "selective": ScenarioMatrix(
        name="selective",
        modes=(
            ModeSpec("uniform_q0.3", "randomized", q=0.3),
            ModeSpec("selective_q0.3", "randomized", q=0.3, selective=True),
        ),
        attacks=("scale",),
        faults=(FaultPattern("byz6", (6,)),),
        seeds=(0, 1, 2),
    ),
}
