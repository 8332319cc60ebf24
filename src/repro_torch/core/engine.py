"""Host control plane of the batched scenario engine.

Port of the parts of ``repro.core.engine`` that the vectorized control
replay needs: the trial specification, the batched protocol state, the
pre-drawn tamper streams, the replica-group draws, the schedule
recorder and ``replay_control_fast`` itself.  The replay is the
reference's exact state machine with the data plane deleted: it
consumes the identical numpy RNG streams (decide coins, tamper draws,
assignment permutations) in the identical order, so the recorded
schedule arrays and the control results — efficiency meters, identify
steps, q-traces, active/identified sets — are bitwise the reference's.

Only the host RNG contract (``rng="host"``) is ported here; the
counter-RNG streams of ``rng="device"``, the numpy data-plane engine
and ``SCENARIOS`` belong to later slices.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

from repro_torch.core.assignment import (
    Assignment,
    BatchedAssignment,
    fast_assignment_batched,
)
from repro_torch.core.engineplan.plan import (
    ExecutionPlan,
    spec_display_names,
    value_independent_control,
)
from repro_torch.core.randomized import BFTConfig, ProtocolState, decide_generator


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
    """One protocol trial (fields as in the reference's ``TrialSpec``;
    ``onset``/``events`` are the engine-only extensions)."""

    n: int = 8
    f: int = 2
    byz: tuple[int, ...] = ()
    attack: str = "sign_flip"
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

    __slots__ = ("spec", "st", "ident_step",
                 "events_by_step", "act_idx", "m1", "r1", "mem1")

    def __init__(self, spec: TrialSpec, st: ProtocolState):
        self.spec = spec
        self.st = st
        if spec.attack not in _attack_table():
            raise KeyError(spec.attack)          # eager, like the reference
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


@dataclasses.dataclass
class BatchResult:
    """Results of one engine pass, in spec order, with the device run's
    extras: the resolved plan, the host schedule, and the scan's
    per-step detection verdicts."""

    specs: list[TrialSpec]
    results: list                # list[SimResult]
    elapsed_s: float = 0.0
    plan: "ExecutionPlan | None" = None
    telemetry: None = None       # protocol counters: a later slice
    schedule: object = None      # engine_torch.Schedule
    detect_flags: "np.ndarray | None" = None   # (T, B) bool
    device_trace: None = None    # device control plane: a later slice
    fused_used: bool = False
    phase_s: "dict[str, float] | None" = None  # wall seconds per phase

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]


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


def replay_control_fast(specs: list[TrialSpec],
                        recorder: "ScheduleRecorder | None" = None,
                        *, rng: str = "host") -> BatchResult:
    """Control-plane-only replay of value-independent trials.

    Detection is decided analytically: a replica group mismatches iff
    it mixes tampered and honest workers (affine attacks act
    identically on identical shard copies), and the majority vote flags
    the group's minority side.  Results carry control quantities only:
    ``w``/``w_true`` are empty and ``losses`` is ``[]``.
    """
    from repro_torch.core.simulation import SimResult

    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    bad = [not value_independent_control(s) for s in specs]
    if any(bad):
        raise ValueError(
            "control-only replay invalid for value-dependent trials: "
            f"{spec_display_names(specs, bad)}")
    if rng == "device":
        raise NotImplementedError(
            'rng="device" (counter-RNG streams) belongs to the device '
            "control-plane slice of the port (ROADMAP M6)")
    if rng != "host":
        raise ValueError(f"unknown rng stream contract {rng!r}")
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
    streams = _TamperStreams(specs, trials)
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
            u_mat[b, :s.steps] = bstate.trial(b).decide_rng.random(s.steps)
    q_eff = np.array([_q_fixed(s, s.f) if is_vec[b] else 0.0
                      for b, s in enumerate(specs)])
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

    # -- materialize control results (no float quantities)
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
