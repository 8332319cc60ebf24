"""The port's engine facade: B protocol trials on the card.

Port of ``repro.core.engine_jax.run_batch_jax`` (``engine_jax.py:130-608``):

 * a control plane, on the host or on the device:
   - host ("vector"): ``build_schedule`` runs the vectorized
     control-only replay (``engine.replay_control_fast``) into dense
     (T, B, ...) schedule arrays, bitwise the reference's;
   - device (``schedule="device"``): the step loop makes every decision
     itself (``stepcore.device_scan``: q*_t from the loss, the threefry
     coins, the masked regroup, detection, the identify vote) and the
     host rebuilds the schedule and the control results from its
     decision trace (``engine.replay_control_from_trace``), the only
     mode that runs value-dependent trials (adaptive q*_t, sign_flip,
     scale);
 * the data plane the reference's planner picks, on the device:
   - **gram**: the extended rows R are staged once, the per-step
     CountSketch tables come from the gram kernel (``ops.gram_factors``),
     G = R R^T is formed in f32 per 64K-column chunk and summed in f64,
     the loop carries (B, Ie) coefficients and one contraction after it
     materializes W_T = W_0 - C_T R;
   - **fused**: the extended rows (f32 or bf16, ``stream_dtype``) are
     staged once and every step is one pass of the fused kernel
     (``ops.fused_step``);
   - **stream** (the unfused scan, the fused plane's parity oracle, and
     the only plane for per-trial problems and filter baselines): the T
     per-step sketch tables of the stacked problems' extended rows are
     pre-sketched before the loop (``ops.batched_sketch``), and trials
     that do not share a problem aggregate through
     ``ops.batched_coded_encode``.

The host control plane has three schedules, as the reference's:
"vector" (the control-only replay, no data plane), "proxy" (the numpy
engine, ``engine.run_batch``, on a tiny proxy problem: the same
schedule for value-independent trials) and "oracle" (the numpy engine
on the real problem: every trial class, value-dependent ones included,
at the cost of the thing it schedules).  "auto" picks "vector" when
every trial is value-independent, else "oracle".

The plan is resolved first (``engineplan.plan.resolve_plan``, the
reference's pure planner).  ``mesh`` splits the trials over several
devices (the reference's ``mesh="auto"``, ``engine_jax.py:304-317``):
each device gets its copy of the problem rows and its own precompute,
and each chunk one shard a device (``engineplan.shard``).  The chunks
stream through ``engineplan.pipeline.run_chunks``; with
``telemetry=True`` the step loop adds up the protocol counters, returned
as ``BatchResult.telemetry`` (``obs.telemetry.Telemetry``).  The facade
emits the reference's spans (``engine.build_schedule``,
``engine.resolve_plan``, ``engine.scan``) and counters
(``engine.batches``, ``engine.trials``,
``engine.plan.<data plane>.<control>``, ``engine.telemetry.steps``)
through ``repro_torch.obs``.

Parity contract, as the reference's: control quantities (schedules,
detect flags, identified sets, q-traces, efficiency) exact; iterates
and losses at the f32 tolerances of tests/test_engine_parity.py.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.engine import (
    BatchResult,
    ScheduleRecorder,
    TrialSpec,
    replay_control_fast,
    replay_control_from_trace,
)
from repro_torch.core.engine import run_batch as numpy_run_batch
from repro_torch.core.engineplan import plan as planlib
from repro_torch.core.engineplan.pipeline import PhaseClock, run_chunks
from repro_torch.core.simulation import SimResult, make_problem
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obmetrics
from repro_torch.obs import trace as obtrace
from repro_torch.obs.telemetry import Telemetry, zero_counts
from repro_torch.sharding import TrialsMesh, mesh_num_devices, trials_mesh

GRAM_CHUNK = 1 << 16          # columns per f32 product when forming G

# the "proxy" schedule's problem: n_data = max(64, 2 * n_max), d = 4
PROXY_N_DATA = 64
PROXY_D = 4


@dataclasses.dataclass
class Schedule:
    """Stacked (T, B, ...) control arrays + the control-plane results."""

    arrays: dict[str, np.ndarray]
    control: BatchResult
    used_proxy: bool
    mode: str = "oracle"


def stacked(rec: ScheduleRecorder) -> dict[str, np.ndarray]:
    """The recorder's per-step dicts as dense (T, B, ...) arrays."""
    keys = rec.steps[0].keys() if rec.steps else ()
    return {k: np.stack([st[k] for st in rec.steps]) for k in keys}


def build_schedule(specs: list[TrialSpec], mode: str = "auto") -> Schedule:
    """Replay the numpy engine's control machinery into dense arrays.

    "vector" runs the batched control-only replay
    (``engine.replay_control_fast``), no data plane at all; "proxy" runs
    the numpy engine on a tiny proxy problem (the same schedule, kept as
    the parity oracle of "vector"); "oracle" runs the numpy engine on the
    real problem (every trial class; the replay then costs the thing it
    schedules); "auto" picks "vector" whenever valid, else "oracle".
    Resolution and eligibility errors route through
    ``engineplan.plan.resolve_schedule_mode``."""
    mode = planlib.resolve_schedule_mode(specs, mode, host_only=True)
    rec = ScheduleRecorder()
    if mode == "vector":
        control = replay_control_fast(specs, rec)
    else:
        if mode == "proxy":
            n_data = max(PROXY_N_DATA, 2 * max(s.n for s in specs))
            ctrl_specs = [dataclasses.replace(s, n_data=n_data, d=PROXY_D)
                          for s in specs]
        else:
            ctrl_specs = specs
        control = numpy_run_batch(ctrl_specs, _recorder=rec)
    return Schedule(stacked(rec), control, mode != "oracle", mode)


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one this raises rather than
    running on the CPU unasked."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch.run_batch runs on a CUDA device by default and "
                "none is available; pass device=\"cpu\" to run the plain "
                "PyTorch versions of the kernels on the CPU")
        return torch.device("cuda" if device is None else device)
    return torch.device(device)


def device_schedule(specs, trace: dict) -> Schedule:
    """The control plane rebuilt from the device plane's decision trace
    {"q", "check", "detect", "faulty2"}: schedule arrays and control
    results (``engine_jax.py:569-580``)."""
    rec = ScheduleRecorder()
    control = replay_control_from_trace(specs, trace, rec)
    return Schedule(stacked(rec), control, True, "device")


def gram_matrix(rows: torch.Tensor, chunk: int = GRAM_CHUNK) -> torch.Tensor:
    """G = R R^T: an f32 product per ``chunk`` columns, the chunk sums
    carried in f64 (a plain f32 length-d dot would lose ~sqrt(d)*eps,
    ~1e-4 relative at d = 2^20, and G feeds every step's residual)."""
    Ie, d = rows.shape
    G64 = torch.zeros((Ie, Ie), dtype=torch.float64, device=rows.device)
    for lo in range(0, d, chunk):
        blk = rows[:, lo:lo + chunk]
        G64 += (blk @ blk.T).to(torch.float64)
    return G64.to(torch.float32)


def _telemetry(counts, specs, results, telemetry: bool):
    """The batch's ``Telemetry`` (q summaries from the control plane's
    q-traces), or None when it was not asked for."""
    if not telemetry:
        return None
    return Telemetry.from_counts(counts, specs=specs,
                                 q_traces=[r.q_trace for r in results])


def _zero_step_results(specs, sched, plan, t_start, telemetry: bool,
                       trace: dict | None) -> BatchResult:
    """steps == 0 everywhere: nothing to scan; every iterate is W_0 = 0
    and every counter 0."""
    results = []
    for s, ctrl in zip(specs, sched.control.results):
        _, _, w_true = make_problem(n_data=s.n_data, d=s.d,
                                    seed=s.problem_seed)
        results.append(SimResult(
            w=np.zeros(s.d), w_true=w_true, state=ctrl.state, losses=[],
            q_trace=ctrl.q_trace, identify_step=ctrl.identify_step))
    return BatchResult(
        specs, results, time.perf_counter() - t_start, plan=plan,
        telemetry=_telemetry(zero_counts(len(specs)), specs, results,
                             telemetry),
        schedule=sched, detect_flags=np.zeros((0, len(specs)), bool),
        device_trace=trace)


def _problems(specs):
    """The distinct problems of the batch in first-seen order, and each
    trial's problem index (``engine_jax.py:341-349``)."""
    problems: dict[tuple, tuple] = {}
    for s in specs:
        key = (s.problem_seed, s.n_data, s.d)
        if key not in problems:
            problems[key] = make_problem(n_data=s.n_data, d=s.d,
                                         seed=s.problem_seed)
    pkeys = list(problems)
    pid = np.array([pkeys.index((s.problem_seed, s.n_data, s.d))
                    for s in specs], np.int32)
    return problems, pkeys, pid


def resolve_mesh(mesh, device) -> TrialsMesh | None:
    """``run_batch``'s ``mesh`` option -> a trials mesh, or None for one
    device (``engine_jax.py:304-317``): "auto" is ``trials_mesh()``
    (every local card) when ``device`` is the card without an index
    (None or "cuda"), else one device; None is one device; a
    ``TrialsMesh`` is used as given."""
    if isinstance(mesh, TrialsMesh) or mesh is None:
        return mesh
    if isinstance(mesh, str) and mesh == "auto":
        dev = resolve_device(device)
        return trials_mesh() if dev.type == "cuda" and dev.index is None \
            else None
    raise ValueError(f"unknown mesh option {mesh!r}: mesh takes \"auto\", "
                     f"None or a sharding.TrialsMesh")


def _operands(rows_dev, y_dev, keys_t, *, plan, n_data: int, P: int,
              impl: str) -> dict:
    """The chunk-invariant operands of the step loop on one device (the
    replicated ones of ``engineplan.shard``'s table): {"A", "y", "com",
    "noise"}.  On a split each device computes its own K1 sketch tables
    or K4 pre-sketches and G from its copy of the rows: the same kernels
    on the same inputs, so the same bits on every device."""
    T = keys_t.shape[0]
    shared = plan.shared_problem
    device = rows_dev.device
    noise_dev = None
    if plan.data_plane == "gram":
        # the step sketch tables (kernel) and G, once
        _, _, sk_rows = ops.gram_factors(rows_dev, None, keys_t, impl=impl,
                                         with_gram=False)
        A_dev = {"rows": rows_dev, "G": gram_matrix(rows_dev)}
        com_dev = carry.sketch_tables(sk_rows, n_data, device)
    elif plan.fused:
        # the kernel sketches the rows in its pass: no pre-sketch
        A_dev = (rows_dev.to(torch.bfloat16) if plan.stream_dtype == "bf16"
                 else rows_dev)
        com_dev = {"keys": keys_t}
    else:
        # the unfused plane's T hoisted pre-sketches (engine_jax.py:495)
        sk_rows = torch.stack([ops.batched_sketch(rows_dev, int(keys_t[t]),
                                                  impl=impl)
                               for t in range(T)])
        com_dev = carry.sketch_tables(sk_rows, n_data, device, n_problems=P)
        d = rows_dev.shape[1]
        A_dev = (rows_dev[:n_data] if shared
                 else rows_dev[:P * n_data].view(P, n_data, d))
        noise_dev = rows_dev[-1]
    return {"A": A_dev, "y": y_dev, "com": com_dev, "noise": noise_dev}


def run_batch(specs, *, device=None, schedule: str = "auto",
              data_plane: str | None = None,
              chunk_trials: int | None = None,
              kernel_impl: str | None = None,
              fused: bool | None = None, stream_dtype: str = "f32",
              telemetry: bool = False, mesh="auto") -> BatchResult:
    """Run B protocol trials on ``device``, or split over the devices of
    a trials mesh.

    device: None (the CUDA device; raises without one) | "cpu" | any
        torch device.  On a CUDA device the kernels are the hand-written
        ones; on the CPU their plain PyTorch versions run.
    mesh: "auto" (default) splits the trials over every local card
        (``sharding.trials_mesh``) when ``device`` is None or "cuda" and
        more than one card is visible, else runs on ``device``; None
        runs on ``device``; a ``sharding.TrialsMesh`` splits them over
        its devices (``device`` is then ignored), which may repeat one
        device (eight times "cpu", or "cuda:0" twice: the split on a
        machine with fewer devices).  Anything else raises
        ``ValueError``.  Each chunk of ``chunk_trials`` (rounded up to
        a multiple of the device count) runs as one shard a device,
        with no collective (``engineplan.shard``).
    kernel_impl: None (follow the device) | "cuda" | "torch" — "torch"
        on a CUDA device runs the plain versions there (a comparison
        run; never chosen automatically).
    schedule, data_plane, chunk_trials, fused, stream_dtype, telemetry:
        as the reference's ``run_batch(..., backend="jax")``: "auto",
        "vector", "proxy" and "oracle" build the schedule on the host
        (``build_schedule``), "device" makes the decisions in the step
        loop with the counter-RNG streams (``rng="device"``), so its
        schedule is not the host streams' one.  ``telemetry=True`` adds up the protocol
        counters in the step loop; the primary outputs are bitwise those
        of the run without.

    Returns a ``BatchResult`` whose ``results[b]`` carry ``w``,
    ``losses``, ``q_trace``, ``identify_step``, ``efficiency`` and
    ``state``, plus ``plan``, ``schedule``, ``detect_flags`` (T, B),
    ``telemetry`` (a ``Telemetry``, or None without ``telemetry=True``),
    ``device_trace`` (under "device": the decision trace {"q", "check",
    "detect", "faulty2"} the control plane was rebuilt from; else None),
    ``fused_used`` and ``phase_s`` (wall seconds per phase: host_replay,
    problem_setup, precompute, scan, post_scan; the scan's from CUDA
    events at chunk boundaries on the card, post_scan the rest of the
    chunk pipeline; under "device" host_replay is the replay from the
    trace, after the scan).
    """
    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    if not specs:
        return BatchResult([], [], 0.0, telemetry=_telemetry(
            zero_counts(0), specs, [], telemetry))
    tmesh = resolve_mesh(mesh, device)
    devices = [resolve_device(device)] if tmesh is None \
        else [resolve_device(dv) for dv in tmesh.devices]
    device = devices[0]
    kernel_impl = ops.resolve_impl(kernel_impl, device)
    if device.type == "cuda":
        # TF32 would break the 1e-4 value contract on resid and W_T
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    B = len(specs)
    with obtrace.span("engine.resolve_plan", B=B):
        plan = planlib.resolve_plan(
            specs, schedule=schedule, fused=fused, chunk_trials=chunk_trials,
            stream_dtype=stream_dtype, kernel_impl=kernel_impl,
            data_plane=data_plane, telemetry=telemetry,
            n_devices=None if tmesh is None else mesh_num_devices(tmesh))
        planlib.warn_on_fallback(plan)
    clock = PhaseClock(devices)
    device_ctl = plan.control == "device"
    n_max = max(s.n for s in specs)

    T = plan.steps
    sched = None            # under "device" the step loop decides
    if not device_ctl:
        with obtrace.span("engine.build_schedule", mode=plan.schedule_mode,
                          B=B):
            sched = build_schedule(specs, schedule)
    clock.mark("host_replay")
    if T == 0:
        trace = None
        if device_ctl:
            trace = dict(q=np.zeros((0, B), np.float32),
                         check=np.zeros((0, B), bool),
                         detect=np.zeros((0, B), bool),
                         faulty2=np.zeros((0, B, n_max), bool))
            sched = device_schedule(specs, trace)
        return _zero_step_results(specs, sched, plan, t_start, telemetry,
                                  trace)
    obmetrics.counter("engine.batches").inc()
    obmetrics.counter("engine.trials").inc(B)
    obmetrics.counter(f"engine.plan.{plan.data_plane}.{plan.control}").inc()
    shared = plan.shared_problem

    # -- the problems: one shared, or each trial's own (engine_jax.py:341)
    problems, pkeys, pid_np = _problems(specs)
    n_data, d = problems[pkeys[0]][0].shape
    w_true = [problems[(s.problem_seed, s.n_data, s.d)][2] for s in specs]
    abn = np.array([planlib.AFFINE_ATTACKS[s.attack] for s in specs],
                   np.float32)
    noisevec = (np.random.default_rng(0).normal(size=d).astype(np.float32)
                if (abn[:, 2] != 0).any() else np.zeros(d, np.float32))
    stat_np = dict(
        lr=np.array([s.lr for s in specs], np.float32),
        alpha=abn[:, 0].copy(), beta=abn[:, 1].copy(), nu=abn[:, 2].copy(),
    )
    if device_ctl:
        stat_np.update(carry.device_statics(specs, n_max))
        xs_np = None
    else:
        stat_np.update(
            fcode=np.array([planlib.FILTER_CODES.get(planlib.filter_name(s),
                                                     -1) for s in specs],
                           np.int32),
            farr=np.array([max(1, s.f) for s in specs], np.int32))
        xs_np = carry.xs_from_schedule(sched.arrays)
        if telemetry:
            # the byz_active_steps counter needs the Byzantine mask
            byz = np.zeros(xs_np["active"].shape[1:], bool)
            for b, s in enumerate(specs):
                byz[b, list(s.byz)] = True
            stat_np["byz"] = byz
    P = len(pkeys)
    rows_np = carry.extended_rows([problems[key][0] for key in pkeys],
                                  noisevec)
    # y (n_data,) of the shared problem, or (P, n_data) of every problem
    # (a chunk gathers its trials' rows and targets by pid on the device)
    y_np = np.stack([problems[key][1] for key in pkeys]).astype(np.float32)
    if shared:
        y_np = y_np[0]
    del problems
    # per-step sketch keys; the uint32 product wraps mod 2^32
    keys_t = np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)
    staged = {dev: (carry.to_device(rows_np, dev), carry.to_device(y_np, dev))
              for dev in dict.fromkeys(devices)}
    del rows_np
    clock.mark("problem_setup")
    operands = {dev: _operands(rows_dev, y_dev, keys_t, plan=plan,
                               n_data=n_data, P=P, impl=kernel_impl)
                for dev, (rows_dev, y_dev) in staged.items()}
    del staged
    clock.mark("precompute")

    with obtrace.span("engine.scan", B=B, T=T, data_plane=plan.data_plane,
                      control=plan.control):
        W, losses, det, counts, trace = run_chunks(
            plan, B=B, T=T, d=d, devices=devices, operands=operands,
            stat_np=stat_np, xs_np=xs_np, impl=kernel_impl, clock=clock,
            pid_np=pid_np, telemetry=telemetry)
    if device_ctl:
        # the whole host control plane from the decision trace: exact,
        # the streams are counter-indexed (engine_jax.py:569-580)
        trace["detect"] = det.copy()
        sched = device_schedule(specs, trace)
        clock.mark("host_replay")

    results = []
    for b, (s, ctrl) in enumerate(zip(specs, sched.control.results)):
        results.append(SimResult(
            w=W[b],
            w_true=w_true[b],
            state=ctrl.state,
            losses=losses[:s.steps, b].tolist(),
            q_trace=ctrl.q_trace,
            identify_step=ctrl.identify_step,
        ))
    tel = _telemetry(counts, specs, results, telemetry)
    if tel is not None:
        obmetrics.counter("engine.telemetry.steps").inc(
            tel.totals()["steps"])
    return BatchResult(specs, results, time.perf_counter() - t_start,
                       plan=plan, telemetry=tel, schedule=sched,
                       detect_flags=det, device_trace=trace,
                       fused_used=plan.fused, phase_s=clock.seconds)
