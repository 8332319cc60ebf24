"""The port's engine facade: B protocol trials on the card.

Port of ``repro.core.engine_jax.run_batch_jax`` (``engine_jax.py:130-608``)
for the path this slice covers:

 * a host control plane — ``build_schedule`` runs the vectorized
   control-only replay (``engine.replay_control_fast``) into dense
   (T, B, ...) schedule arrays, bitwise the reference's;
 * the gram data plane on the device — the extended rows R are staged
   once, the per-step CountSketch tables come from the hand-written
   gram kernel (``ops.gram_factors``), G = R R^T is formed in f32 per
   64K-column chunk and summed in f64, the step loop carries (B, Ie)
   coefficients (``engineplan.stepcore``) and the post-scan contraction
   materializes W_T = W_0 - C_T R.

The plan is resolved first (``engineplan.plan.resolve_plan``, the
reference's pure planner), so a request outside the slice — another
schedule mode, the stream or fused plane, filters, non-shared problems,
telemetry, bf16 storage — raises ``NotImplementedError`` naming the
path the reference would take and the later slice that ports it.

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
)
from repro_torch.core.engineplan import plan as planlib
from repro_torch.core.engineplan.pipeline import PhaseClock, run_chunks
from repro_torch.core.simulation import SimResult, make_problem
from repro_torch.kernels import ops

GRAM_CHUNK = 1 << 16          # columns per f32 product when forming G


@dataclasses.dataclass
class Schedule:
    """Stacked (T, B, ...) control arrays + the control-plane results."""

    arrays: dict[str, np.ndarray]
    control: BatchResult
    used_proxy: bool
    mode: str = "oracle"


def build_schedule(specs: list[TrialSpec], mode: str = "auto") -> Schedule:
    """Replay the control machinery into dense arrays: "vector" (and
    "auto", which picks it whenever valid) runs the batched control-only
    replay with no data plane at all."""
    mode = planlib.resolve_schedule_mode(specs, mode, host_only=True)
    if mode != "vector":
        raise NotImplementedError(
            f'schedule mode "{mode}" replays the numpy engine on a real or '
            f"proxy problem; that engine is ported in a later slice "
            f"(ROADMAP M10)")
    rec = ScheduleRecorder()
    control = replay_control_fast(specs, rec)
    keys = rec.steps[0].keys() if rec.steps else ()
    arrays = {k: np.stack([st[k] for st in rec.steps]) for k in keys}
    return Schedule(arrays, control, True, mode)


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


def require_slice(plan: planlib.ExecutionPlan) -> None:
    """Raise ``NotImplementedError`` for a plan this slice does not run,
    naming the reference's path and the later slice that ports it."""
    if plan.schedule_mode != "vector":
        where = ("the device control plane (ROADMAP M6)"
                 if plan.schedule_mode == "device"
                 else "the numpy engine's host replay (ROADMAP M10)")
        raise NotImplementedError(
            f'schedule mode "{plan.schedule_mode}" is ported with {where}; '
            f'this slice runs schedule="vector" (value-independent trials)')
    if plan.telemetry:
        raise NotImplementedError(
            "telemetry=True (protocol counters in the scan carry) is ported "
            "with the chunk pipeline and telemetry slice (ROADMAP M5)")
    if plan.stream_dtype != "f32":
        raise NotImplementedError(
            f'stream_dtype="{plan.stream_dtype}" stores the fused plane\'s '
            f"rows; the stream planes are ported in ROADMAP M4")
    if plan.steps > 0 and plan.data_plane != "gram":
        path = "fused megakernel" if plan.fused else "unfused stream scan"
        raise NotImplementedError(
            f"the reference would run the {path} here (not gram: "
            f"{plan.data_plane_reason}); the stream planes are ported in "
            f"ROADMAP M4")


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


def _zero_step_results(specs, sched, plan, t_start) -> BatchResult:
    """steps == 0 everywhere: nothing to scan; every iterate is W_0 = 0."""
    results = []
    for s, ctrl in zip(specs, sched.control.results):
        _, _, w_true = make_problem(n_data=s.n_data, d=s.d,
                                    seed=s.problem_seed)
        results.append(SimResult(
            w=np.zeros(s.d), w_true=w_true, state=ctrl.state, losses=[],
            q_trace=ctrl.q_trace, identify_step=ctrl.identify_step))
    return BatchResult(specs, results, time.perf_counter() - t_start,
                       plan=plan, schedule=sched,
                       detect_flags=np.zeros((0, len(specs)), bool))


def run_batch(specs, *, device=None, schedule: str = "auto",
              data_plane: str | None = None,
              chunk_trials: int | None = None,
              kernel_impl: str | None = None,
              fused: bool | None = None, stream_dtype: str = "f32",
              telemetry: bool = False) -> BatchResult:
    """Run B protocol trials with the gram data plane on ``device``.

    device: None (the CUDA device; raises without one) | "cpu" | any
        torch device.  On a CUDA device the kernels are the hand-written
        ones; on the CPU their plain PyTorch versions run.
    kernel_impl: None (follow the device) | "cuda" | "torch" — "torch"
        on a CUDA device runs the plain versions there (a comparison
        run; never chosen automatically).
    schedule, data_plane, chunk_trials, fused, stream_dtype, telemetry:
        as the reference's ``run_batch(..., backend="jax")``; values
        outside this slice raise ``NotImplementedError``.

    Returns a ``BatchResult`` whose ``results[b]`` carry ``w``,
    ``losses``, ``q_trace``, ``identify_step``, ``efficiency`` and
    ``state``, plus ``plan``, ``schedule``, ``detect_flags`` (T, B) and
    ``phase_s`` (wall seconds per phase: host_replay, problem_setup,
    precompute, scan, post_scan).
    """
    t_start = time.perf_counter()
    specs = [s if isinstance(s, TrialSpec) else TrialSpec(**s) for s in specs]
    if not specs:
        return BatchResult([], [], 0.0)
    device = resolve_device(device)
    kernel_impl = ops.resolve_impl(kernel_impl, device)
    if device.type == "cuda":
        # TF32 would break the 1e-4 value contract on resid and W_T
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    plan = planlib.resolve_plan(
        specs, schedule=schedule, fused=fused, chunk_trials=chunk_trials,
        stream_dtype=stream_dtype, kernel_impl=kernel_impl,
        data_plane=data_plane, telemetry=telemetry)
    planlib.warn_on_fallback(plan)
    require_slice(plan)
    B = len(specs)
    clock = PhaseClock(device)

    sched = build_schedule(specs, schedule)
    clock.mark("host_replay")
    if plan.steps == 0:
        return _zero_step_results(specs, sched, plan, t_start)
    T = len(sched.arrays["live"])

    # -- the shared problem, staged once (gram plans are shared-problem)
    s0 = specs[0]
    A_np, y64, w_true = make_problem(n_data=s0.n_data, d=s0.d,
                                     seed=s0.problem_seed)
    n_data, d = A_np.shape
    abn = np.array([planlib.AFFINE_ATTACKS[s.attack] for s in specs],
                   np.float32)
    noisevec = (np.random.default_rng(0).normal(size=d).astype(np.float32)
                if (abn[:, 2] != 0).any() else np.zeros(d, np.float32))
    stat_np = dict(
        lr=np.array([s.lr for s in specs], np.float32),
        alpha=abn[:, 0].copy(), beta=abn[:, 1].copy(), nu=abn[:, 2].copy(),
    )
    xs_np = carry.xs_from_schedule(sched.arrays)
    rows_np = np.empty((n_data + 2, d), np.float32)
    rows_np[:n_data] = A_np
    rows_np[-2] = 1.0
    rows_np[-1] = noisevec
    del A_np
    # per-step sketch keys; the uint32 product wraps mod 2^32
    keys_t = np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)
    rows_dev, y_dev = carry.problem_operands(rows_np, y64, device)
    clock.mark("problem_setup")

    # -- gram precompute: the step sketch tables (kernel) and G
    _, _, sk_rows = ops.gram_factors(rows_dev, None, keys_t,
                                     impl=kernel_impl, with_gram=False)
    A_dev = {"rows": rows_dev, "G": gram_matrix(rows_dev)}
    com_dev = carry.sketch_tables(sk_rows, n_data, device)
    clock.mark("precompute")

    W, losses, det = run_chunks(
        plan, B=B, T=T, d=d, device=device, A_dev=A_dev, y_dev=y_dev,
        com_dev=com_dev, stat_np=stat_np, xs_np=xs_np, impl=kernel_impl,
        clock=clock)

    results = []
    for b, (s, ctrl) in enumerate(zip(specs, sched.control.results)):
        results.append(SimResult(
            w=W[b],
            w_true=w_true,
            state=ctrl.state,
            losses=losses[:s.steps, b].tolist(),
            q_trace=ctrl.q_trace,
            identify_step=ctrl.identify_step,
        ))
    return BatchResult(specs, results, time.perf_counter() - t_start,
                       plan=plan, schedule=sched, detect_flags=det,
                       phase_s=clock.seconds)
