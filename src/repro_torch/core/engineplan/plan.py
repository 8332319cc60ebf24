"""ExecutionPlan: the engine's path selection as an inspectable value.

Port of ``repro.core.engineplan.plan`` with ``backend="torch"``.
:func:`resolve_plan` is pure — specs plus keyword knobs in, a frozen
:class:`ExecutionPlan` out — so the port resolves the same path the
reference would take for the same batch, and the facade can name that
path when it belongs to a later slice of the port.  The schedulability
predicates and the affine-attack / filter tables live here, as in the
reference; they are duck-typed over any object with TrialSpec's fields.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings

# affine attack table: g' = alpha * g + beta * 1 + nu * noisevec, where
# noisevec is ATTACKS["noise"]'s fixed default_rng(0) draw
AFFINE_ATTACKS: dict[str, tuple[float, float, float]] = {
    "none": (1.0, 0.0, 0.0),
    "sign_flip": (-5.0, 0.0, 0.0),
    "scale": (10.0, 0.0, 0.0),
    "drift": (1.0, 1.0, 0.0),
    "zero": (0.0, 0.0, 0.0),
    "noise": (1.0, 0.0, 1.0),
}

# attacks whose detectability never depends on gradient magnitudes
VALUE_INDEPENDENT_ATTACKS = frozenset({"none", "drift", "noise"})

FILTER_CODES = {"mean": 0, "median": 1, "krum": 2}

STREAM_DTYPES = ("f32", "bf16")

# element budget for sizing trials-per-chunk (~1 GiB of f32 in flight)
CHUNK_ELEMS = 1 << 27

# auto-gate for the gram data plane: d >= GRAM_MIN_D_RATIO * I
GRAM_MIN_D_RATIO = 4


class PlanFallbackWarning(UserWarning):
    """A requested execution path was demoted by the plan's eligibility
    gates; the message (and the matching ``ExecutionPlan`` reason field)
    says why."""


class FusedFallbackWarning(PlanFallbackWarning):
    """``fused=True`` demotions (subclass kept for the reference's
    warning filters)."""


_warn_lock = threading.Lock()
_warned: set = set()


def warn_once(message: str, category: type[Warning], *, key,
              stacklevel: int = 2) -> bool:
    """Emit ``warnings.warn(message, category)`` the first time ``key`` is
    seen in the process; later calls with the same key stay silent.
    Returns True when the warning was emitted."""
    with _warn_lock:
        if key in _warned:
            return False
        _warned.add(key)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


def reset_warn_once() -> None:
    """Forget every seen key (test isolation hook)."""
    with _warn_lock:
        _warned.clear()


# ---------------------------------------------------------------------------
# Schedulability predicates (duck-typed over TrialSpec-shaped objects)
# ---------------------------------------------------------------------------


def filter_name(spec) -> str | None:
    """The gradient-filter baseline name, or None for protocol trials."""
    if not spec.mode.startswith("filter"):
        return None
    return spec.mode.split(":", 1)[1] if ":" in spec.mode else spec.filter_name


def is_adaptive(spec) -> bool:
    """Adaptive q*_t: randomized mode with no fixed check probability."""
    return spec.q is None and spec.mode == "randomized"


def value_independent_control(spec) -> bool:
    """True when the trial's control flow does not depend on gradient
    values, i.e. the schedule can be replayed with no data plane."""
    if spec.q is None and spec.mode == "randomized":
        return False
    if not spec.byz:
        return True
    if spec.mode in ("none",) or spec.mode.startswith("filter"):
        return True
    return isinstance(spec.attack, str) \
        and spec.attack in VALUE_INDEPENDENT_ATTACKS


def device_schedulable(spec) -> bool:
    """True when the trial's control plane can run inside the scan
    (``schedule="device"``): affine attacks, none/deterministic/
    randomized modes, no selective checks, no membership events."""
    if not isinstance(spec.attack, str):
        return False
    return (spec.attack in AFFINE_ATTACKS
            and spec.mode in ("none", "deterministic", "randomized")
            and not spec.selective
            and not spec.events)


def spec_display_names(specs, flags) -> list[str]:
    """Human-readable names for the specs where ``flags`` is truthy."""
    out = []
    for i, (s, bad) in enumerate(zip(specs, flags)):
        if not bad:
            continue
        if s.label:
            out.append(s.label)
        else:
            q = "adaptive" if s.q is None else f"q={s.q}"
            out.append(f"spec[{i}]({s.mode}/{s.attack}/{q})")
    return out


def nearest_schedule(specs) -> str:
    """The least-degraded schedule mode that accepts every spec."""
    return "device" if all(device_schedulable(s) for s in specs) \
        else "oracle"


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def validate_stream_dtype(stream_dtype: str) -> None:
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f"unknown stream_dtype {stream_dtype!r}; "
                         f"allowed values: {list(STREAM_DTYPES)}")


def validate_specs(specs) -> None:
    """Reject batches the data plane cannot represent, naming the
    offending specs and the nearest plan that would accept them."""
    dims = {(s.n_data, s.d) for s in specs}
    if len(dims) > 1:
        counts = {dm: sum(1 for s in specs if (s.n_data, s.d) == dm)
                  for dm in dims}
        major = max(counts, key=counts.get)
        flags = [(s.n_data, s.d) != major for s in specs]
        raise ValueError(
            f"trials must share (n_data, d), got {sorted(dims)}; "
            f"offending: {spec_display_names(specs, flags)} — nearest "
            f"accepting plan: one run_batch call per (n_data, d) group")
    for i, s in enumerate(specs):
        one = spec_display_names(specs, [j == i for j in range(len(specs))])
        if not isinstance(s.attack, str) or s.attack not in AFFINE_ATTACKS:
            raise NotImplementedError(
                f"the device data plane supports the affine attack table "
                f"{sorted(AFFINE_ATTACKS)}, got {s.attack!r} ({one[0]})")
        name = filter_name(s)
        if name is not None and name not in FILTER_CODES:
            raise NotImplementedError(
                f"the device data plane supports filters "
                f"{sorted(FILTER_CODES)}, got {name!r} ({one[0]})")


def resolve_schedule_mode(specs, mode: str, *, host_only: bool = False) -> str:
    """Resolve/validate the schedule mode for a batch: "vector" | "proxy"
    | "oracle" | "device"; raises ValueError naming the offending specs
    and the nearest plan that would accept them."""
    if mode == "device" and not host_only:
        flags = [not device_schedulable(s) for s in specs]
        if any(flags):
            raise ValueError(
                'schedule="device" needs device-schedulable trials '
                "(affine string attacks, mode none/deterministic/"
                "randomized, no selective checks or membership events); "
                f"offending: {spec_display_names(specs, flags)}; nearest "
                'accepting plan: schedule="oracle"')
        return "device"
    eligible = all(value_independent_control(s) for s in specs)
    if mode == "auto":
        return "vector" if eligible else "oracle"
    if mode in ("proxy", "vector"):
        if not eligible:
            flags = [not value_independent_control(s) for s in specs]
            offending = [s for s, bad in zip(specs, flags) if bad]
            raise ValueError(
                f"{mode} schedule invalid for value-dependent trials: "
                f"{spec_display_names(specs, flags)} — nearest accepting "
                f'plan: schedule="{nearest_schedule(offending)}"')
        return mode
    if mode == "oracle":
        return "oracle"
    raise ValueError(
        f"unknown schedule mode {mode!r} (host modes: auto/vector/proxy/"
        f"oracle; \"device\" is the in-scan control plane)")


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Every path decision of one batch, resolved up front."""

    backend: str                 # "torch"
    schedule_mode: str           # "vector" | "proxy" | "oracle" | "device"
    control: str                 # "host" | "device"
    fused: bool                  # megakernel data plane selected
    fused_requested: bool | None  # True/False explicit; None = auto
    fallback_reason: str | None  # set whenever fused could not engage
    shared_problem: bool         # one (problem_seed, n_data, d) for all
    has_filter: bool             # gradient-filter baselines in the batch
    has_bias: bool               # some attack has nonzero beta/nu terms
    sharded: bool                # trials split across devices
    n_devices: int               # devices (1 when unsharded)
    chunk_trials: int            # trials per device pass
    stream_dtype: str            # "f32" | "bf16" (fused rows storage)
    kernel_impl: str | None      # resolved kernel dispatch
    n_trials: int                # batch size B
    steps: int                   # scan length T (max steps over specs)
    data_plane: str = "stream"   # "gram" | "stream" (the scan's domain)
    data_plane_requested: str | None = None  # explicit; None = auto
    data_plane_reason: str = ""  # why gram engaged / why it could not
    telemetry: bool = False      # thread protocol counters through scan

    def explain(self) -> str:
        """Human-readable account of which path was picked and why."""
        sched_why = {
            "vector": "all trials value-independent -> batched "
                      "control-only replay (no data plane)",
            "proxy": "tiny-problem full-engine replay (parity oracle "
                     "for \"vector\")",
            "oracle": "value-dependent trials present -> real-problem "
                      "host replay",
            "device": "control plane fused into the scan",
        }[self.schedule_mode]
        if self.fused:
            fused_line = ("ON — shared problem, no filter baselines, "
                          "host schedule")
        elif self.fused_requested is False:
            fused_line = "OFF — disabled by fused=False"
        else:
            req = ("requested but demoted"
                   if self.fused_requested else "auto-off")
            fused_line = f"OFF ({req}) — {self.fallback_reason}"
        if self.data_plane == "gram":
            data_line = f"gram — {self.data_plane_reason}"
        elif self.data_plane_reason:
            data_line = f"stream — not gram: {self.data_plane_reason}"
        else:
            data_line = "stream"
        if self.sharded:
            shard_line = f"trials split over {self.n_devices} devices"
        else:
            shard_line = "single device"
        return "\n".join([
            f"ExecutionPlan[backend={self.backend}, B={self.n_trials}, "
            f"T={self.steps}]",
            f"  schedule : {self.schedule_mode} ({self.control} control "
            f"plane) — {sched_why}",
            f"  data     : {data_line}",
            f"  fused    : {fused_line}",
            f"  sharding : {shard_line}, chunk={self.chunk_trials} "
            f"trials/pass",
            f"  kernels  : impl={self.kernel_impl}, "
            f"stream_dtype={self.stream_dtype}, "
            f"bias_terms={'yes' if self.has_bias else 'no'}, "
            f"filters={'yes' if self.has_filter else 'no'}",
        ])


def resolve_plan(specs, *, schedule: str = "auto",
                 fused: bool | None = None,
                 n_devices: int | None = None,
                 chunk_trials: int | None = None,
                 stream_dtype: str = "f32",
                 kernel_impl: str | None = None,
                 n_max: int | None = None,
                 data_plane: str | None = None,
                 telemetry: bool = False) -> ExecutionPlan:
    """Resolve one batch's execution plan.  Pure: no device is touched.

    ``fused``: None = auto, True = explicit request (demotion warns),
    False = off.  ``data_plane``: None = auto (gram whenever eligible
    and d >= GRAM_MIN_D_RATIO * I), "gram" = explicit (auto-only gates
    waived), "stream" = the (B, d)-carry scan.  Every decision and its
    reason equals the reference's for the same arguments.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("resolve_plan needs at least one TrialSpec")
    if data_plane not in (None, "stream", "gram"):
        raise ValueError(
            f"unknown data_plane {data_plane!r}; allowed values: "
            f"'gram', 'stream' (or None for the auto choice)")
    if data_plane == "gram" and fused is True:
        raise ValueError(
            'data_plane="gram" conflicts with fused=True: the fused '
            "megakernel is the stream plane's fast path and the gram "
            "plane replaces the stream scan entirely — request one or "
            "the other")
    validate_stream_dtype(stream_dtype)
    validate_specs(specs)
    mode = resolve_schedule_mode(specs, schedule)
    control = "device" if mode == "device" else "host"

    B = len(specs)
    d = specs[0].d
    steps = max(s.steps for s in specs)
    if n_max is None:
        n_max = max(s.n for s in specs)
    shared = len({(s.problem_seed, s.n_data, s.d) for s in specs}) == 1
    has_filter = control == "host" \
        and any(FILTER_CODES.get(filter_name(s), -1) >= 0 for s in specs)
    has_bias = any(AFFINE_ATTACKS[s.attack][1] != 0.0
                   or AFFINE_ATTACKS[s.attack][2] != 0.0 for s in specs)

    Ie = specs[0].n_data + 2
    auto_plane = data_plane is None
    use_gram = False
    if data_plane == "stream":
        gram_reason = 'data_plane="stream" requested'
    elif steps == 0:
        gram_reason = "all trials have steps == 0: nothing to scan"
    elif not shared:
        n_prob = len({(s.problem_seed, s.n_data, s.d) for s in specs})
        gram_reason = (
            f"trials span {n_prob} distinct problems; the gram factors "
            f"G = R R^T are per-problem, so the coefficient recurrence "
            f"needs ONE shared extended matrix")
    elif has_filter:
        flags = [FILTER_CODES.get(filter_name(s), -1) >= 0 for s in specs]
        gram_reason = (
            f"filter baseline trials ({spec_display_names(specs, flags)}) "
            f"materialize the (B, n, d) gradient stack every step — "
            f"there is no coefficient-only form")
    elif auto_plane and fused is not None:
        gram_reason = (
            f"explicit fused={fused} pins the stream data plane (the "
            f"fused megakernel and its unfused parity oracle)")
    elif auto_plane and control == "device":
        gram_reason = (
            'auto keeps the stream plane under schedule="device": the '
            "q*/check coins read the loss, and the gram-domain loss "
            'rounds differently in f32 — pass data_plane="gram" to '
            "accept the documented coin-flip sliver")
    elif auto_plane and d < GRAM_MIN_D_RATIO * Ie:
        gram_reason = (
            f"d={d} < {GRAM_MIN_D_RATIO}*I={GRAM_MIN_D_RATIO * Ie}: the "
            f"(B, I) coefficient carry would not beat the (B, d) "
            f"iterate, so the stream plane wins")
    else:
        use_gram = True
        gram_reason = (
            f"shared problem, affine attacks, no filter baselines, "
            f"{control} control — the scan carries (B, I={Ie}) "
            f"coefficients; d={d} is touched once before the scan "
            f"(gram precompute) and once after (W_T contraction)")

    fallback_reason = None
    use_fused = False
    if fused is not False:
        if use_gram:
            fallback_reason = (
                "superseded by the gram data plane: the scan runs in "
                "coefficient space (resid = S0 - C_t G), so there is no "
                "d-sized stream left to fuse")
        elif steps == 0:
            fallback_reason = ("all trials have steps == 0: nothing to "
                               "scan")
        elif control == "device":
            fallback_reason = (
                'schedule="device" fuses the control plane into the '
                "scan; the fused megakernel covers host-schedule runs "
                "only")
        elif not shared:
            n_prob = len({(s.problem_seed, s.n_data, s.d) for s in specs})
            fallback_reason = (
                f"trials span {n_prob} distinct problems; the fused "
                f"megakernel streams ONE shared extended data matrix")
        elif has_filter:
            flags = [FILTER_CODES.get(filter_name(s), -1) >= 0
                     for s in specs]
            fallback_reason = (
                f"filter baseline trials "
                f"({spec_display_names(specs, flags)}) materialize the "
                f"(B, n, d) gradient stack, which only the unfused scan "
                f"compiles")
        else:
            use_fused = True

    ndev = n_devices if n_devices is not None else 1
    if chunk_trials is None:
        per_trial = n_max * d if has_filter else 4 * d
        chunk = max(1, min(B, (2 * CHUNK_ELEMS * ndev)
                           // max(1, per_trial)))
    elif chunk_trials < 1:
        raise ValueError(f"chunk_trials must be >= 1, got {chunk_trials}")
    else:
        chunk = int(chunk_trials)
    if n_devices is not None:
        chunk = -(-chunk // ndev) * ndev

    return ExecutionPlan(
        backend="torch", schedule_mode=mode, control=control,
        fused=use_fused, fused_requested=fused,
        fallback_reason=fallback_reason, shared_problem=shared,
        has_filter=has_filter, has_bias=has_bias,
        sharded=n_devices is not None, n_devices=ndev,
        chunk_trials=chunk, stream_dtype=stream_dtype,
        kernel_impl=kernel_impl, n_trials=B, steps=steps,
        data_plane="gram" if use_gram else "stream",
        data_plane_requested=data_plane, data_plane_reason=gram_reason,
        telemetry=telemetry,
    )


def warn_on_fallback(plan: ExecutionPlan, stacklevel: int = 3) -> None:
    """Emit a :class:`PlanFallbackWarning` (once per distinct reason)
    when an explicitly requested path was demoted.  Zero-step batches
    never warn — there is no scan at all."""
    if plan.data_plane_requested == "gram" \
            and plan.data_plane != "gram" and plan.steps > 0:
        warn_once(
            f'data_plane="gram" requested but the plan fell back to the '
            f"stream scan: {plan.data_plane_reason} "
            f"(see BatchResult.plan.explain())",
            PlanFallbackWarning,
            key=("gram_fallback", plan.data_plane_reason),
            stacklevel=stacklevel)
    if plan.fused_requested is True and not plan.fused and plan.steps > 0:
        warn_once(
            f"fused=True requested but the plan fell back to the "
            f"unfused scan: {plan.fallback_reason} "
            f"(see BatchResult.plan.explain())",
            FusedFallbackWarning,
            key=("fused_fallback", plan.fallback_reason),
            stacklevel=stacklevel)
