"""The port's device control plane against the JAX package, on the CPU.

``repro_torch.run_batch(specs, schedule="device", device="cpu")`` makes
every control decision inside its step loop (q*_t, the threefry coins,
the masked regroup, detection, the identify vote) and rebuilds the host
control plane from the decision trace; the reference runs
``run_batch(specs, backend="jax", schedule="device")``.  The checks are
those of ``tests/test_engine_differential.py:171-191``:

* exact: the check, detect and faulty2 traces, ``identify_step``, kappa,
  the identified set, the efficiency meters, the rebuilt schedule arrays
  and the nine counters, and fixed-q ``q_trace``;
* adaptive ``q_trace`` within rtol 1e-5, atol 1e-6 (the f32 loss feeds
  ``exp`` and ``pow``, whose last ulp is each library's own);
* W and losses within 1e-4.

The host halves (``replay_control_fast(rng="device")``,
``replay_control_from_trace``) must equal the reference's exactly, and
the device-schedulable golden picks must reproduce the archived
``*|device|*`` traces (``tests/golden/control_traces.npz``, read-only).
"""
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.obs import metrics as jmetrics
import repro_torch
from repro_torch.core import engine as tengine
from repro_torch.core.engine_torch import device_schedule
from repro_torch.obs import metrics as tmetrics

from make_golden import FAMILY_PICKS, _pick_spec
from test_torch_control import CASES, _assert_same_control, _specs, _stack
from torch_threads import one_thread  # noqa: F401 (one thread)

GOLDEN = Path(__file__).resolve().parent / "golden" / "control_traces.npz"
W_RTOL = W_ATOL = 1e-4
Q_RTOL, Q_ATOL = 1e-5, 1e-6

# fixed-q sign_flip, adaptive drift and scale, late onset, the three
# modes, ragged steps and n, on the paper's default problem (n_data =
# 256, d = 8)
MIX = [
    dict(byz=(2, 5), attack="sign_flip", q=0.4, seed=1, steps=40),
    dict(byz=(2,), attack="drift", q=None, seed=2, steps=40),
    dict(byz=(2, 5), attack="scale", q=None, seed=3, steps=30),
    dict(byz=(1,), attack="sign_flip", q=None, seed=4, steps=40, onset=15),
    dict(byz=(3,), attack="sign_flip", mode="deterministic", q=None, seed=5,
         steps=25),
    dict(byz=(2,), attack="drift", mode="none", q=None, seed=6, steps=40),
    dict(byz=(4,), attack="noise", q=0.5, seed=7, steps=12, n=6, f=1),
    dict(byz=(), attack="none", q=None, seed=8, steps=20),
]
_D = dict(n_data=64, d=512, lr=0.25 * 64 / 512)
BATCHES = {
    # the stream plane (auto under "device"), chunks of 3, counters on
    "stream": (MIX, dict(), dict(chunk_trials=3, telemetry=True)),
    # trials over two problems: per-trial rows, the encode kernel's plain
    # version for the updates
    "per_problem": (
        [dict(byz=(2, 5), attack="sign_flip", q=None, seed=s, steps=30,
              problem_seed=s % 2, **_D) for s in range(3)]
        + [dict(byz=(1,), attack="scale", q=0.3, seed=9, steps=30,
                problem_seed=1, **_D)],
        dict(), dict(telemetry=True)),
    # the explicit gram plane (coefficient carry, Gram-factor residuals)
    "gram": (
        [dict(byz=(2, 5), attack="sign_flip", q=None, seed=s, steps=40,
              n_data=64, d=4096, lr=16.0 / 4096) for s in range(3)]
        + [dict(byz=(3,), attack="drift", q=0.4, seed=3, steps=35,
                n_data=64, d=4096, lr=16.0 / 4096),
           dict(byz=(1, 6), attack="scale", mode="deterministic", q=None,
                seed=4, steps=40, n_data=64, d=4096, lr=16.0 / 4096)],
        dict(data_plane="gram"), dict(chunk_trials=2, telemetry=True)),
}
_cache: dict = {}


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _both(name):
    if name not in _cache:
        cfgs, kw, port_kw = BATCHES[name]
        ref = _quiet(lambda: jengine.run_batch(
            _specs(jengine, cfgs), backend="jax", mesh=None,
            schedule="device", telemetry=True, **kw))
        port = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu",
                                     schedule="device", **kw, **port_kw)
        _cache[name] = (cfgs, ref, port)
    return _cache[name]


def _adaptive(c):
    return c.get("q", 0.4) is None and c.get("mode", "randomized") \
        == "randomized"


@pytest.mark.parametrize("name", list(BATCHES))
def test_plan_and_trace(name):
    cfgs, ref, port = _both(name)
    assert port.plan.schedule_mode == ref.plan.schedule_mode == "device"
    assert port.plan.control == "device"
    assert port.plan.data_plane == ref.plan.data_plane
    assert port.schedule.mode == "device"
    assert sorted(port.device_trace) == ["check", "detect", "faulty2", "q"]
    for k in ("check", "detect", "faulty2"):
        np.testing.assert_array_equal(port.device_trace[k],
                                      ref.device_trace[k], err_msg=k)
    np.testing.assert_array_equal(port.detect_flags, ref.detect_flags)
    qt, qr = port.device_trace["q"], np.asarray(ref.device_trace["q"])
    assert qt.dtype == np.float32
    for b, c in enumerate(cfgs):
        if _adaptive(c):
            np.testing.assert_allclose(qt[:, b], qr[:, b], rtol=Q_RTOL,
                                       atol=Q_ATOL)
        else:
            np.testing.assert_array_equal(qt[:, b], qr[:, b])


@pytest.mark.parametrize("name", list(BATCHES))
def test_control_results_exact(name):
    cfgs, ref, port = _both(name)
    for c, a, b in zip(cfgs, ref, port):
        assert a.identify_step == b.identify_step
        assert a.state.kappa == b.state.kappa
        np.testing.assert_array_equal(a.state.identified, b.state.identified)
        np.testing.assert_array_equal(a.state.active, b.state.active)
        assert a.efficiency == b.efficiency
        ma, mb = a.state.meter, b.state.meter
        assert (ma.used, ma.computed, ma.iterations, ma.check_iterations,
                ma.identify_iterations, ma.history) == (
            mb.used, mb.computed, mb.iterations, mb.check_iterations,
            mb.identify_iterations, mb.history)
        if _adaptive(c):
            np.testing.assert_allclose(b.q_trace, a.q_trace, rtol=Q_RTOL,
                                       atol=Q_ATOL)
        else:
            assert a.q_trace == b.q_trace


@pytest.mark.parametrize("name", list(BATCHES))
def test_schedule_arrays_exact(name):
    _, ref, port = _both(name)
    assert ref.schedule.arrays.keys() == port.schedule.arrays.keys()
    for k, v in ref.schedule.arrays.items():
        assert v.dtype == port.schedule.arrays[k].dtype, k
        np.testing.assert_array_equal(port.schedule.arrays[k], v, err_msg=k)


@pytest.mark.parametrize("name", list(BATCHES))
def test_values_close(name):
    cfgs, ref, port = _both(name)
    for c, a, b in zip(cfgs, ref, port):
        assert len(b.losses) == c["steps"]
        np.testing.assert_allclose(b.w, np.asarray(a.w), rtol=W_RTOL,
                                   atol=W_ATOL)
        np.testing.assert_allclose(b.losses, a.losses, rtol=W_RTOL,
                                   atol=W_ATOL)


@pytest.mark.parametrize("name", list(BATCHES))
def test_counters_exact(name):
    _, ref, port = _both(name)
    tj, tt = ref.telemetry, port.telemetry
    assert tt is not None and tj.counters.keys() == tt.counters.keys()
    for k in tj.counters:
        np.testing.assert_array_equal(tt.counters[k], tj.counters[k],
                                      err_msg=k)
    assert tt.totals()["eliminations"] == sum(r.state.kappa for r in port)


@pytest.mark.parametrize("name", list(BATCHES))
def test_telemetry_is_output_neutral(name):
    """The same run without counters: W, losses and the trace bitwise
    those of the run with them."""
    cfgs, _, port = _both(name)
    _, kw, port_kw = BATCHES[name]
    plain = repro_torch.run_batch(
        _specs(tengine, cfgs), device="cpu", schedule="device", **kw,
        **dict(port_kw, telemetry=False))
    assert plain.telemetry is None
    for k in port.device_trace:
        np.testing.assert_array_equal(plain.device_trace[k],
                                      port.device_trace[k], err_msg=k)
    for a, b in zip(plain, port):
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.losses, b.losses)


def test_mix_schedule_equals_the_numpy_engines():
    """The rebuilt schedule equals the one the reference's numpy engine
    records under the same streams (vote1 is draco's, and device mode
    has none)."""
    cfgs, _, port = _both("stream")
    rec = jengine.ScheduleRecorder()
    npb = jengine.run_batch(_specs(jengine, cfgs), rng="device",
                            _recorder=rec)
    for k, v in _stack(rec).items():
        if k != "vote1":
            np.testing.assert_array_equal(port.schedule.arrays[k], v,
                                          err_msg=k)
    for a, b in zip(npb, port):
        assert a.identify_step == b.identify_step


def test_replay_control_from_trace_on_a_jax_trace():
    cfgs, ref, _ = _both("stream")
    rec = tengine.ScheduleRecorder()
    got = tengine.replay_control_from_trace(_specs(tengine, cfgs),
                                            ref.device_trace, rec)
    _assert_same_control(ref.schedule.control, got)
    arrays = _stack(rec)
    assert arrays.keys() == ref.schedule.arrays.keys()
    for k, v in ref.schedule.arrays.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    sched = device_schedule(_specs(tengine, cfgs), ref.device_trace)
    assert sched.mode == "device" and sched.used_proxy
    # a trace of the wrong shape is refused, as the reference refuses it
    bad = dict(ref.device_trace, q=np.zeros((3, len(cfgs))))
    with pytest.raises(ValueError, match="shape"):
        jengine.replay_control_from_trace(_specs(jengine, cfgs), bad)
    with pytest.raises(ValueError, match="shape"):
        tengine.replay_control_from_trace(_specs(tengine, cfgs), bad)
    dep = _specs(tengine, [dict(byz=(2,), attack="drift", selective=True)])
    with pytest.raises(ValueError, match="device RNG"):
        tengine.replay_control_from_trace(dep, ref.device_trace)


@pytest.mark.parametrize("case", list(CASES))
def test_replay_control_fast_device_rng(case):
    """``rng="device"`` runs and equals the reference's on every
    device-schedulable spec of the host-control cases; the reference's
    refusals (selective checks, membership events, draco) are the
    port's."""
    jspecs, tspecs = _specs(jengine, CASES[case]), _specs(tengine, CASES[case])
    try:
        jengine.replay_control_fast(jspecs, rng="device")
    except ValueError:
        with pytest.raises(ValueError, match="device RNG"):
            tengine.replay_control_fast(tspecs, rng="device")
        keep = [i for i, s in enumerate(jspecs)
                if jengine.device_schedulable(s)]
        jspecs = [jspecs[i] for i in keep]
        tspecs = [tspecs[i] for i in keep]
    if not jspecs:
        return
    rec_j, rec_t = jengine.ScheduleRecorder(), tengine.ScheduleRecorder()
    rj = jengine.replay_control_fast(jspecs, rec_j, rng="device")
    rt = tengine.replay_control_fast(tspecs, rec_t, rng="device")
    _assert_same_control(rj, rt)
    aj, at = _stack(rec_j), _stack(rec_t)
    assert aj.keys() == at.keys()
    for k in aj:
        assert aj[k].dtype == at[k].dtype, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)


def _golden_trace(res, rec):
    """tests/make_golden.py's per-trial trace of one run."""
    out = {k: v for k, v in rec.items()}
    active = out["active"][:, 0]
    alive_before = np.concatenate(
        [np.ones((1,) + active.shape[1:], bool), active[:-1]])
    first_out = np.where((alive_before & ~active).any(axis=0),
                         np.argmax(alive_before & ~active, axis=0), -1)
    out["isolation_step"] = first_out.astype(np.int64)
    out["q_trace"] = np.asarray(res.q_trace)
    ident = sorted(res.identify_step.items(), key=lambda kv: (kv[1], kv[0]))
    out["identify_order"] = np.array(ident, np.int64).reshape(-1, 2)
    out["identified"] = np.asarray(res.state.identified)
    out["kappa"] = np.int64(res.state.kappa)
    out["meter"] = np.array([res.state.meter.used, res.state.meter.computed,
                             res.state.meter.iterations,
                             res.state.meter.check_iterations,
                             res.state.meter.identify_iterations], np.int64)
    return out


@pytest.mark.parametrize("family", [f for f in FAMILY_PICKS
                                    if jengine.device_schedulable(
                                        _pick_spec(f))])
def test_golden_device_traces(family):
    spec = tengine.TrialSpec(**dataclasses.asdict(_pick_spec(family)))
    res = repro_torch.run_batch([spec], device="cpu", schedule="device")
    got = _golden_trace(res[0], res.schedule.arrays)
    with np.load(GOLDEN) as z:
        want = {k.split("|")[2]: z[k] for k in z.files
                if k.startswith(f"{family}|device|")}
    assert want and set(want) <= set(got) | {"vote1"}
    for k, w in want.items():
        g = np.zeros_like(w) if k == "vote1" else got[k]
        if k == "q_trace":
            np.testing.assert_allclose(g, w, rtol=Q_RTOL, atol=Q_ATOL)
        else:
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_zero_step_batch():
    cfgs = [dict(byz=(2,), attack="sign_flip", q=None, steps=0, seed=1),
            dict(byz=(1,), attack="drift", q=0.3, steps=0, seed=2, n=6,
                 f=1)]
    ref = _quiet(lambda: jengine.run_batch(
        _specs(jengine, cfgs), backend="jax", mesh=None, schedule="device"))
    port = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu",
                                 schedule="device", telemetry=True)
    assert port.schedule.mode == ref.schedule.mode == "device"
    assert port.schedule.arrays == {} == ref.schedule.arrays
    assert port.plan.steps == 0 and port.plan.control == "device"
    for k, v in ref.device_trace.items():
        assert port.device_trace[k].shape == v.shape, k
        assert port.device_trace[k].dtype == v.dtype, k
    assert port.detect_flags.shape == (0, 2)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b.w, np.asarray(a.w))
        assert (b.losses, b.q_trace, b.identify_step) == (
            a.losses, a.q_trace, a.identify_step)
    assert all((v == 0).all() for v in port.telemetry.counters.values())


def _metric_values(reg, names):
    snap = reg.snapshot()
    return {n: snap.get(n, {"value": 0})["value"] for n in names}


def test_facade_counts_the_device_plan():
    """The ``engine.plan.<plane>.device`` counter, as the reference
    counts it, and the facade's phases."""
    cfgs = MIX[:3]
    names = ["engine.batches", "engine.trials", "engine.plan.stream.device"]
    t0 = _metric_values(tmetrics.REGISTRY, names)
    j0 = _metric_values(jmetrics.REGISTRY, names)
    out = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu",
                                schedule="device")
    _quiet(lambda: jengine.run_batch(_specs(jengine, cfgs), backend="jax",
                                     mesh=None, schedule="device"))
    dt = {n: v - t0[n] for n, v in _metric_values(tmetrics.REGISTRY,
                                                  names).items()}
    dj = {n: v - j0[n] for n, v in _metric_values(jmetrics.REGISTRY,
                                                  names).items()}
    assert dt == dj == {"engine.batches": 1, "engine.trials": 3,
                        "engine.plan.stream.device": 1}
    assert set(out.phase_s) == {"host_replay", "problem_setup", "precompute",
                                "scan", "post_scan"}


def test_auto_still_routes_value_dependent_trials_to_the_oracle():
    """As in the reference, "auto" resolves value-dependent trials to
    "oracle" (the numpy engine's host replay), and the run matches the
    reference's same call; "device" runs them too."""
    cfgs = [dict(byz=(2,), attack="sign_flip", q=None, steps=5)]
    out = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu")
    ref = _quiet(lambda: jengine.run_batch(_specs(jengine, cfgs),
                                           backend="jax", mesh=None))
    assert out.plan.schedule_mode == ref.plan.schedule_mode == "oracle"
    np.testing.assert_array_equal(out.detect_flags, ref.detect_flags)
    for a, b in zip(out, ref):
        assert (a.identify_step, a.q_trace, a.efficiency) == (
            b.identify_step, b.q_trace, b.efficiency)
        np.testing.assert_allclose(a.w, np.asarray(b.w), rtol=W_RTOL,
                                   atol=W_ATOL)
    dev = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu",
                                schedule="device")
    assert dev.plan.schedule_mode == "device" and len(dev[0].losses) == 5


def _random_batch(seed):
    """Twelve seeded device-schedulable trials over n, f, byz, attacks,
    modes, fixed and adaptive q, p_tamper, onset and ragged steps, on
    one problem."""
    rng = np.random.default_rng(seed)
    d = int(rng.choice([8, 64, 512, 4096]))
    n_data = int(rng.choice([32, 64, 256]))
    cfgs = []
    for _ in range(12):
        n = int(rng.choice([5, 6, 8, 9]))
        f = int(rng.integers(1, (n - 1) // 2 + 1))
        byz = tuple(sorted(rng.choice(n, int(rng.integers(0, f + 1)),
                                      replace=False).tolist()))
        cfgs.append(dict(
            n=n, f=f, byz=byz,
            attack=str(rng.choice(["sign_flip", "scale", "drift", "noise",
                                   "none", "zero"])),
            mode=str(rng.choice(["randomized", "randomized",
                                 "deterministic", "none"])),
            q=None if rng.random() < 0.5 else float(rng.choice([0.1, 0.3,
                                                               0.5])),
            p_tamper=float(rng.choice([0.3, 0.8, 1.0])),
            steps=int(rng.integers(5, 50)), seed=int(rng.integers(0, 1 << 31)),
            onset=int(rng.integers(0, 10)), n_data=n_data, d=d,
            lr=n_data / (16.0 * max(d, n_data))))
    return cfgs


@pytest.mark.parametrize("seed,plane", [(100, "stream"), (101, "gram"),
                                        (102, "stream"), (103, "gram")])
def test_random_batches_match_the_reference(seed, plane):
    cfgs = _random_batch(seed)
    kw = dict(data_plane="gram") if plane == "gram" else {}
    ref = _quiet(lambda: jengine.run_batch(
        _specs(jengine, cfgs), backend="jax", mesh=None, schedule="device",
        **kw))
    port = repro_torch.run_batch(_specs(tengine, cfgs), device="cpu",
                                 schedule="device", **kw)
    assert port.plan.data_plane == plane
    for k in ("check", "detect", "faulty2"):
        np.testing.assert_array_equal(port.device_trace[k],
                                      ref.device_trace[k], err_msg=k)
    for k, v in ref.schedule.arrays.items():
        np.testing.assert_array_equal(port.schedule.arrays[k], v, err_msg=k)
    for c, a, b in zip(cfgs, ref, port):
        assert (a.identify_step, a.efficiency) == (b.identify_step,
                                                   b.efficiency)
        if _adaptive(c):
            np.testing.assert_allclose(b.q_trace, a.q_trace, rtol=Q_RTOL,
                                       atol=Q_ATOL)
        else:
            assert a.q_trace == b.q_trace
        np.testing.assert_allclose(b.w, np.asarray(a.w), rtol=W_RTOL,
                                   atol=W_ATOL)
