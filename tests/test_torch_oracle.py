"""The port's "oracle" and "proxy" schedules against the JAX package.

``engine_torch.build_schedule`` replays the port's numpy engine (on the
real problem for "oracle", on a tiny proxy problem for "proxy"); its
arrays must equal ``engine_jax.build_schedule``'s key by key, dtype
included.  ``repro_torch.run_batch(device="cpu")`` with the default
schedule must run every SCENARIOS family as the reference's
``run_batch(backend="jax", mesh=None)`` runs it: the same plan, exact
control and detect flags, W within 1e-4 (the tolerance of
tests/test_engine_parity.py).  Steps are cut to 96.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core.engine_jax import build_schedule as jbuild_schedule
import repro_torch
from repro_torch.core import engine as tengine
from repro_torch.core.engine_torch import build_schedule as tbuild_schedule

from test_torch_control import CASES, _specs
from test_torch_numpy_engine import family_specs, meters
from torch_threads import one_thread  # noqa: F401 (one thread)

W_RTOL = W_ATOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4


def quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def assert_same_schedule(st, sj):
    assert st.mode == sj.mode and st.used_proxy == sj.used_proxy
    assert st.arrays.keys() == sj.arrays.keys()
    for k, v in sj.arrays.items():
        assert st.arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(st.arrays[k], v, err_msg=k)
    for a, b in zip(st.control, sj.control):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace and meters(a) == meters(b)
        np.testing.assert_array_equal(a.state.identified, b.state.identified)


def assert_same_run(port, ref):
    """The plan, exact control and detect flags, W and losses within the
    f32 contract."""
    pt, pj = dataclasses.asdict(port.plan), dataclasses.asdict(ref.plan)
    assert pt.pop("backend") == "torch" and pj.pop("backend") == "jax"
    # the CPU runs the kernels' plain versions, the reference XLA's
    assert pt.pop("kernel_impl") == "torch" and pj.pop("kernel_impl") == "xla"
    assert pt == pj
    assert port.fused_used == ref.fused_used
    assert_same_schedule(port.schedule, ref.schedule)
    np.testing.assert_array_equal(port.detect_flags, ref.detect_flags)
    for s, a, b in zip(port.specs, port, ref):
        assert a.identify_step == b.identify_step, s.label
        assert a.q_trace == b.q_trace and meters(a) == meters(b), s.label
        assert a.state.kappa == b.state.kappa, s.label
        np.testing.assert_allclose(a.w, np.asarray(b.w), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=s.label)
        np.testing.assert_allclose(a.losses, b.losses, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=s.label)
        np.testing.assert_array_equal(a.w_true, b.w_true)


# value-dependent mixes: sign_flip / scale / zero against the checking
# schemes, adaptive q*, draco on flipped replicas, selective checks with
# scale, crash/recover under sign_flip
_EV = (dict(step=6, kind="crash", workers=(1,)),
       dict(step=15, kind="recover", workers=(1,)))
ORACLE_CASES = {
    "value_dependent": [
        dict(byz=(2, 5), attack="sign_flip", q=0.4, seed=1),
        dict(byz=(1, 6), attack="scale", q=None, seed=2),
        dict(byz=(3,), attack="zero", mode="deterministic", q=None, seed=3),
        dict(byz=(2, 4), attack="sign_flip", mode="draco", q=None, seed=4),
        dict(byz=(6,), attack="scale", q=0.3, selective=True, seed=5),
        dict(byz=(2,), attack="sign_flip", q=0.5, seed=6, events=_EV),
        dict(byz=(2,), attack="sign_flip", q=0.3, seed=7, onset=10),
        dict(byz=(2, 5), attack="sign_flip", mode="filter:median", seed=8),
    ],
    **{f"vi_{k}": v for k, v in CASES.items() if k != "everything"},
}


@pytest.mark.parametrize("mode", ["oracle", "proxy"])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_build_schedule_equals_reference(case, mode):
    if mode == "proxy" and case == "value_dependent":
        with pytest.raises(ValueError, match='schedule="oracle"'):
            tbuild_schedule(_specs(tengine, ORACLE_CASES[case]), mode)
        return
    st = tbuild_schedule(_specs(tengine, ORACLE_CASES[case]), mode)
    sj = jbuild_schedule(_specs(jengine, ORACLE_CASES[case]), mode)
    assert st.mode == mode and st.used_proxy == (mode == "proxy")
    assert_same_schedule(st, sj)
    assert st.arrays["m1"].dtype == st.arrays["m2"].dtype == np.int64
    assert st.arrays["shard2"].dtype == st.arrays["group2"].dtype \
        == np.int32


def test_proxy_equals_oracle_and_vector():
    """Value-independent trials: the proxy replay's schedule equals the
    real-problem replay's and the control-only replay's, and so do the
    runs (as tests/test_engine_parity.py:187-204 holds the reference)."""
    cfgs = [dict(byz=(2, 5), attack="drift", steps=80, q=0.4, seed=1),
            dict(byz=(3,), attack="drift", steps=80, mode="draco", q=None,
                 seed=0),
            dict(byz=(4,), attack="noise", steps=80, q=0.3, seed=2),
            dict(byz=(), attack="none", steps=80, q=0.4, seed=3)]
    specs = _specs(tengine, cfgs)
    runs = {m: repro_torch.run_batch(specs, device="cpu", schedule=m)
            for m in ("proxy", "oracle", "vector")}
    assert runs["proxy"].schedule.used_proxy
    assert not runs["oracle"].schedule.used_proxy
    for m in ("proxy", "vector"):
        for k, v in runs["oracle"].schedule.arrays.items():
            assert runs[m].schedule.arrays[k].dtype == v.dtype, k
            np.testing.assert_array_equal(runs[m].schedule.arrays[k], v)
        for a, b in zip(runs[m], runs["oracle"]):
            assert a.identify_step == b.identify_step
            np.testing.assert_array_equal(a.w, b.w)


@pytest.mark.parametrize("family", list(jengine.SCENARIOS))
def test_default_schedule_runs_every_family(family):
    """No schedule argument: "auto" resolves to "oracle" on every named
    scenario, and the run matches the reference's backend="jax"."""
    js, ts = family_specs(family)
    port = repro_torch.run_batch(ts, device="cpu")
    ref = quiet(lambda: jengine.run_batch(js, backend="jax", mesh=None))
    assert port.plan.schedule_mode == "oracle"
    assert_same_run(port, ref)
    # the scan's sketch verdicts equal the replay's identify rounds
    sched = port.schedule.arrays
    assert not ((port.detect_flags != sched["identify"])
                & sched["checks"]).any()


def test_scenario_matrix_runs_on_the_torch_backend():
    m = dataclasses.replace(tengine.SCENARIOS["selective"], steps=40,
                            seeds=(0,))
    jm = dataclasses.replace(jengine.SCENARIOS["selective"], steps=40,
                             seeds=(0,))
    port = m.run(backend="torch", device="cpu")
    ref = quiet(lambda: jm.run(backend="jax", mesh=None))
    assert port.plan.backend == "torch"
    assert_same_run(port, ref)
    assert [r["scenario"] for r in port.summarize()] == [
        r["scenario"] for r in ref.summarize()]


def test_scenario_matrix_defaults_to_the_card():
    """``ScenarioMatrix.run`` is an entry point of the port: with no
    backend argument it runs on the card (here, with none, it refuses and
    names device="cpu"); ``device="cpu"`` is the torch engine on the CPU
    and ``backend="numpy"`` the host's numpy engine."""
    import torch

    m = dataclasses.replace(tengine.SCENARIOS["late_onset"], steps=20,
                            seeds=(0,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            m.run()
    port = m.run(device="cpu")
    assert port.plan.backend == "torch"
    host = m.run(backend="numpy")
    npb = tengine.run_batch(m.expand())
    for a, b, c in zip(port, host, npb):
        assert a.identify_step == b.identify_step == c.identify_step
        assert a.q_trace == b.q_trace == c.q_trace
        np.testing.assert_array_equal(b.w, c.w)
        np.testing.assert_allclose(a.w, b.w, rtol=W_RTOL, atol=W_ATOL)


def _adaptive(B=6, d=1 << 11, n_data=64, T=24):
    """The reference's adaptive_sweep shape (benchmarks/bench_protocol.py
    :627-652: sign_flip on byz (2, 5), adaptive q*) at d = 2^11, with a
    contractive lr = n_data / (4 d)."""
    return [dict(byz=(2, 5), attack="sign_flip", q=None, steps=T, seed=s,
                 n_data=n_data, d=d, lr=n_data / (4.0 * d),
                 label=f"adaptive_sweep/s{s}") for s in range(B)]


PLANES = {"gram": dict(), "fused": dict(fused=True),
          "stream": dict(fused=False)}


@pytest.mark.parametrize("plane", list(PLANES))
def test_adaptive_sweep_oracle(plane):
    kw = dict(PLANES[plane], schedule="oracle")
    port = repro_torch.run_batch(_specs(tengine, _adaptive()), device="cpu",
                                 telemetry=plane == "gram", **kw)
    ref = quiet(lambda: jengine.run_batch(
        _specs(jengine, _adaptive()), backend="jax", mesh=None,
        telemetry=plane == "gram", **kw))
    assert port.plan.data_plane == ("gram" if plane == "gram" else "stream")
    assert port.plan.fused == (plane == "fused")
    assert_same_run(port, ref)
    assert port.schedule.arrays["identify"].any()
    if plane == "gram":
        for k, v in ref.telemetry.counters.items():
            np.testing.assert_array_equal(port.telemetry.counters[k],
                                          np.asarray(v), err_msg=k)
    # the schedule is the numpy engine's own run on the same specs
    npb = tengine.run_batch(_specs(tengine, _adaptive()))
    for a, b in zip(port, npb):
        assert a.q_trace == b.q_trace and a.identify_step == b.identify_step
        assert meters(a) == meters(b) and a.state.kappa == b.state.kappa


def test_oracle_chunked_equals_unchunked():
    specs = _specs(tengine, ORACLE_CASES["value_dependent"][:5], steps=30)
    whole = repro_torch.run_batch(specs, device="cpu")
    parts = repro_torch.run_batch(specs, device="cpu", chunk_trials=2)
    assert parts.plan.chunk_trials == 2
    np.testing.assert_array_equal(parts.detect_flags, whole.detect_flags)
    for a, b in zip(whole, parts):
        assert a.identify_step == b.identify_step
        np.testing.assert_allclose(b.w, a.w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["oracle", "proxy"])
def test_zero_steps_return_the_real_problem(mode):
    """steps == 0: the real problem's zero iterate and w_true, never the
    proxy problem's (tests/test_engine_parity.py:238-246)."""
    attack = "sign_flip" if mode == "oracle" else "drift"
    spec = tengine.TrialSpec(byz=(2,), attack=attack, steps=0, q=0.5)
    rn = tengine.run_batch([spec])[0]
    out = repro_torch.run_batch([spec], device="cpu", schedule=mode)
    assert out.plan.steps == 0 and out.schedule.mode == mode
    assert out[0].w.shape == rn.w.shape
    assert out[0].final_error == rn.final_error
    assert out[0].losses == rn.losses == []


def test_refusals_name_the_accepting_plan():
    """The reference's own refusals stay: a non-affine callable attack
    and a filter the data plane lacks name backend="numpy"; "proxy" on a
    value-dependent trial names "oracle"."""
    def attack(g):
        return g ** 2

    with pytest.raises(NotImplementedError, match='backend="numpy"'):
        repro_torch.run_batch([tengine.TrialSpec(attack=attack, steps=5)],
                              device="cpu")
    gmom = tengine.TrialSpec(byz=(2,), mode="filter:gmom", steps=5)
    with pytest.raises(NotImplementedError, match='backend="numpy"'):
        repro_torch.run_batch([gmom], device="cpu")
    assert len(tengine.run_batch([gmom])[0].losses) == 5
    flip = tengine.TrialSpec(byz=(2,), attack="sign_flip", steps=5)
    with pytest.raises(ValueError, match='schedule="device"'):
        repro_torch.run_batch([flip], device="cpu", schedule="proxy")
    with pytest.raises(ValueError, match="unknown schedule mode"):
        tbuild_schedule([flip], "replay")


def test_oracle_phases():
    _, specs = family_specs("attack_sweep", 20)
    out = repro_torch.run_batch(specs, device="cpu")
    assert set(out.phase_s) == {"host_replay", "problem_setup",
                                "precompute", "scan", "post_scan"}
    assert out.device_trace is None and out.schedule.mode == "oracle"
