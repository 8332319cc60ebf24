"""The port's host control plane and plan layer against the JAX package.

The vectorized control replay consumes the same numpy RNG streams in
the same order as the reference, so its schedule arrays and control
results must be BITWISE the reference's; ``resolve_plan`` must agree
field by field, apart from ``backend``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core.engine_jax import build_schedule as jbuild_schedule
from repro.core.engineplan import plan as jplan
from repro_torch.core import engine as tengine
from repro_torch.core.engine_torch import build_schedule as tbuild_schedule
from repro_torch.core.engineplan import plan as tplan
from repro_torch.obs import oblog as toblog
from torch_threads import one_thread  # noqa: F401 (one thread)

_EV = (dict(step=6, kind="crash", workers=(1,)),
       dict(step=15, kind="recover", workers=(1,)))

CASES = {
    "modes": [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=1),
        dict(byz=(1,), attack="drift", mode="deterministic", q=None, seed=2),
        dict(byz=(3,), attack="drift", mode="draco", q=None, seed=3),
        dict(byz=(2,), attack="drift", mode="none", q=None, seed=4),
        dict(byz=(6,), attack="drift", q=0.3, selective=True, seed=7),
    ],
    "attacks": [
        dict(byz=(2, 5), attack="none", q=0.5, seed=11),
        dict(byz=(2, 5), attack="drift", q=0.5, seed=12),
        dict(byz=(4,), attack="noise", q=0.3, seed=13),
        dict(byz=(3,), attack="noise", mode="draco", q=None, seed=14),
    ],
    "onset": [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=21, onset=12),
        dict(byz=(1,), attack="noise", mode="deterministic", q=None,
             seed=22, onset=30),
    ],
    "events": [
        dict(byz=(2,), attack="drift", q=0.5, seed=31, events=_EV),
        dict(byz=(3,), attack="drift", mode="draco", q=None, seed=32,
             events=_EV),
        dict(byz=(4,), attack="noise", q=0.4, selective=True, seed=33,
             events=_EV),
    ],
    "mixed_steps": [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=41, steps=10),
        dict(byz=(1,), attack="drift", mode="draco", q=None, seed=42,
             steps=35),
        dict(byz=(), attack="none", q=0.4, seed=43, steps=0),
        dict(byz=(2,), attack="noise", q=0.6, seed=44, steps=50),
    ],
    "n_f_mix": [
        dict(byz=(2,), attack="drift", q=0.2, seed=51, n=6, f=1),
        dict(byz=(1, 4, 7), attack="drift", q=0.5, seed=52, n=10, f=3),
        dict(byz=(0,), attack="noise", mode="draco", q=None, seed=53, n=5,
             f=1),
    ],
}
CASES["everything"] = [c for cs in CASES.values() for c in cs]


def _specs(mod, cfgs, steps=40):
    out = []
    for c in cfgs:
        c = dict(c)
        c.setdefault("steps", steps)
        ev = c.pop("events", ())
        out.append(mod.TrialSpec(
            **c, events=tuple(mod.FaultEvent(**e) for e in ev)))
    return out


def _stack(rec):
    keys = rec.steps[0].keys() if rec.steps else ()
    return {k: np.stack([st[k] for st in rec.steps]) for k in keys}


def _assert_same_control(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace
        assert a.efficiency == b.efficiency
        ma, mb = a.state.meter, b.state.meter
        assert (ma.used, ma.computed, ma.iterations, ma.check_iterations,
                ma.identify_iterations, ma.history) == (
            mb.used, mb.computed, mb.iterations, mb.check_iterations,
            mb.identify_iterations, mb.history)
        for f in ("active", "identified", "crashed", "alpha", "beta"):
            np.testing.assert_array_equal(getattr(a.state, f),
                                          getattr(b.state, f), err_msg=f)
        assert a.state.last_q == b.state.last_q


@pytest.mark.parametrize("case", list(CASES))
def test_replay_control_fast_bitwise(case):
    rec_j, rec_t = jengine.ScheduleRecorder(), tengine.ScheduleRecorder()
    rj = jengine.replay_control_fast(_specs(jengine, CASES[case]), rec_j)
    rt = tengine.replay_control_fast(_specs(tengine, CASES[case]), rec_t)
    _assert_same_control(rj, rt)
    aj, at = _stack(rec_j), _stack(rec_t)
    assert aj.keys() == at.keys()
    for k in aj:
        assert aj[k].dtype == at[k].dtype, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)


@pytest.mark.parametrize("case", ["modes", "events", "everything"])
def test_build_schedule_vector_bitwise(case):
    sj = jbuild_schedule(_specs(jengine, CASES[case]), "vector")
    st = tbuild_schedule(_specs(tengine, CASES[case]), "vector")
    assert (sj.mode, sj.used_proxy) == (st.mode, st.used_proxy)
    for k in sj.arrays:
        np.testing.assert_array_equal(sj.arrays[k], st.arrays[k], err_msg=k)
    _assert_same_control(sj.control, st.control)


def test_replay_rejects_what_the_reference_rejects():
    dep = [dict(byz=(2,), attack="sign_flip", q=0.4, seed=1)]
    with pytest.raises(ValueError):
        jengine.replay_control_fast(_specs(jengine, dep))
    with pytest.raises(ValueError):
        tengine.replay_control_fast(_specs(tengine, dep))
    with pytest.raises(ValueError):
        jengine.replay_control_fast(_specs(jengine, dep), rng="device")
    with pytest.raises(ValueError):
        tengine.replay_control_fast(_specs(tengine, dep), rng="device")
    # rng="device" runs, and equals the reference's
    rec_j, rec_t = jengine.ScheduleRecorder(), tengine.ScheduleRecorder()
    _assert_same_control(
        jengine.replay_control_fast(_specs(jengine, CASES["modes"][:1]),
                                    rec_j, rng="device"),
        tengine.replay_control_fast(_specs(tengine, CASES["modes"][:1]),
                                    rec_t, rng="device"))
    aj, at = _stack(rec_j), _stack(rec_t)
    for k in aj:
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)
    ok = _specs(tengine, CASES["modes"][:1])
    with pytest.raises(ValueError):
        jengine.replay_control_fast(_specs(jengine, CASES["modes"][:1]),
                                    rng="bogus")
    with pytest.raises(ValueError):
        tengine.replay_control_fast(ok, rng="bogus")


PLAN_SPECS = {
    "vi_small": [dict(byz=(2, 5), attack="drift", q=0.4, seed=1),
                 dict(byz=(3,), attack="noise", mode="draco", q=None)],
    "vi_big_d": [dict(byz=(2, 5), attack="drift", q=0.2, seed=s, n_data=64,
                      d=1 << 20) for s in range(3)],
    "adaptive": [dict(byz=(2,), attack="sign_flip", q=None, seed=2)],
    "filter": [dict(byz=(2,), attack="drift", mode="filter:median", q=0.4),
               dict(byz=(2,), attack="drift", q=0.4)],
    "mixed_problems": [dict(byz=(2,), attack="drift", q=0.4, d=4096,
                            n_data=64, problem_seed=p) for p in (0, 1)],
    "zero_steps": [dict(byz=(2,), attack="drift", q=0.4, steps=0)],
    "events": [dict(byz=(2,), attack="drift", q=0.5, events=_EV)],
}
PLAN_KW = [
    {},
    dict(data_plane="gram"),
    dict(data_plane="stream"),
    dict(fused=True),
    dict(fused=False),
    dict(schedule="oracle"),
    dict(schedule="device"),
    dict(schedule="device", data_plane="gram"),
    dict(chunk_trials=2),
    dict(chunk_trials=0),
    dict(telemetry=True, stream_dtype="bf16", kernel_impl="torch"),
    dict(n_devices=3, chunk_trials=4),
    dict(data_plane="gram", fused=True),
    dict(data_plane="bogus"),
]


@pytest.mark.parametrize("kw", PLAN_KW, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
@pytest.mark.parametrize("name", list(PLAN_SPECS))
def test_resolve_plan_field_by_field(name, kw):
    jspecs = _specs(jengine, PLAN_SPECS[name])
    tspecs = _specs(tengine, PLAN_SPECS[name])
    try:
        pj = jplan.resolve_plan(jspecs, **kw)
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            tplan.resolve_plan(tspecs, **kw)
        return
    pt = tplan.resolve_plan(tspecs, **kw)
    dj, dt = dataclasses.asdict(pj), dataclasses.asdict(pt)
    assert (dj.pop("backend"), dt.pop("backend")) == ("jax", "torch")
    assert dj == dt


def test_predicates_agree():
    for cfgs in list(CASES.values()) + list(PLAN_SPECS.values()):
        for sj, st in zip(_specs(jengine, cfgs), _specs(tengine, cfgs)):
            for fn in ("value_independent_control", "device_schedulable",
                       "is_adaptive", "filter_name"):
                assert getattr(jplan, fn)(sj) == getattr(tplan, fn)(st), fn


def test_warn_on_fallback_once_per_reason():
    specs = _specs(tengine, PLAN_SPECS["filter"])
    plan = tplan.resolve_plan(specs, data_plane="gram")
    assert plan.data_plane == "stream"
    toblog.reset_warn_once()
    with pytest.warns(tplan.PlanFallbackWarning, match="gram"):
        tplan.warn_on_fallback(plan)
    assert not toblog.warn_once("again", tplan.PlanFallbackWarning,
                                key=("gram_fallback", plan.data_plane_reason))
    toblog.reset_warn_once()
