"""The port's numpy engine and its building blocks against the JAX package.

``repro_torch.core.engine.run_batch`` is the reference's host engine
copied as it stands, so on the same seeded inputs it must give the
reference's bits: W, losses, q-traces, meters, identify steps, kappa and
the recorded schedule arrays (dtype included) on every non-filter trial
of every ``SCENARIOS`` family, under ``rng="host"`` and ``rng="device"``
and with ``telemetry=True``.  Filter trials run the port's torch filters
in float32 where the reference runs its JAX filters in float32: control
exact, W within 1e-4.  Steps are cut to 96, as tests/make_golden.py cuts
them.  The serial ``run_protocol`` must equal the batched engine
bitwise (the reference's own contract) and the reference's
``run_protocol``; the golden ``*|host|*`` traces
(``tests/golden/control_traces.npz``, read-only) must be reproduced.
The building blocks (filters, assignments, votes, DRACO, the protocol
state) are held against the reference's one by one.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assignment as jassign
from repro.core import draco as jdraco
from repro.core import engine as jengine
from repro.core import filters as jfilters
from repro.core import identification as jident
from repro.core import randomized as jrand
from repro.core import simulation as jsim
import repro_torch
from repro_torch.core import assignment as tassign
from repro_torch.core import draco as tdraco
from repro_torch.core import engine as tengine
from repro_torch.core import filters as tfilters
from repro_torch.core import identification as tident
from repro_torch.core import randomized as trand
from repro_torch.core import simulation as tsim

from make_golden import FAMILY_PICKS, _pick_spec
from test_torch_control import _stack
from test_torch_device_control import _golden_trace
from torch_threads import one_thread  # noqa: F401 (one thread)

GOLDEN = Path(__file__).resolve().parent / "golden" / "control_traces.npz"
STEPS = 96
W_TOL = 1e-4
FAMILIES = list(jengine.SCENARIOS)


def port_spec(s):
    """The port's TrialSpec with the reference spec's fields."""
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    kw["events"] = tuple(tengine.FaultEvent(e.step, e.kind, e.workers)
                         for e in s.events)
    return tengine.TrialSpec(**kw)


def family_specs(family, steps=STEPS):
    """The family's reference specs cut to ``steps``, and the port's."""
    js = [dataclasses.replace(s, steps=steps)
          for s in jengine.SCENARIOS[family].expand()]
    return js, [port_spec(s) for s in js]


def is_filter(s) -> bool:
    return s.mode.startswith("filter")


def meters(r):
    m = r.state.meter
    return (m.used, m.computed, m.iterations, m.check_iterations,
            m.identify_iterations, m.history)


def assert_trial(rt, rj, filt: bool, label: str):
    """Bitwise for protocol trials; control exact and W within 1e-4 for
    the filter baselines."""
    assert rt.identify_step == rj.identify_step, label
    assert rt.q_trace == rj.q_trace, label
    assert meters(rt) == meters(rj), label
    assert rt.state.kappa == rj.state.kappa, label
    np.testing.assert_array_equal(rt.state.active, rj.state.active)
    np.testing.assert_array_equal(rt.w_true, rj.w_true)
    if filt:
        np.testing.assert_allclose(rt.w, rj.w, rtol=W_TOL, atol=W_TOL,
                                   err_msg=label)
        np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-3,
                                   atol=W_TOL, err_msg=label)
    else:
        assert rt.w.dtype == rj.w.dtype == np.float64, label
        np.testing.assert_array_equal(rt.w, rj.w, err_msg=label)
        assert rt.losses == rj.losses, label


def assert_same_arrays(at, aj):
    assert at.keys() == aj.keys()
    for k in aj:
        assert at[k].dtype == aj[k].dtype, k
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)


def run_both(js, ts, **kw):
    rec_j, rec_t = jengine.ScheduleRecorder(), tengine.ScheduleRecorder()
    rj = jengine.run_batch(js, _recorder=rec_j, **kw)
    rt = tengine.run_batch(ts, _recorder=rec_t, **kw)
    return rt, rj, _stack(rec_t), _stack(rec_j)


# ---------------------------------------------------------------------------
# The batched engine on every SCENARIOS family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_family_host_streams_bitwise(family):
    """rng="host", telemetry on: every trial, every recorder array, every
    counter."""
    js, ts = family_specs(family)
    rt, rj, at, aj = run_both(js, ts, telemetry=True)
    for s, a, b in zip(ts, rt, rj):
        assert_trial(a, b, is_filter(s), s.label)
    assert_same_arrays(at, aj)
    assert rt.telemetry.counters.keys() == rj.telemetry.counters.keys()
    for k, v in rj.telemetry.counters.items():
        np.testing.assert_array_equal(rt.telemetry.counters[k], v,
                                      err_msg=k)
    assert [r.efficiency for r in rt] == [r.efficiency for r in rj]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_telemetry_is_output_neutral(family):
    """The counters change no output bit, as in the reference."""
    _, ts = family_specs(family, steps=40)
    off = tengine.run_batch(ts)
    on = tengine.run_batch(ts, telemetry=True)
    assert off.telemetry is None and on.telemetry is not None
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.w, b.w)
        assert (a.losses, a.q_trace, a.identify_step) == (
            b.losses, b.q_trace, b.identify_step)


_DEVICE_FAMILIES = [f for f in FAMILIES if any(
    jengine.device_schedulable(s) for s in jengine.SCENARIOS[f].expand())]


@pytest.mark.parametrize("family", _DEVICE_FAMILIES)
def test_family_device_streams_bitwise(family):
    """rng="device" (the counter-RNG streams) on the family's
    device-schedulable trials."""
    js, ts = family_specs(family)
    keep = [i for i, s in enumerate(js) if jengine.device_schedulable(s)]
    js, ts = [js[i] for i in keep], [ts[i] for i in keep]
    rt, rj, at, aj = run_both(js, ts, rng="device", telemetry=True)
    for s, a, b in zip(ts, rt, rj):
        assert_trial(a, b, False, s.label)
    assert_same_arrays(at, aj)
    for k, v in rj.telemetry.counters.items():
        np.testing.assert_array_equal(rt.telemetry.counters[k], v,
                                      err_msg=k)


def test_device_streams_refuse_unschedulable_trials():
    _, ts = family_specs("elastic_churn", steps=5)
    with pytest.raises(ValueError, match="device RNG streams undefined"):
        tengine.run_batch(ts, rng="device")
    with pytest.raises(ValueError, match="unknown rng"):
        tengine.run_batch(ts, rng="counter")


@pytest.mark.parametrize("family", list(FAMILY_PICKS))
def test_golden_host_traces(family):
    """The archived ``*|host|*`` traces of tests/make_golden.py."""
    spec = port_spec(_pick_spec(family))
    rec = tengine.ScheduleRecorder()
    res = tengine.run_batch([spec], _recorder=rec)
    got = _golden_trace(res[0], _stack(rec))
    with np.load(GOLDEN) as z:
        want = {k.split("|")[2]: z[k] for k in z.files
                if k.startswith(f"{family}|host|")}
    assert want and set(want) <= set(got)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mixed_problems_and_ragged_steps_bitwise():
    """Trials over several problems and ragged step counts in one batch
    (per-trial A_b, the live mask)."""
    cfgs = [dict(byz=(2, 5), attack="sign_flip", q=0.4, seed=1, steps=50,
                 problem_seed=0),
            dict(byz=(1,), attack="scale", q=None, seed=2, steps=30,
                 problem_seed=3),
            dict(byz=(3,), attack="zero", mode="draco", q=None, seed=3,
                 steps=70, problem_seed=3),
            dict(byz=(4,), attack="noise", q=0.3, seed=4, steps=0),
            dict(byz=(2,), attack="sign_flip", q=0.5, seed=5, steps=60,
                 n=6, f=1, problem_seed=1)]
    js = [jengine.TrialSpec(**c) for c in cfgs]
    rt, rj, at, aj = run_both(js, [port_spec(s) for s in js])
    for a, b in zip(rt, rj):
        assert_trial(a, b, False, "mixed")
    assert_same_arrays(at, aj)


def test_callable_attack_bitwise_and_refused_on_the_device():
    """A custom attack callable runs per row in the numpy engine; the
    device engine refuses it, naming the numpy backend."""
    def attack(g):
        return g[::-1] * 3.0

    kw = dict(byz=(2, 5), attack=attack, q=0.4, seed=3, steps=60)
    rt = tengine.run_batch([tengine.TrialSpec(**kw)])
    rj = jengine.run_batch([jengine.TrialSpec(**kw)])
    assert_trial(rt[0], rj[0], False, "callable")
    with pytest.raises(NotImplementedError, match='backend="numpy"'):
        repro_torch.run_batch([tengine.TrialSpec(**kw)], device="cpu")


def test_backend_dispatch():
    """backend="torch" is the device engine; rng="device" and unknown
    backends or knobs are refused as the reference refuses them."""
    specs = [tengine.TrialSpec(byz=(2,), attack="sign_flip", q=0.4, seed=1,
                               steps=12)]
    a = tengine.run_batch(specs, backend="torch", device="cpu")
    b = repro_torch.run_batch(specs, device="cpu")
    assert a.plan == b.plan and a.plan.schedule_mode == "oracle"
    np.testing.assert_array_equal(a[0].w, b[0].w)
    with pytest.raises(ValueError, match='schedule="device"'):
        tengine.run_batch(specs, backend="torch", rng="device")
    with pytest.raises(ValueError, match="unknown engine backend"):
        tengine.run_batch(specs, backend="jax")
    with pytest.raises(TypeError, match="no extra kwargs"):
        tengine.run_batch(specs, device="cpu")
    with pytest.raises(ValueError, match="share"):
        tengine.run_batch(specs + [dataclasses.replace(specs[0], d=4)])
    empty = tengine.run_batch([], telemetry=True)
    assert len(empty) == 0 and empty.telemetry is not None


def test_summarize_and_by_label():
    js, ts = family_specs("late_onset", steps=60)
    rt, rj = tengine.run_batch(ts), jengine.run_batch(js)
    assert rt.summarize() == rj.summarize()
    assert rt.by_label().keys() == rj.by_label().keys()


def test_scenario_matrices_expand_as_the_reference():
    assert list(tengine.SCENARIOS) == list(jengine.SCENARIOS)
    for name, m in tengine.SCENARIOS.items():
        got = [dataclasses.asdict(s) for s in m.expand()]
        want = [dataclasses.asdict(port_spec(s))
                for s in jengine.SCENARIOS[name].expand()]
        assert got == want, name
    assert tengine.ModeSpec("x").mode == jengine.ModeSpec("x").mode
    assert tengine.FaultPattern("y", (1,)).byz == (1,)
    assert repro_torch.SCENARIOS is tengine.SCENARIOS


# ---------------------------------------------------------------------------
# The serial reference
# ---------------------------------------------------------------------------

SERIAL = {
    "randomized": dict(byz=(2, 5), attack="sign_flip", q=0.4, seed=1),
    "adaptive": dict(byz=(2, 5), attack="sign_flip", q=None, seed=3),
    "deterministic": dict(byz=(1,), attack="drift", mode="deterministic",
                          q=None, seed=2),
    "draco": dict(byz=(3,), attack="scale", mode="draco", q=None, seed=0),
    "selective": dict(byz=(6,), attack="scale", q=0.3, selective=True,
                      seed=7),
    "none": dict(byz=(2,), attack="sign_flip", mode="none", q=None, seed=4),
    "zero_n6": dict(byz=(2,), attack="zero", q=0.2, seed=9, n=6, f=1),
    "noise": dict(byz=(4,), attack="noise", q=0.3, seed=12),
    "problem3": dict(byz=(2, 5), attack="drift", q=0.5, seed=13,
                     problem_seed=3),
    "filter_median": dict(byz=(2, 5), attack="sign_flip",
                          mode="filter:median", seed=5),
    "filter_krum": dict(byz=(2, 5), attack="sign_flip", mode="filter:krum",
                        seed=5),
    "filter_gmom": dict(byz=(2,), attack="scale", mode="filter",
                        filter_name="gmom", seed=6),
}
_serial_batch: dict = {}


def _batched():
    if not _serial_batch:
        specs = [tengine.TrialSpec(**c, steps=STEPS) for c in SERIAL.values()]
        _serial_batch.update(zip(SERIAL, tengine.run_batch(specs)))
    return _serial_batch


@pytest.mark.parametrize("name", list(SERIAL))
def test_run_protocol_equals_batched_engine_bitwise(name):
    """The reference's engine[bitwise_parity] contract, in the port:
    every trial of one mixed batch equals its serial run bit for bit."""
    rs = tsim.run_protocol(**SERIAL[name], steps=STEPS)
    rb = _batched()[name]
    np.testing.assert_array_equal(rs.w, rb.w)
    assert rs.final_error == rb.final_error
    assert rs.losses == rb.losses and rs.q_trace == rb.q_trace
    assert rs.identify_step == rb.identify_step
    assert rs.efficiency == rb.efficiency
    assert rs.state.meter.history == rb.state.meter.history


@pytest.mark.parametrize("name", list(SERIAL))
def test_run_protocol_equals_reference(name):
    rt = tsim.run_protocol(**SERIAL[name], steps=STEPS)
    rj = jsim.run_protocol(**SERIAL[name], steps=STEPS)
    assert_trial(rt, rj, name.startswith("filter"), name)


def test_attack_table_as_the_reference():
    g = np.random.default_rng(0).normal(size=(3, 5))
    assert list(tsim.ATTACKS) == list(jsim.ATTACKS)
    for k in jsim.ATTACKS:
        np.testing.assert_array_equal(tsim.ATTACKS[k](g), jsim.ATTACKS[k](g))
    A, y, w = tsim.make_problem(n_data=16, d=3, seed=4)
    for a, b in zip((A, y, w), jsim.make_problem(n_data=16, d=3, seed=4)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _grads(kind: str):
    rng = np.random.default_rng(7)
    if kind == "odd":
        return rng.normal(size=(7, 33)).astype(np.float32)
    if kind == "even":
        return rng.normal(size=(8, 33)).astype(np.float32)
    if kind == "ties":        # repeated rows and coordinates: tied scores
        g = rng.normal(size=(3, 9)).astype(np.float32)
        return np.concatenate([g, g, g[:1], np.zeros((1, 9), np.float32)])
    if kind == "outliers":
        g = rng.normal(size=(9, 17)).astype(np.float32)
        g[[2, 5]] *= -5e3
        return g
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["odd", "even", "ties", "outliers"])
@pytest.mark.parametrize("name", list(jfilters.FILTERS))
def test_filter_matches_reference(name, kind):
    g = _grads(kind)
    for f in (1, 2):
        want = np.asarray(jfilters.FILTERS[name](jnp.asarray(g), f))
        got = tfilters.FILTERS[name](torch.from_numpy(g), f)
        assert got.dtype == torch.float32 and got.shape == (g.shape[1],)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} f={f}")


def test_krum_ties_pick_the_lowest_index_and_median_interpolates():
    g = _grads("ties")
    sel = tfilters.krum(torch.from_numpy(g), 1, m=2)
    np.testing.assert_array_equal(
        sel.numpy(), np.asarray(jfilters.krum(jnp.asarray(g), 1, m=2)))
    even = torch.tensor([[1.0], [2.0], [4.0], [10.0]])
    assert float(tfilters.coordinate_median(even)) == 3.0 == float(
        jfilters.coordinate_median(jnp.asarray(even.numpy()))[0])


def test_trimmed_mean_refuses_2f_ge_n():
    g = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="2f < n"):
        tfilters.trimmed_mean(g, 2)
    with pytest.raises(ValueError, match="2f < n"):
        jfilters.trimmed_mean(jnp.zeros((4, 3)), 2)


def test_norm_clip_fixed_clip():
    g = _grads("outliers")
    want = np.asarray(jfilters.norm_clip(jnp.asarray(g), 0.5))
    got = tfilters.norm_clip(torch.from_numpy(g), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _assignment_eq(a, b):
    for f in ("shard_of_worker", "group_of_worker", "weight", "shard_sizes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.num_shards, a.replication, a.n) == (
        b.num_shards, b.replication, b.n)
    assert a.gradients_computed() == b.gradients_computed()
    assert a.efficiency() == b.efficiency()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_builders_match_reference(seed):
    active = np.ones(11, bool)
    active[[3, 7]] = False
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for r in (1, 2, 3, 4):
        _assignment_eq(tassign.build_assignment(active, r, rt),
                       jassign.build_assignment(active, r, rj))
    for fn in ("check_assignment", "identify_assignment"):
        a = getattr(tassign, fn)(active, 2, rt)
        b = getattr(jassign, fn)(active, 2, rj)
        _assignment_eq(a, b)
        for x, y in zip(tassign.group_members(a), jassign.group_members(b)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tassign.shard_batch_indices(a, 50),
                                      jassign.shard_batch_indices(b, 50))
    _assignment_eq(tassign.fast_assignment(active),
                   jassign.fast_assignment(active))
    with pytest.raises(ValueError, match="not enough active"):
        tassign.build_assignment(np.ones(2, bool), 3)
    with pytest.raises(ValueError, match="global batch"):
        tassign.shard_batch_indices(tassign.fast_assignment(active), 3)


def test_draco_matches_reference():
    active = np.ones(9, bool)
    _assignment_eq(tdraco.draco_assignment(active, 2),
                   jdraco.draco_assignment(active, 2))
    assert tdraco.draco_efficiency(3) == jdraco.draco_efficiency(3)


def _replicas(kind):
    rng = np.random.default_rng(3)
    g = rng.normal(size=41)
    reps = np.stack([g] * 5)
    if kind == "one_tampered":
        reps[1] *= -5.0
    elif kind == "two_tampered":
        reps[[0, 4]] += 1.0
    elif kind == "no_majority":
        reps = np.stack([g + i for i in range(5)])
    elif kind == "within_tau":
        reps[3] *= 1.0 + 1e-7
    return reps


@pytest.mark.parametrize("kind", ["clean", "one_tampered", "two_tampered",
                                  "no_majority", "within_tau"])
def test_majority_votes_match_reference(kind):
    reps = _replicas(kind)
    for tau in (1e-9, jident.DEFAULT_TAU):
        vt, ft, okt = tident.majority_vote_np(reps, tau=tau)
        vj, fj, okj = jident.majority_vote_np(reps, tau=tau)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        assert okt == okj and vt.dtype == np.float32
        r32 = reps.astype(np.float32)
        v, f, ok = tident.majority_vote(torch.from_numpy(r32), tau)
        jv, jf, jok = jident.majority_vote(jnp.asarray(r32), tau)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        assert bool(ok) == bool(jok)
        np.testing.assert_array_equal(
            tident.pairwise_agreement(torch.from_numpy(r32), tau).numpy(),
            np.asarray(jident.pairwise_agreement(jnp.asarray(r32), tau)))


def test_protocol_state_matches_reference_and_round_trips():
    cfg = dict(n=9, f=2, mode="randomized", q=0.3, seed=11)
    st = trand.ProtocolState.create(trand.BFTConfig(**cfg))
    sj = jrand.ProtocolState.create(jrand.BFTConfig(**cfg))
    for _ in range(3):
        _assignment_eq(st.assignment_check(), sj.assignment_check())
        _assignment_eq(st.assignment_identify(), sj.assignment_identify())
        assert st.decide_check(0.5) == sj.decide_check(0.5)
    st.on_identified(np.array([4]))
    sj.on_identified(np.array([4]))
    _assignment_eq(st.assignment_fast(), sj.assignment_fast())
    st.meter.record(3, 9, checked=True)
    saved = st.state_dict()
    want = [st.assignment_check() for _ in range(2)]
    want_coin = st.decide_check(1.0)
    other = trand.ProtocolState.create(trand.BFTConfig(**cfg))
    other.load_state_dict(saved)
    assert other.kappa == 1 and other.meter.used == 3
    for w in want:
        _assignment_eq(other.assignment_check(), w)
    assert other.decide_check(1.0) == want_coin
    assert saved.keys() == sj.state_dict().keys()
