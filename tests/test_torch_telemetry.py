"""``repro_torch.run_batch(..., telemetry=True)`` against the JAX package,
on the CPU.

The protocol counters are control quantities, so they must equal the
reference's EXACTLY, per trial and per key, on every host-control data
plane the port runs (gram, fused f32, fused bf16 rows, unfused stream,
per-trial problems, filter baselines), against two references: the JAX
backend (``run_batch(..., backend="jax", mesh=None, telemetry=True)``)
and the numpy engine (``run_batch(..., telemetry=True)``).  The batches
hold drift / noise trials, draco and deterministic (vote1) trials, and
identify rounds with eliminations.  Also, as tests/test_telemetry.py
asks of the reference: telemetry is output-neutral (W, losses and detect
flags bitwise those of the run without), the counters are sums over the
recorded schedule, degenerate batches give zero counters, and chunking
changes nothing in the counters and flags (W and losses within the
reference's chunking tolerance, rtol 1e-5 / atol 1e-6,
tests/test_sharded_engine.py:162-171).  The facade and the pipeline
emit the reference's spans and counters.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
import repro_torch
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.obs.telemetry import TEL_KEYS
from torch_threads import one_thread  # noqa: F401 (one thread)

CHUNK_RTOL, CHUNK_ATOL = 1e-5, 1e-6

BASE = [
    dict(byz=(2, 5), attack="drift", q=0.3, seed=0),
    dict(byz=(2, 5), attack="drift", q=0.3, seed=1),
    dict(byz=(4,), attack="noise", q=0.5, seed=2),
    dict(byz=(3,), attack="drift", mode="draco", q=None, seed=3),
    dict(byz=(1,), attack="noise", mode="deterministic", q=None, seed=4,
         onset=10),
    dict(byz=(), attack="none", q=0.4, seed=5),
]
FILTERS = [
    dict(byz=(2, 5), attack="drift", mode="filter:median", q=0.3, seed=6),
    dict(byz=(1,), attack="noise", mode="filter:krum", q=0.3, seed=7),
    dict(byz=(3,), attack="drift", mode="filter:mean", q=0.3, seed=8),
]
SIZE = dict(steps=40, d=8, n_data=32)

# plane -> (run_batch keywords, trial configurations)
PLANES = {
    "gram": (dict(data_plane="gram"), BASE),
    "fused": (dict(fused=True), BASE),
    "bf16": (dict(fused=True, stream_dtype="bf16"), BASE),
    "stream": (dict(fused=False), BASE),
    "per_problem": (dict(), [dict(c, problem_seed=c["seed"] % 3)
                             for c in BASE]),
    "filter": (dict(), BASE[:4] + FILTERS),
}


def _specs(mod, cfgs, **over):
    return [mod.TrialSpec(**dict(SIZE, **c, **over)) for c in cfgs]


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


_cache: dict = {}


def _runs(plane):
    """(port on, port off, JAX backend on, numpy engine on) for a plane."""
    if plane not in _cache:
        kw, cfgs = PLANES[plane]
        tspecs, jspecs = _specs(repro_torch, cfgs), _specs(jengine, cfgs)
        _cache[plane] = (
            repro_torch.run_batch(tspecs, device="cpu", telemetry=True, **kw),
            repro_torch.run_batch(tspecs, device="cpu", **kw),
            _quiet(lambda: jengine.run_batch(jspecs, backend="jax", mesh=None,
                                             telemetry=True, **kw)),
            jengine.run_batch(jspecs, telemetry=True))
    return _cache[plane]


def _assert_counters_equal(got, want, context):
    assert got is not None and want is not None
    for k in TEL_KEYS:
        assert got.counters[k].dtype == np.int64
        np.testing.assert_array_equal(got.counters[k], want.counters[k],
                                      err_msg=f"{context}:{k}")


@pytest.mark.parametrize("plane", list(PLANES))
def test_counters_equal_jax_and_numpy(plane):
    on, _, jax_on, np_on = _runs(plane)
    kw = PLANES[plane][0]
    if "data_plane" in kw:
        assert on.plan.data_plane == jax_on.plan.data_plane == "gram"
    else:
        assert on.plan.data_plane == jax_on.plan.data_plane == "stream"
        assert on.plan.fused == jax_on.plan.fused == kw.get("fused", False)
    assert on.plan.shared_problem == (plane != "per_problem")
    assert on.plan.has_filter == (plane == "filter")
    _assert_counters_equal(on.telemetry, jax_on.telemetry, f"{plane}/jax")
    _assert_counters_equal(on.telemetry, np_on.telemetry, f"{plane}/numpy")
    assert on.telemetry.labels == np_on.telemetry.labels
    np.testing.assert_array_equal(on.telemetry.q_mean, np_on.telemetry.q_mean)
    np.testing.assert_array_equal(on.telemetry.q_final,
                                  np_on.telemetry.q_final)
    # the batch exercises votes, identify rounds and their eliminations
    tot = on.telemetry.totals()
    assert tot["eliminations"] > 0 and tot["identify_rounds"] > 0
    assert tot["vote_rounds"] > tot["identify_rounds"]
    assert tot["tamper_events"] > 0 and tot["detects"] > 0


@pytest.mark.parametrize("plane", list(PLANES))
def test_telemetry_is_output_neutral(plane):
    on, off, _, _ = _runs(plane)
    assert off.telemetry is None
    for ro, rn in zip(off, on):
        np.testing.assert_array_equal(ro.w, rn.w)
        assert ro.losses == rn.losses
        assert ro.identify_step == rn.identify_step
        assert ro.efficiency == rn.efficiency
        assert ro.q_trace == rn.q_trace
        np.testing.assert_array_equal(ro.state.active, rn.state.active)
    np.testing.assert_array_equal(off.detect_flags, on.detect_flags)


@pytest.mark.parametrize("plane", ["gram", "filter"])
def test_counters_match_recorded_schedule(plane):
    """Every counter equals its sum over the run's own schedule arrays
    (``res.schedule.arrays``), as the reference's
    test_counters_match_recorded_schedule checks on its numpy pass."""
    on = _runs(plane)[0]
    tel, arr = on.telemetry, on.schedule.arrays
    live, checks = arr["live"], arr["checks"]
    vote1, identify = arr["vote1"], arr["identify"]
    assert np.array_equal(tel.counters["steps"], live.sum(0))
    assert np.array_equal(tel.counters["checks"], checks.sum(0))
    assert np.array_equal(tel.counters["redundant_steps"],
                          (checks | vote1).sum(0))
    assert np.array_equal(tel.counters["detects"], identify.sum(0))
    assert np.array_equal(tel.counters["identify_rounds"], identify.sum(0))
    assert np.array_equal(tel.counters["vote_rounds"],
                          (identify | vote1).sum(0))
    assert np.array_equal(tel.counters["tamper_events"],
                          arr["tam1"].sum(axis=(0, 2))
                          + arr["tam2"].sum(axis=(0, 2)))
    byz = np.zeros(arr["active"].shape[1:], bool)
    for b, s in enumerate(on.specs):
        byz[b, list(s.byz)] = True
    assert np.array_equal(
        tel.counters["byz_active_steps"],
        np.where(live, (byz[None] & arr["active"]).sum(2), 0).sum(0))
    # the draco trial pays redundancy every live step by construction
    draco = [b for b, s in enumerate(on.specs) if s.mode == "draco"]
    for b in draco:
        assert tel.counters["redundant_steps"][b] == tel.counters["steps"][b]


def test_telemetry_off_is_none():
    specs = _specs(repro_torch, BASE[:1])
    assert repro_torch.run_batch(specs, device="cpu").telemetry is None


# ---------------------------------------------------------------------------
# degenerate batches
# ---------------------------------------------------------------------------


def test_zero_step_trials_have_zero_counters():
    cfg = [dict(byz=(2, 5), attack="drift", q=0.4)]
    ref = jengine.run_batch(_specs(jengine, cfg, steps=0), backend="jax",
                            mesh=None, telemetry=True)
    out = repro_torch.run_batch(_specs(repro_torch, cfg, steps=0),
                                device="cpu", telemetry=True)
    tel = out.telemetry
    assert all(int(tel.counters[k][0]) == 0 for k in TEL_KEYS)
    assert np.isnan(tel.q_mean[0]) and np.isnan(tel.q_final[0])
    _assert_counters_equal(tel, ref.telemetry, "zero_steps")
    assert out.detect_flags.shape == (0, 1)


def test_empty_batch_telemetry():
    out = repro_torch.run_batch([], device="cpu", telemetry=True)
    assert out.telemetry is not None
    assert len(out.telemetry) == 0
    assert out.telemetry.totals()["steps"] == 0
    assert repro_torch.run_batch([], device="cpu").telemetry is None


@pytest.mark.parametrize("plane", ["gram", "fused", "stream"])
def test_mixed_zero_step_trial_inside_batch(plane):
    """A steps=0 trial embedded in a live batch: its row is all-zero and
    its neighbours' counters are unaffected."""
    kw, cfgs = PLANES[plane]
    full = _runs(plane)[0]
    mixed = _specs(repro_torch, cfgs)
    zi = 2
    mixed.insert(zi, dataclasses.replace(mixed[0], steps=0, seed=99))
    out = repro_torch.run_batch(mixed, device="cpu", telemetry=True, **kw)
    for k in TEL_KEYS:
        assert int(out.telemetry.counters[k][zi]) == 0, k
        np.testing.assert_array_equal(
            np.delete(out.telemetry.counters[k], zi),
            full.telemetry.counters[k], err_msg=k)
    assert np.isnan(out.telemetry.q_mean[zi])


# ---------------------------------------------------------------------------
# chunking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["gram", "fused", "stream", "per_problem"])
def test_chunked_equals_one_chunk(plane):
    """7 trials in chunks of 3 (the last one padded) against one chunk:
    counters and detect flags equal, W and losses within the reference's
    chunking tolerance."""
    kw, cfgs = PLANES[plane]
    cfgs = (cfgs + cfgs)[:7]
    specs = [dataclasses.replace(s, seed=100 + b)
             for b, s in enumerate(_specs(repro_torch, cfgs))]
    one = repro_torch.run_batch(specs, device="cpu", telemetry=True, **kw)
    three = repro_torch.run_batch(specs, device="cpu", telemetry=True,
                                  chunk_trials=3, **kw)
    assert one.plan.chunk_trials >= 7 and three.plan.chunk_trials == 3
    _assert_counters_equal(three.telemetry, one.telemetry, plane)
    np.testing.assert_array_equal(three.detect_flags, one.detect_flags)
    for a, b in zip(three, one):
        np.testing.assert_allclose(a.w, b.w, rtol=CHUNK_RTOL,
                                   atol=CHUNK_ATOL)
        np.testing.assert_allclose(a.losses, b.losses, rtol=CHUNK_RTOL,
                                   atol=CHUNK_ATOL)
        assert a.q_trace == b.q_trace


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def _metric_values(reg, names):
    snap = reg.snapshot()
    return {n: snap.get(n, {"value": 0})["value"] for n in names}


def test_facade_emits_the_reference_spans_and_counters():
    """The same 7-trial gram batch in chunks of 3 through both engines:
    the same engine and pipeline spans (pipeline spans with the same
    ``lo``/``hi``) and the same counter increments."""
    cfgs = (BASE + BASE)[:7]
    kw = dict(data_plane="gram", chunk_trials=3, telemetry=True)
    names = ["engine.batches", "engine.trials", "engine.plan.gram.host",
             "engine.telemetry.steps"]
    port_before = _metric_values(tmetrics.REGISTRY, names)
    ref_before = _metric_values(jmetrics.REGISTRY, names)
    ttrace.clear()
    jtrace.clear()
    out = repro_torch.run_batch(_specs(repro_torch, cfgs), device="cpu",
                                **kw)
    _quiet(lambda: jengine.run_batch(_specs(jengine, cfgs), backend="jax",
                                     mesh=None, **kw))

    def spans(tracer):
        evs = [e for e in tracer.spans()
               if e["name"].startswith(("engine.", "pipeline."))]
        return sorted((e["name"], tuple(sorted(e.get("args", {}).items())))
                      for e in evs)

    got, want = spans(ttrace), spans(jtrace)
    assert got == want
    stages = [a for n, a in got if n == "pipeline.drain"]
    assert stages == [(("hi", 3), ("lo", 0)), (("hi", 6), ("lo", 3)),
                      (("hi", 7), ("lo", 6))]

    def delta(reg, before):
        now = _metric_values(reg, names)
        return {n: now[n] - before[n] for n in names}

    assert delta(tmetrics.REGISTRY, port_before) == delta(
        jmetrics.REGISTRY, ref_before)
    assert delta(tmetrics.REGISTRY, port_before)["engine.telemetry.steps"] \
        == out.telemetry.totals()["steps"] > 0
