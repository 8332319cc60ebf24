"""The port's stream data planes against the JAX package's, on the CPU.

``repro_torch.run_batch(..., device="cpu")`` runs the fused plane, the
unfused stream scan, per-trial problems and the gradient-filter
baselines with the kernels' plain PyTorch versions; the reference runs
``run_batch(..., backend="jax", mesh=None)`` with the same knobs.  The
plan must be the same; control quantities must match EXACTLY; W at
rtol/atol 1e-4 and losses at rtol 1e-3 / atol 1e-4 (the tolerances of
tests/test_engine_parity.py), bf16 storage at 3e-2.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core.engine_jax import build_schedule as jbuild_schedule
from repro.core.engineplan.plan import AFFINE_ATTACKS, FILTER_CODES
from repro.core.engineplan.stepcore import jitted_step_core
from repro.core.simulation import make_problem as jmake_problem
from repro.kernels import ops as jops
import repro_torch
from repro_torch.core import carry
from repro_torch.core.engineplan import stepcore as tstepcore
from torch_threads import one_thread  # noqa: F401 (one thread)

W_RTOL = W_ATOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4
BF16_TOL = 3e-2

# a contractive problem off the sketch width (d = 300 is not a multiple
# of k = 256) and above the gram gate, so the stream plane is pinned by
# fused=True/False
_P = dict(n_data=32, d=300, lr=0.005)
PROTOCOL = [
    dict(_P, byz=(2, 5), attack="drift", q=0.4, seed=1, steps=40),
    dict(_P, byz=(3,), attack="drift", mode="draco", q=None, seed=0,
         steps=40),
    dict(_P, byz=(4,), attack="noise", q=0.3, seed=2, steps=30),
    dict(_P, byz=(), attack="none", q=0.4, seed=3, steps=25),
    dict(_P, byz=(1,), attack="drift", mode="deterministic", q=None, seed=5,
         steps=40, onset=10),
]
FILTERS = [dict(_P, byz=(2,), attack=a, q=0.4, seed=7, steps=30, mode=m)
           for m in ("filter:mean", "filter:median", "filter:krum")
           for a in ("drift", "noise")]

BATCHES = {
    "fused": (dict(fused=True), PROTOCOL),
    "unfused": (dict(fused=False), PROTOCOL),
    "stream_plane": (dict(data_plane="stream"), PROTOCOL),
    # the default problem (n_data = 256, d = 8) sits below the gram
    # gate, so the plan picks the stream plane (fused) by itself
    "auto_below_gate": (dict(), [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=1, steps=60),
        dict(byz=(3,), attack="drift", mode="draco", q=None, seed=0,
             steps=60),
        dict(byz=(2,), attack="noise", mode="draco", q=None, seed=6,
             steps=30)]),
    "per_problem": (dict(), [dict(c, problem_seed=i % 3)
                             for i, c in enumerate(PROTOCOL)]),
    "filters": (dict(), PROTOCOL[:2] + FILTERS),
    "filters_per_problem": (dict(), [dict(c, problem_seed=i % 2) for i, c
                                     in enumerate(PROTOCOL[2:4] + FILTERS)]),
    "bf16": (dict(fused=True, stream_dtype="bf16"), PROTOCOL),
}
_cache: dict = {}


def _run(name):
    if name not in _cache:
        kw, cfgs = BATCHES[name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = jengine.run_batch([jengine.TrialSpec(**c) for c in cfgs],
                                    backend="jax", mesh=None, **kw)
            port = repro_torch.run_batch([repro_torch.TrialSpec(**c)
                                          for c in cfgs], device="cpu", **kw)
        _cache[name] = (ref, port)
    return _cache[name]


@pytest.mark.parametrize("name", list(BATCHES))
def test_plan_and_control_exact(name):
    ref, port = _run(name)
    for field in ("data_plane", "fused", "shared_problem", "has_filter",
                  "has_bias", "chunk_trials", "stream_dtype",
                  "fallback_reason", "data_plane_reason"):
        assert getattr(port.plan, field) == getattr(ref.plan, field), field
    assert port.plan.data_plane == "stream"
    assert port.fused_used is ref.fused_used
    np.testing.assert_array_equal(port.detect_flags, ref.detect_flags)
    assert ref.schedule.arrays.keys() == port.schedule.arrays.keys()
    for k, v in ref.schedule.arrays.items():
        np.testing.assert_array_equal(port.schedule.arrays[k], v, err_msg=k)
    for a, b in zip(ref, port):
        assert a.identify_step == b.identify_step
        assert a.efficiency == b.efficiency
        assert a.q_trace == b.q_trace
        np.testing.assert_array_equal(a.state.identified, b.state.identified)
        np.testing.assert_array_equal(a.state.active, b.state.active)


@pytest.mark.parametrize("name,idx", [
    (name, i) for name, (_, cfgs) in BATCHES.items()
    for i in range(len(cfgs))])
def test_values_within_contract(name, idx):
    ref, port = _run(name)
    a, b = ref[idx], port[idx]
    rtol = atol = BF16_TOL if name == "bf16" else W_RTOL
    lrtol, latol = ((BF16_TOL, BF16_TOL) if name == "bf16"
                    else (LOSS_RTOL, LOSS_ATOL))
    assert b.w.shape == a.w.shape
    np.testing.assert_allclose(b.w, a.w, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(b.losses), np.asarray(a.losses),
                               rtol=lrtol, atol=latol)
    np.testing.assert_array_equal(b.w_true, a.w_true)


def test_port_fused_vs_unfused():
    """The port's fused plane against its own unfused scan (the parity
    oracle): control exact, values at the f32-vs-f32 tolerance of
    tests/test_engine_parity.py:263."""
    _, fu = _run("fused")
    _, un = _run("unfused")
    assert fu.fused_used and not un.fused_used
    np.testing.assert_array_equal(fu.detect_flags, un.detect_flags)
    for a, b in zip(fu, un):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace
        np.testing.assert_allclose(a.w, b.w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.losses, b.losses, rtol=1e-5, atol=1e-5)


def test_bf16_stays_near_f32():
    _, f32 = _run("fused")
    _, bf = _run("bf16")
    assert bf.plan.stream_dtype == "bf16"
    np.testing.assert_array_equal(bf.detect_flags, f32.detect_flags)
    for a, b in zip(bf, f32):
        assert a.identify_step == b.identify_step
        np.testing.assert_allclose(a.w, b.w, rtol=BF16_TOL, atol=BF16_TOL)


def test_chunked_per_problem_equals_unchunked():
    """Per-chunk upload of the per-trial problems, padding included."""
    specs = [repro_torch.TrialSpec(**c) for c in BATCHES["per_problem"][1]]
    whole = repro_torch.run_batch(specs, device="cpu")
    parts = repro_torch.run_batch(specs, device="cpu", chunk_trials=2)
    assert parts.plan.chunk_trials == 2 and not parts.plan.shared_problem
    np.testing.assert_array_equal(parts.detect_flags, whole.detect_flags)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(b.w, a.w, rtol=1e-5, atol=1e-6)


# -- the step core on the reference's own operands ------------------------

def _operands(specs, *, shared):
    n_data, d = specs[0].n_data, specs[0].d
    sched = jbuild_schedule(specs, "vector")
    T, B = len(sched.arrays["live"]), len(specs)
    pkeys = sorted({s.problem_seed for s in specs})
    pid = np.array([pkeys.index(s.problem_seed) for s in specs], np.int32)
    probs = [jmake_problem(n_data=n_data, d=d, seed=p) for p in pkeys]
    noisevec = np.random.default_rng(0).normal(size=d).astype(np.float32)
    rows = carry.extended_rows([p[0] for p in probs], noisevec)
    keys = np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)
    abn = np.array([AFFINE_ATTACKS[s.attack] for s in specs], np.float32)
    stat = dict(lr=np.array([s.lr for s in specs], np.float32),
                alpha=abn[:, 0].copy(), beta=abn[:, 1].copy(),
                nu=abn[:, 2].copy(),
                fcode=np.array([FILTER_CODES.get(s.mode.partition(":")[2], -1)
                                for s in specs], np.int32),
                farr=np.array([max(1, s.f) for s in specs], np.int32))
    if shared:
        A = rows[:n_data]
        y = np.asarray(probs[0][1], np.float32)
    else:
        A = np.stack([probs[p][0] for p in pid]).astype(np.float32)
        y = np.stack([probs[p][1] for p in pid]).astype(np.float32)
    xs = carry.xs_from_schedule(sched.arrays)
    return dict(T=T, B=B, d=d, n_data=n_data, P=len(pkeys), pid=pid,
                rows=rows, A=A, y=y, keys=keys, stat=stat, xs=xs,
                noisevec=noisevec)


STEP_CORE_CASES = {
    "fused": dict(shared=True, fused=True, cfgs=PROTOCOL),
    "per_problem_filters": dict(
        shared=False, fused=False,
        cfgs=[dict(c, problem_seed=i % 2)
              for i, c in enumerate(PROTOCOL[:3] + FILTERS[::2])]),
}


@pytest.mark.parametrize("case", list(STEP_CORE_CASES))
def test_step_core_on_reference_operands(case):
    """The port's step core fed the reference's own operands through
    core/carry.py, against ``jitted_step_core(control="host")``: the
    fused plane (carry (W, cw), pending-update epilogue) and the
    per-problem unfused plane with filter trials (per-trial data,
    sketch tables gathered by pid, filter stack)."""
    c = STEP_CORE_CASES[case]
    specs = [jengine.TrialSpec(**x) for x in c["cfgs"]]
    o = _operands(specs, shared=c["shared"])
    B, d, T, n_data, Ie = o["B"], o["d"], o["T"], o["n_data"], \
        o["rows"].shape[0]
    has_filter = bool((o["stat"]["fcode"] >= 0).any())
    jstat = {k: jnp.asarray(v) for k, v in o["stat"].items()}
    jxs = {k: jnp.asarray(v) for k, v in o["xs"].items()}
    dev = torch.device("cpu")
    if c["fused"]:
        Wj, Lj, Dj = jitted_step_core(
            jnp.asarray(o["rows"]), jnp.asarray(o["y"]), jnp.zeros((B, d)),
            jnp.zeros((B, Ie)), jstat, jxs, {"keys": jnp.asarray(o["keys"])},
            None, None, fused=True, control="host", shared=True,
            has_filter=False, has_bias=True, impl="xla")
        Wt, Lt, Dt = tstepcore.step_core(
            carry.to_device(o["rows"], dev), carry.to_device(o["y"], dev),
            torch.zeros((B, d)), torch.zeros((B, Ie)),
            carry.to_device(o["stat"], dev), carry.to_device(o["xs"], dev),
            {"keys": o["keys"]}, gates=carry.gates_from_xs(o["xs"]),
            impl="torch", fused=True)
    else:
        sk = np.stack([np.asarray(jops.batched_sketch(o["rows"], k,
                                                      impl="xla"))
                       for k in o["keys"]])
        P = o["P"]
        com = {"SA": sk[:, :P * n_data].reshape(T, P, n_data, -1),
               "sk_one": sk[:, -2], "sk_noise": sk[:, -1]}
        Wj, Lj, Dj = jitted_step_core(
            jnp.asarray(o["A"]), jnp.asarray(o["y"]), jnp.zeros((B, d)),
            None, jstat, jxs, {k: jnp.asarray(v) for k, v in com.items()},
            jnp.asarray(o["noisevec"]), jnp.asarray(o["pid"]), fused=False,
            control="host", shared=False, has_filter=has_filter,
            has_bias=True, impl="xla")
        Wt, Lt, Dt = tstepcore.step_core(
            *carry.problem_operands(o["A"], o["y"], dev),
            torch.zeros((B, d)), None, carry.to_device(o["stat"], dev),
            carry.to_device(o["xs"], dev),
            carry.sketch_tables(sk, n_data, dev, n_problems=P),
            carry.to_device(o["noisevec"], dev),
            torch.from_numpy(o["pid"].astype(np.int64)),
            gates=carry.gates_from_xs(o["xs"]), impl="torch", shared=False,
            has_filter=has_filter)
    assert Dt.numpy().any()
    np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dj))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=W_RTOL,
                               atol=W_ATOL)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_extended_rows_layout():
    """The stacked per-problem rows as the reference's engine builds
    them (engine_jax.py:437-442)."""
    rng = np.random.default_rng(0)
    probs = [rng.normal(size=(3, 7)) for _ in range(2)]
    noise = rng.normal(size=7).astype(np.float32)
    rows = carry.extended_rows(probs, noise)
    want = np.concatenate(probs + [np.ones((1, 7)), noise[None]])
    assert rows.dtype == np.float32 and rows.shape == (8, 7)
    np.testing.assert_array_equal(rows, want.astype(np.float32))


def test_filter_aggregators_match_reference():
    """masked_mean / masked_median / masked_krum on a random stack with
    inactive workers, against the reference's."""
    from repro.core.engineplan import stepcore as jstepcore

    rng = np.random.default_rng(4)
    g = rng.normal(size=(5, 8, 40)).astype(np.float32)
    act = rng.random((5, 8)) < 0.7
    act[0] = False                       # no active worker at all
    act[1, :2] = True
    f = np.array([1, 2, 1, 3, 2], np.int32)
    gt, at = torch.from_numpy(g), torch.from_numpy(act)
    for got, want in (
            (tstepcore.masked_mean(gt, at), jstepcore.masked_mean(g, act)),
            (tstepcore.masked_median(gt, at),
             jstepcore.masked_median(g, act)),
            (tstepcore.masked_krum(gt, at, torch.from_numpy(f)),
             jstepcore.masked_krum(g, act, f))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
