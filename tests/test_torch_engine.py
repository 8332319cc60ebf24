"""The port's engine against the JAX package's, on the CPU.

``repro_torch.run_batch(..., device="cpu")`` runs the gram data plane
with the kernels' plain PyTorch versions; the reference runs
``run_batch(..., backend="jax", data_plane="gram", mesh=None)``.
Control quantities must match EXACTLY; W at rtol/atol 1e-4 and losses
at rtol 1e-3 / atol 1e-4 (the tolerances of tests/test_engine_parity.py).
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core.engine_jax import build_schedule as jbuild_schedule
from repro.core.engineplan.plan import AFFINE_ATTACKS
from repro.core.engineplan.stepcore import jitted_step_core
from repro.core.simulation import make_problem as jmake_problem
from repro.kernels import ops as jops
import repro_torch
from repro_torch.core import carry
from repro_torch.core.engine_torch import gram_matrix
from repro_torch.core.engineplan import stepcore as tstepcore

W_RTOL = W_ATOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4
ROOT = Path(__file__).resolve().parents[1]

BATCHES = {
    # d = 8 sits below the auto gate, so the gram plane is requested
    "small_forced_gram": (dict(data_plane="gram"), [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=1, steps=60),
        dict(byz=(3,), attack="drift", mode="draco", q=None, seed=0,
             steps=60),
        dict(byz=(4,), attack="noise", q=0.3, seed=2, steps=50),
        dict(byz=(), attack="none", q=0.4, seed=3, steps=40),
        dict(byz=(1,), attack="drift", mode="deterministic", q=None,
             seed=5, steps=60, onset=15),
        dict(byz=(2,), attack="noise", mode="draco", q=None, seed=6,
             steps=30),
    ]),
    # above the size gate the plan picks gram with no knobs; lr is a
    # quarter of n_data/d so that gradient descent contracts (at
    # lr = n_data/d the largest Hessian eigenvalue makes it diverge and
    # elementwise tolerances then measure cancellation, not the port)
    "auto_gram_d4096": (dict(), [
        dict(byz=(2, 5), attack="drift", q=0.4, seed=1, n_data=64, d=4096,
             lr=16.0 / 4096, steps=40),
        dict(byz=(3,), attack="drift", mode="draco", q=None, seed=2,
             n_data=64, d=4096, lr=16.0 / 4096, steps=40),
        dict(byz=(2,), attack="none", q=0.5, seed=3, n_data=64, d=4096,
             lr=16.0 / 4096, steps=25),
    ]),
}
_cache: dict = {}


def _both(name):
    if name not in _cache:
        kw, cfgs = BATCHES[name]
        ref = jengine.run_batch([jengine.TrialSpec(**c) for c in cfgs],
                                backend="jax", mesh=None, **kw)
        port = repro_torch.run_batch([repro_torch.TrialSpec(**c)
                                      for c in cfgs], device="cpu", **kw)
        _cache[name] = (ref, port)
    return _cache[name]


@pytest.mark.parametrize("name", list(BATCHES))
def test_plan_and_control_exact(name):
    ref, port = _both(name)
    assert ref.plan.data_plane == port.plan.data_plane == "gram"
    assert port.plan.schedule_mode == "vector" and port.fused_used is False
    assert port.device_trace is None
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
    ref, port = _both(name)
    a, b = ref[idx], port[idx]
    assert b.w.shape == a.w.shape
    np.testing.assert_allclose(b.w, a.w, rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(np.asarray(b.losses), np.asarray(a.losses),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_array_equal(b.w_true, a.w_true)


STEP_CORE_CASES = {
    "bias": BATCHES["small_forced_gram"][1] + [
        dict(byz=(2, 5), attack="drift", q=0.6, seed=9, steps=60)],
    "no_bias": [
        dict(byz=(2, 5), attack="none", q=0.6, seed=9, steps=50),
        dict(byz=(3,), attack="none", mode="draco", q=None, seed=1,
             steps=50),
        dict(byz=(), attack="none", q=0.4, seed=3, steps=50)],
}


@pytest.mark.parametrize("case", list(STEP_CORE_CASES))
def test_step_core_on_reference_operands(case):
    """The port's step core, fed the reference's own operands through
    core/carry.py, against ``jitted_step_core(gram=True,
    control="host")``, with and without affine bias terms."""
    specs = [jengine.TrialSpec(**dict(c, n_data=32, d=256, lr=0.02))
             for c in STEP_CORE_CASES[case]]
    has_bias = case == "bias"
    sched = jbuild_schedule(specs, "vector")
    A, y, _ = jmake_problem(n_data=32, d=256, seed=0)
    noisevec = np.random.default_rng(0).normal(size=256).astype(np.float32)
    rows = np.concatenate([A, np.ones((1, 256)), noisevec[None]]).astype(
        np.float32)
    T, B, Ie = len(sched.arrays["live"]), len(specs), rows.shape[0]
    keys = np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)
    _, _, sk = jops.gram_factors(rows, None, keys, impl="xla")
    sk = np.asarray(sk)
    G64 = np.zeros((Ie, Ie))
    for lo in range(0, 256, 64):
        blk = rows[:, lo:lo + 64]
        G64 += (blk @ blk.T).astype(np.float64)
    G = G64.astype(np.float32)
    abn = np.array([AFFINE_ATTACKS[s.attack] for s in specs],
                   np.float32)
    stat = dict(lr=np.full(B, 0.02, np.float32), alpha=abn[:, 0].copy(),
                beta=abn[:, 1].copy(), nu=abn[:, 2].copy())
    xs = carry.xs_from_schedule(sched.arrays)
    y32 = np.asarray(y, np.float32)

    Wj, Lj, Dj = jitted_step_core(
        {"rows": jnp.asarray(rows), "G": jnp.asarray(G)}, jnp.asarray(y32),
        jnp.zeros((B, 256)), jnp.zeros((B, Ie)),
        {**{k: jnp.asarray(v) for k, v in stat.items()},
         "fcode": jnp.full(B, -1, jnp.int32), "farr": jnp.ones(B, jnp.int32)},
        {k: jnp.asarray(v) for k, v in xs.items()},
        {"SA": jnp.asarray(sk[:, :32]), "sk_one": jnp.asarray(sk[:, 32]),
         "sk_noise": jnp.asarray(sk[:, 33])}, None, None,
        fused=False, control="host", shared=True, has_filter=False,
        has_bias=has_bias, impl="xla", gram=True)

    dev = torch.device("cpu")
    rows_t, y_t = carry.problem_operands(rows, y32, dev)
    Wt, Lt, Dt = tstepcore.step_core(
        {"rows": rows_t, "G": carry.to_device(G, dev)}, y_t,
        torch.zeros((B, 256)), torch.zeros((B, Ie)),
        carry.to_device(stat, dev), carry.to_device(xs, dev),
        carry.sketch_tables(sk, 32, dev), gates=carry.gates_from_xs(xs),
        impl="torch")
    assert Dt.numpy().any() == has_bias   # "none" never trips detection
    np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dj))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=W_RTOL,
                               atol=W_ATOL)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_gram_matrix_f64_chunk_sum():
    """G as the reference forms it: an f32 product per 64K columns,
    summed in f64 (engine_jax.py:482-486)."""
    rng = np.random.default_rng(0)
    R = rng.normal(size=(5, 150000)).astype(np.float32)
    want = np.zeros((5, 5))
    for lo in range(0, R.shape[1], 1 << 16):
        blk = R[:, lo:lo + (1 << 16)]
        want += (blk @ blk.T).astype(np.float64)
    G = gram_matrix(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(G, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_zero_steps_and_empty_batch():
    spec = dict(byz=(2,), attack="drift", steps=0, q=0.5)
    rj = jengine.run_batch([jengine.TrialSpec(**spec)], backend="jax")[0]
    out = repro_torch.run_batch([repro_torch.TrialSpec(**spec)],
                                device="cpu", data_plane="gram")
    assert out.plan.data_plane == "stream"
    assert out.detect_flags.shape == (0, 1)
    assert out[0].losses == rj.losses == []
    assert out[0].final_error == rj.final_error
    assert len(repro_torch.run_batch([], device="cpu")) == 0


def test_chunked_equals_unchunked():
    """chunk_trials splits the batch into device passes (the last one
    padded with inert trials when needed); results do not depend on it."""
    specs = [repro_torch.TrialSpec(**c)
             for c in BATCHES["small_forced_gram"][1][:5]]
    whole = repro_torch.run_batch(specs, device="cpu", data_plane="gram")
    parts = repro_torch.run_batch(specs, device="cpu", data_plane="gram",
                                  chunk_trials=2)
    assert parts.plan.chunk_trials == 2
    np.testing.assert_array_equal(parts.detect_flags, whole.detect_flags)
    for a, b in zip(whole, parts):
        assert a.identify_step == b.identify_step
        np.testing.assert_allclose(b.w, a.w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b.losses, a.losses, rtol=1e-5, atol=1e-6)


def test_cuda_kernels_need_cuda_tensors():
    specs = [repro_torch.TrialSpec(byz=(2,), attack="drift", steps=5)]
    with pytest.raises(ValueError, match="cuda"):
        repro_torch.run_batch(specs, device="cpu", data_plane="gram",
                              kernel_impl="cuda")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    specs = [repro_torch.TrialSpec(byz=(2,), attack="drift", steps=5)]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        repro_torch.run_batch(specs)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        repro_torch.run_batch(specs, device="cuda")


_VI = dict(byz=(2,), attack="drift", q=0.4, steps=5)
OUT_OF_SLICE = {
    "schedule_oracle": ([_VI], dict(schedule="oracle", data_plane="gram")),
    "schedule_proxy": ([_VI], dict(schedule="proxy", data_plane="gram")),
    "schedule_device": ([_VI], dict(schedule="device", data_plane="gram")),
    "value_dependent": ([dict(_VI, attack="sign_flip")],
                        dict(data_plane="gram")),
    "adaptive_q": ([dict(_VI, q=None)], dict(data_plane="gram")),
    "stream_plane": ([_VI], dict(data_plane="stream")),
    "auto_below_gate": ([_VI], dict()),
    "fused": ([_VI], dict(fused=True)),
    "filters": ([dict(_VI, mode="filter:median")], dict(data_plane="gram")),
    "non_shared": ([_VI, dict(_VI, problem_seed=1)],
                   dict(data_plane="gram")),
    "telemetry": ([_VI], dict(data_plane="gram", telemetry=True)),
    "bf16": ([_VI], dict(data_plane="gram", stream_dtype="bf16")),
}


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_out_of_slice_raises_not_implemented(name):
    import warnings

    cfgs, kw = OUT_OF_SLICE[name]
    specs = [repro_torch.TrialSpec(**c) for c in cfgs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="M[4-6]|M10"):
            repro_torch.run_batch(specs, device="cpu", **kw)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_import_leaves_no_jax_or_repro_in_sys_modules():
    code = (
        "import json, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import chip_smoke, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in ('jax',"
        " 'repro') or m.startswith(('jax.', 'repro.')))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT / "tests")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
