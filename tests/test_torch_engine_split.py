"""The port's trials split (``run_batch(..., mesh=...)``,
``core.engineplan.shard``, ``sharding.trials_mesh``) against the JAX
package's sharded run, on the CPU.

The reference runs in one subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before jax
is imported, as ``tests/scenarios/sharded_engine_scenario.py`` does: this
file is that script too, ``python tests/test_torch_engine_split.py
OUT``), every case with ``mesh=trials_mesh()``; the port runs the same
cases on a ``TrialsMesh`` of eight ``cpu`` devices.  The subprocess
starts when the file's first test starts, so the tests that need no
reference run while it compiles.  Held, as the scenario holds the
reference against the numpy engine:

* control exactly (identify steps, efficiency, q-traces, identified
  sets, meters; under ``schedule="device"`` the fixed-q traces exactly
  and the adaptive q within rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_device_control.py`` holds them), the detect flags
  and the telemetry counters integer-exact;
* W within rtol / atol 1e-4, losses within rtol 1e-3 / atol 1e-4
  (``sharded_engine_scenario.py:32-33``);
* the step core's in-spec table equal to the reference's
  (``shard._build``) on the fused, gram and device-control stream
  planes; ``trial_partition_spec`` and ``mesh_num_devices`` equal.

Without a reference: the split against one device, bitwise where each
shard's pass has the one-device pass's trials (``chunk_trials`` = k x
ndev against k), else within rtol 1e-5 / atol 1e-6
(``tests/test_sharded_engine.py:162-173``); a mesh that repeats a
device; ``mesh="bogus"`` raising; ``trials_mesh()`` None without CUDA.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401 (one thread)

ROOT = Path(__file__).resolve().parents[1]
W_TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4
Q_RTOL, Q_ATOL = 1e-5, 1e-6
N_DEV = 8


def drift_specs(TrialSpec, B, steps=40, **kw):
    return [TrialSpec(byz=(2, 5), attack="drift", q=0.3, steps=steps,
                      seed=s, label=f"s{s}", **kw) for s in range(B)]


def cases(engine):
    """name -> (specs, run_batch keywords): two SCENARIOS (cut to 120
    steps), the fused and unfused planes, gram, chunks of 9 (16 on 8
    devices: a chunk of 16 and a padded one of 4), telemetry, the device
    control plane (adaptive q, chunked and padded), per-trial problems
    and a batch smaller than the mesh."""
    T = engine.TrialSpec
    out = {}
    for name in ("late_onset", "elastic_churn"):
        mx = dataclasses.replace(engine.SCENARIOS[name], steps=120)
        out[name] = (mx.expand(), {})
    out["unfused"] = (drift_specs(T, 20), dict(fused=False))
    out["gram"] = (drift_specs(T, 20), dict(data_plane="gram"))
    out["chunk9"] = (drift_specs(T, 20), dict(chunk_trials=9))
    out["gram_chunk9"] = (drift_specs(T, 20),
                          dict(data_plane="gram", chunk_trials=9))
    out["telemetry"] = (drift_specs(T, 20), dict(telemetry=True))
    out["device"] = ([T(byz=(2, 5), attack=("drift", "scale")[s % 2],
                        q=None if s % 3 else 0.4, steps=30, seed=s, n_data=64,
                        d=32) for s in range(12)],
                     dict(schedule="device", chunk_trials=9, telemetry=True))
    out["problems"] = (drift_specs(T, 10, problem_seed=0)[:5]
                       + [dataclasses.replace(s, problem_seed=1) for s in
                          drift_specs(T, 5)], {})
    out["small"] = (drift_specs(T, 5), {})
    return out


def summarize(res) -> tuple[dict, dict]:
    """(json control, npz arrays) of a BatchResult."""
    ctrl = [dict(identify_step=r.identify_step, efficiency=r.efficiency,
                 q_trace=[float(q) for q in r.q_trace],
                 identified=np.asarray(r.state.identified).tolist(),
                 meter=[r.state.meter.used, r.state.meter.computed,
                        r.state.meter.check_iterations])
            for r in res.results]
    arrays = {"W": np.stack([np.asarray(r.w, np.float64)
                             for r in res.results]),
              "losses": np.array([r.losses for r in res.results]),
              "detect": np.asarray(res.detect_flags)}
    if res.telemetry is not None:
        for k, v in res.telemetry.counters.items():
            arrays[f"tel/{k}"] = np.asarray(v)
    return {"control": ctrl, "n_devices": res.plan.n_devices,
            "chunk_trials": res.plan.chunk_trials}, arrays


def _ref_specs(mesh):
    """The reference's in-spec table for three planes, as tuples."""
    from repro.core.engineplan.shard import _build
    from repro.obs.telemetry import TEL_KEYS

    from jax.sharding import PartitionSpec

    def flat(tree):
        if tree is None:
            return None
        if isinstance(tree, PartitionSpec):
            return list(tuple(tree))
        if isinstance(tree, dict):
            return {k: flat(v) for k, v in tree.items()}
        return [flat(v) for v in tree]

    stat = (("lr", 1), ("alpha", 1), ("byz", 2))
    xs = (("live", 2), ("shard1", 3))
    out = {}
    for name, fused, gram, control, com in [
            ("fused", True, False, "host", (("keys", 1),)),
            ("gram", False, True, "host", (("SA", 3), ("sk_one", 2))),
            ("device_stream", False, False, "device",
             (("SA", 3), ("sk_one", 2)))]:
        _, specs = _build(mesh, fused, gram, control, True, False, True,
                          None, stat, None if control == "device" else xs,
                          com, 2, True)
        out[name] = flat(specs)
    out["tel_keys"] = list(TEL_KEYS)
    return out


def _reference_main(out_dir) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    from repro.core import engine
    from repro.sharding import (mesh_num_devices, trial_partition_spec,
                                trials_mesh)

    assert len(jax.devices()) == N_DEV
    mesh = trials_mesh()
    meta = {"mesh_num_devices": mesh_num_devices(mesh),
            "specs": {f"{nd},{ax}": list(tuple(trial_partition_spec(nd, ax)))
                      for nd in (1, 2, 3) for ax in (None, *range(nd))},
            "in_specs": _ref_specs(mesh)}
    arrays = {}
    for name, (specs, kw) in cases(engine).items():
        res = engine.run_batch(specs, backend="jax", mesh=mesh, **kw)
        meta[name], arr = summarize(res)
        arrays.update({f"{name}/{k}": v for k, v in arr.items()})
    with open(os.path.join(out_dir, "ref.json"), "w") as fh:
        json.dump(meta, fh)
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    print("REFERENCE_DONE")


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(ref_proc):
    """Starts the reference with the file's first test, and runs the
    port on one CPU thread: its step loops are thousands of tiny
    operators, which a thread pool only slows on a loaded machine."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(ref_proc):
    proc, out = ref_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REFERENCE_DONE" in stdout, \
        stderr[-4000:]
    with open(out / "ref.json") as fh:
        meta = json.load(fh)
    return meta, dict(np.load(out / "ref.npz"))


def _mesh(n=N_DEV, device="cpu"):
    from repro_torch.sharding import TrialsMesh

    return TrialsMesh((device,) * n)


@pytest.fixture(scope="module")
def port_runs():
    """Every case on the port's 8-device CPU mesh, run once."""
    from repro_torch.core import engine
    from repro_torch.core.engine_torch import run_batch

    return {name: run_batch(specs, mesh=_mesh(), **kw)
            for name, (specs, kw) in cases(engine).items()}


# ---------------------------------------------------------------------------
# no reference needed: these run while the reference compiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(fused=False), dict(data_plane="gram"),
    dict(schedule="device"), dict(telemetry=True)],
    ids=["fused", "unfused", "gram", "device", "telemetry"])
def test_split_is_bitwise_one_device_at_matching_passes(kw):
    """Four shards of 3 trials a pass against one device's passes of 3:
    the same step loop on the same rows, so the same bits."""
    from repro_torch.core.engine import TrialSpec
    from repro_torch.core.engine_torch import run_batch

    specs = drift_specs(TrialSpec, 24, steps=30, d=64, n_data=64)
    if kw.get("schedule") == "device":
        specs = [dataclasses.replace(s, q=None) for s in specs]
    one = run_batch(specs, device="cpu", chunk_trials=3, **kw)
    split = run_batch(specs, mesh=_mesh(4), chunk_trials=12, **kw)
    assert split.plan.n_devices == 4 and split.plan.chunk_trials == 12
    assert one.plan.n_devices == 1
    for a, b in zip(one.results, split.results):
        assert np.array_equal(a.w, b.w) and a.losses == b.losses
        assert (a.identify_step, a.q_trace, a.efficiency) == \
            (b.identify_step, b.q_trace, b.efficiency)
    assert np.array_equal(one.detect_flags, split.detect_flags)
    if kw.get("telemetry"):
        for k, v in one.telemetry.counters.items():
            assert np.array_equal(v, split.telemetry.counters[k])


def test_split_is_close_to_one_device_at_other_passes():
    """Eight shards of ragged passes (a chunk of 20 trials: shards of 3,
    the last of 2, one of padding alone) against one unchunked device
    pass of 20."""
    from repro_torch.core.engine import TrialSpec
    from repro_torch.core.engine_torch import run_batch

    specs = drift_specs(TrialSpec, 20, steps=40)
    for kw in (dict(), dict(data_plane="gram"), dict(fused=False)):
        one = run_batch(specs, device="cpu", **kw)
        split = run_batch(specs, mesh=_mesh(), **kw)
        assert split.plan.chunk_trials == 24
        for a, b in zip(one.results, split.results):
            np.testing.assert_allclose(b.w, a.w, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(b.losses, a.losses, rtol=1e-5,
                                       atol=1e-6)
            assert (a.identify_step, a.efficiency) == \
                (b.identify_step, b.efficiency)


def test_mesh_options():
    from repro_torch.core.engine import TrialSpec
    from repro_torch.core.engine_torch import resolve_mesh, run_batch
    from repro_torch.obs import metrics as obmetrics
    from repro_torch.sharding import TrialsMesh, trials_mesh

    import torch

    spec = TrialSpec(byz=(2,), attack="drift", steps=5, q=0.5)
    with pytest.raises(ValueError, match="mesh"):
        run_batch([spec], device="cpu", mesh="bogus")
    with pytest.raises(ValueError, match="mesh"):
        run_batch([spec], device="cpu", mesh=3)
    with pytest.raises(ValueError, match="one type"):
        TrialsMesh(("cpu", "meta"))
    assert trials_mesh() is None and trials_mesh(4) is None
    assert obmetrics.snapshot()["sharding.local_devices"]["value"] == 0
    cpu = torch.device("cpu")
    assert resolve_mesh("auto", cpu) is None
    assert resolve_mesh(None, cpu) is None
    m = _mesh(2)
    assert resolve_mesh(m, cpu) is m
    assert m.devices == (cpu, cpu) and m.shape == {"trials": 2}
    # "auto" and None on the CPU: one device, no split in the plan
    for mesh in ("auto", None):
        res = run_batch([spec], device="cpu", mesh=mesh)
        assert res.plan.n_devices == 1 and not res.plan.sharded


# ---------------------------------------------------------------------------
# against the reference's 8-device sharded run
# ---------------------------------------------------------------------------

def test_partition_specs_and_device_count_equal_the_reference(ref):
    from repro_torch.sharding import mesh_num_devices, trial_partition_spec

    meta, _ = ref
    assert mesh_num_devices(_mesh()) == meta["mesh_num_devices"] == N_DEV
    for key, want in meta["specs"].items():
        nd, ax = key.split(",")
        got = trial_partition_spec(int(nd), None if ax == "None"
                                   else int(ax))
        assert list(got) == want, key


def test_in_spec_table_equals_the_reference(ref):
    from repro_torch.core.engineplan import shard

    meta, _ = ref
    want = meta["in_specs"]
    stat = (("lr", 1), ("alpha", 1), ("byz", 2))
    xs = (("live", 2), ("shard1", 3))

    def as_lists(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: as_lists(v) for k, v in tree.items()}
        return list(tree)

    for name, fused, gram, control, com in [
            ("fused", True, False, "host", (("keys", 1),)),
            ("gram", False, True, "host", (("SA", 3), ("sk_one", 2))),
            ("device_stream", False, False, "device",
             (("SA", 3), ("sk_one", 2)))]:
        plan = types.SimpleNamespace(
            fused=fused, data_plane="gram" if gram else "stream",
            shared_problem=True, control=control)
        got = shard.in_specs(plan, stat_sig=stat, com_sig=com,
                             xs_sig=None if control == "device" else xs)
        assert [as_lists(s) for s in got] == want[name], name
    from repro_torch.obs.telemetry import TEL_KEYS

    assert list(TEL_KEYS) == want["tel_keys"]


CASE_NAMES = ["late_onset", "elastic_churn", "unfused", "gram", "chunk9",
              "gram_chunk9", "telemetry", "device", "problems", "small"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_split_matches_the_references_sharded_run(ref, port_runs, name):
    meta, arrays = ref
    res = port_runs[name]
    got_meta, got = summarize(res)
    got_meta = json.loads(json.dumps(got_meta))      # as the reference's
    want = meta[name]
    assert got_meta["n_devices"] == want["n_devices"] == N_DEV
    assert got_meta["chunk_trials"] == want["chunk_trials"]
    for g, w in zip(got_meta["control"], want["control"]):
        q_g, q_w = g.pop("q_trace"), w.pop("q_trace")
        assert g == w
        if res.plan.control == "device":
            np.testing.assert_allclose(q_g, q_w, rtol=Q_RTOL, atol=Q_ATOL)
        else:
            assert q_g == q_w
    np.testing.assert_array_equal(got["detect"], arrays[f"{name}/detect"])
    np.testing.assert_allclose(got["W"], arrays[f"{name}/W"], rtol=W_TOL,
                               atol=W_TOL)
    np.testing.assert_allclose(got["losses"], arrays[f"{name}/losses"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    tel = sorted(k for k in got if k.startswith("tel/"))
    assert tel == sorted(k[len(name) + 1:] for k in arrays
                         if k.startswith(f"{name}/tel/"))
    for k in tel:
        np.testing.assert_array_equal(got[k], arrays[f"{name}/{k}"])


if __name__ == "__main__":
    _reference_main(sys.argv[1])
