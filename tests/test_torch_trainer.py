"""The port's ``Trainer`` against the JAX package's, on the CPU.

The reference trains in a subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), as
``tests/scenarios/bft_scenario.py`` does: this file is that script too
(``python tests/test_torch_trainer.py OUT_DIR NAME...``).  It saves each
scenario's initial parameters, history, protocol state and final
parameters; the port starts from the same parameters
(``convert.from_jax_train_params``) on ``device="cpu"`` and runs the
same scenario.  Model: llama3.2-1b ``reduced()`` in f32 (mamba2-780m's
for the ``ssm_*`` scenarios, phi3.5-moe's for ``moe_*``), n = 8
workers, f = 2, sequence 16, global batch 16.

Held: every control quantity exactly (check / identify decisions, the
identified sets, efficiency, q, f_t, kappa, the active and identified
masks, the meter); losses within 1e-4 relative; final parameters
within 1e-4 * (1 + max|p|) per leaf, with sgd, momentum and adamw alike
(the adamw restart scenario measures about 8e-6).

The scenarios are split over five test files (this one,
``test_torch_trainer_modes.py``, ``test_torch_trainer_restart.py``,
``test_torch_trainer_ssm.py``, ``test_torch_trainer_moe.py``), one
reference subprocess each, so that no file runs much over a minute.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401 (one thread)

N, F = 8, 2
SEQ, BATCH = 16, 16
OPTS = {
    "momentum": dict(kind="momentum", peak_lr=0.05, warmup_steps=2,
                     total_steps=40, grad_clip=1.0),
    "sgd": dict(kind="sgd", peak_lr=0.1, warmup_steps=2, total_steps=40),
    "adamw": dict(kind="adamw", peak_lr=1e-3, warmup_steps=2,
                  total_steps=40),
}

# name -> the scenario both trainers run; actions: ("run", steps),
# ("crash", workers), ("recover", workers), ("restart", total steps)
SCENARIOS = {
    # randomized with a fixed q under sign_flip on [2, 5]
    "randomized": dict(mode="randomized", q=0.5, attack="sign_flip",
                       byz=[2, 5], seed=17, opt="momentum",
                       actions=[("run", 5)]),
    # deterministic: every iteration checked, noise on [1]
    "deterministic": dict(mode="deterministic", attack="noise", byz=[1],
                          seed=3, opt="sgd", actions=[("run", 4)]),
    # draco: permanent 2f+1 voting
    "draco": dict(mode="draco", attack="sign_flip", byz=[3], seed=5,
                  opt="momentum", actions=[("run", 4)]),
    "filter": dict(mode="filter", filter_name="median", attack="sign_flip",
                   byz=[2, 5], seed=1, opt="momentum",
                   actions=[("run", 4)]),
    # paper-faithful full-gradient detection
    "full": dict(mode="randomized", q=0.5, attack="scale", byz=[3], seed=2,
                 detection="full", opt="sgd", actions=[("run", 4)]),
    "none": dict(mode="none", attack="sign_flip", byz=[6], seed=2,
                 opt="momentum", actions=[("run", 4)]),
    # adaptive q*_t from the previous loss
    "adaptive": dict(mode="randomized", q=None, attack="sign_flip",
                     byz=[2, 5], seed=4, opt="momentum",
                     actions=[("run", 5)]),
    # checkpoint every 3 steps, a second trainer resumes from step 6
    "restart": dict(mode="randomized", q=0.3, attack="sign_flip", byz=[6],
                    seed=11, opt="adamw", checkpoint_every=3,
                    actions=[("run", 8), ("restart", 8)]),
    # crash two workers, recover one
    "elastic": dict(mode="randomized", q=0.3, attack="sign_flip", byz=[4],
                    seed=6, opt="momentum",
                    actions=[("run", 2), ("crash", [0, 7]), ("run", 3),
                             ("recover", [0]), ("run", 3)]),
    # mamba2-780m (tests/test_torch_trainer_ssm.py)
    "ssm_randomized": dict(arch="mamba2-780m", mode="randomized", q=0.5,
                           attack="sign_flip", byz=[2, 5], seed=17,
                           opt="momentum", actions=[("run", 5)]),
    "ssm_deterministic": dict(arch="mamba2-780m", mode="deterministic",
                              attack="noise", byz=[1], seed=3, opt="adamw",
                              actions=[("run", 4)]),
    # phi3.5-moe (tests/test_torch_trainer_moe.py)
    "moe_deterministic": dict(arch="phi3.5-moe-42b-a6.6b",
                              mode="deterministic", attack="sign_flip",
                              byz=[2, 5], seed=3, opt="adamw",
                              actions=[("run", 4)]),
}


def drive(spec, pkg, make, workdir):
    """Run one scenario with a package's classes (``pkg``: TrainerConfig,
    BFTConfig, OptConfig, AttackConfig) and trainer factory
    ``make(cfg, opt, bft, tc, attack, detection, mask)``.  Returns
    (trainer, the resumed trainer or None, the resumed step or None)."""
    cfg = pkg["cfg"](spec.get("arch", "llama3.2-1b"))
    tc = pkg["TrainerConfig"](
        seq_len=SEQ, global_batch=BATCH, log_every=0,
        checkpoint_dir=workdir if spec.get("checkpoint_every") else None,
        checkpoint_every=spec.get("checkpoint_every", 0),
        filter_name=spec.get("filter_name", "median"))
    mask = np.zeros(N, bool)
    mask[spec["byz"]] = True

    def new():
        bft = pkg["BFTConfig"](n=N, f=F, mode=spec["mode"],
                               q=spec.get("q"), p_assumed=0.6,
                               seed=spec["seed"])
        attack = pkg["AttackConfig"](spec["attack"], 0.6, 5.0)
        return make(cfg, pkg["OptConfig"](**OPTS[spec["opt"]]), bft, tc,
                    attack, spec.get("detection", "sketch"), mask)

    tr, tr_b, resumed = new(), None, None
    for act, arg in spec["actions"]:
        if act == "run":
            tr.run(arg)
        elif act == "crash":
            tr.inject_crash(arg)
        elif act == "recover":
            tr.recover(arg)
        else:
            tr_b = new()
            resumed = tr_b.restore_latest()
            tr_b.run(arg - resumed)
    return tr, tr_b, resumed


def summary(tr) -> dict:
    st = tr.state
    return {"history": tr.history, "identified": st.identified.tolist(),
            "active": st.active.tolist(), "meter": st.meter.state_dict(),
            "overall": st.meter.overall, "kappa": st.kappa, "f_t": st.f_t}


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference_main(out_dir, names) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import jax

    from repro.configs import get_config
    from repro.core.randomized import BFTConfig
    from repro.optim import OptConfig
    from repro.sharding import make_mesh
    from repro.train import AttackConfig, StepConfig, Trainer, TrainerConfig

    mesh = make_mesh((N, 1), ("data", "model"))
    pkg = dict(cfg=lambda arch: dataclasses.replace(
        get_config(arch).reduced(), dtype="float32"),
               TrainerConfig=TrainerConfig, BFTConfig=BFTConfig,
               OptConfig=OptConfig, AttackConfig=AttackConfig)

    def flat(params):
        paths = jax.tree_util.tree_flatten_with_path(params)[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): np.asarray(leaf)
                for path, leaf in paths}

    inits = {}

    def make(cfg, opt, bft, tc, attack, detection, mask):
        tr = Trainer(cfg, opt, bft, mesh, tc, attack=attack,
                     sc=StepConfig(worker_axes=("data",),
                                   detection=detection),
                     true_byzantine=mask)
        inits.setdefault("params", flat(tr.params))
        return tr

    for name in names:
        inits.clear()
        with tempfile.TemporaryDirectory() as d:
            tr, tr_b, resumed = drive(SCENARIOS[name], pkg, make, d)
        out = {"main": summary(tr), "resumed": resumed,
               "restarted": summary(tr_b) if tr_b else None}
        with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
            json.dump(out, fh)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **{f"init/{k}": v for k, v in inits["params"].items()},
                 **{f"final/{k}": v for k, v in flat(tr.params).items()},
                 **({f"restarted/{k}": v for k, v in flat(tr_b.params).items()}
                    if tr_b else {}))
    print("REFERENCE_DONE")


# ---------------------------------------------------------------------------
# the port, in the test process
# ---------------------------------------------------------------------------

def reference(names, tmp_path) -> dict:
    """{name: (json summary, npz arrays)} of the reference's runs."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp_path), *names],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0 and "REFERENCE_DONE" in proc.stdout, \
        proc.stderr[-4000:]
    out = {}
    for name in names:
        with open(tmp_path / f"{name}.json") as fh:
            summ = json.load(fh)
        out[name] = (summ, dict(np.load(tmp_path / f"{name}.npz")))
    return out


def port(name, arrays, workdir):
    """Run scenario ``name`` on the port from the reference's initial
    parameters; returns (trainer, restarted trainer, resumed step)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.train import (AttackConfig, StepConfig, Trainer,
                                   TrainerConfig)

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")

    spec = SCENARIOS[name]
    template = M.init_train(cfg_of(spec.get("arch", "llama3.2-1b")), 0,
                            device="cpu")
    pkg = dict(cfg=cfg_of, TrainerConfig=TrainerConfig, BFTConfig=BFTConfig,
               OptConfig=OptConfig, AttackConfig=AttackConfig)

    def make(cfg, opt, bft, tc, attack, detection, mask):
        params = tree.unflatten(template, [
            torch.from_numpy(np.array(arrays[f"init/{p}"]))
            for p, _ in tree.leaves_with_paths(template)])
        return Trainer(cfg, opt, bft, tc, attack=attack,
                       sc=StepConfig(detection=detection),
                       true_byzantine=mask, device="cpu", params=params)

    return drive(spec, pkg, make, workdir)


def assert_same_control(got: dict, want: dict) -> None:
    """Every control quantity equal; losses within 1e-4 relative."""
    for key in ("identified", "active", "meter", "overall", "kappa", "f_t"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w), (g, w)
        for key in w:
            if key == "loss":
                assert abs(g[key] - w[key]) <= 1e-4 * abs(w[key]), (g, w)
            else:
                assert g[key] == w[key], (key, g, w)


def param_errors(trainer, arrays, prefix: str) -> dict:
    """{path: (max|port - ref|, max|ref|)} over the trainer's leaves."""
    from repro_torch.core import tree

    out = {}
    for path, leaf in tree.leaves_with_paths(trainer.params):
        want = arrays[f"{prefix}/{path}"]
        out[path] = (float(np.abs(leaf.detach().numpy() - want).max()),
                     float(np.abs(want).max()))
    return out


def assert_params_close(trainer, arrays, prefix="final") -> None:
    for path, (err, mag) in param_errors(trainer, arrays, prefix).items():
        assert err <= 1e-4 * (1.0 + mag), (path, err, mag)


def check_scenario(name, ref, tmp_path) -> tuple:
    summ, arrays = ref[name]
    tr, tr_b, resumed = port(name, arrays, str(tmp_path / f"ckpt_{name}"))
    assert_same_control(summary(tr), summ["main"])
    assert resumed == summ["resumed"]
    return tr, tr_b, summ, arrays


# ---------------------------------------------------------------------------
# the port with its workers as ranks (launch.train.spawn: W gloo ranks on
# the CPU, one thread each, n/W workers a rank), held against the same
# reference runs: every control quantity exactly, losses within 1e-4
# relative, final parameters within 1e-4 * (1 + max|p|) per leaf, every
# rank's parameters bitwise rank 0's (``Ranks.agree``, and the leaves)
# ---------------------------------------------------------------------------

def ranked_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               dtype="float32")


def job_of(name: str, tmp_path, params=None, **kw):
    """A ``launch.train.Job`` of scenario ``name`` on gloo CPU ranks,
    built as ``drive`` builds its trainers."""
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.launch.train import Job
    from repro_torch.optim import OptConfig
    from repro_torch.train import AttackConfig, StepConfig, TrainerConfig

    spec = SCENARIOS[name]
    mask = np.zeros(N, bool)
    mask[spec["byz"]] = True
    tc = TrainerConfig(
        seq_len=SEQ, global_batch=BATCH, log_every=0,
        checkpoint_dir=str(tmp_path / "ckpt")
        if spec.get("checkpoint_every") else None,
        checkpoint_every=spec.get("checkpoint_every", 0),
        filter_name=spec.get("filter_name", "median"))
    return Job(
        ranked_cfg(), OptConfig(**OPTS[spec["opt"]]),
        BFTConfig(n=N, f=F, mode=spec["mode"], q=spec.get("q"),
                  p_assumed=0.6, seed=spec["seed"]),
        tc, AttackConfig(spec["attack"], 0.6, 5.0),
        StepConfig(detection=spec.get("detection", "sketch")), mask,
        actions=tuple(tuple(a) for a in spec["actions"]), device="cpu",
        backend="gloo", params=params, out=str(tmp_path), keep_params=True,
        threads=1, timeout_s=120, **kw)


def init_from(arrays, tmp_path) -> str:
    """The reference's initial parameters as the port's tree, saved."""
    import torch

    from repro_torch.core import tree
    from repro_torch.models import model as M

    template = M.abstract_params(ranked_cfg())
    init = tree.unflatten(template, [
        torch.from_numpy(np.array(arrays[f"init/{p}"]))
        for p, _ in tree.leaves_with_paths(template)])
    path = tmp_path / "init.pt"
    torch.save(init, path)
    return str(path)


def ranks_bitwise(results, which="main") -> None:
    """Every rank agrees (checksums) and holds rank 0's leaves bitwise,
    and every rank's control and losses are rank 0's."""
    import torch

    r0 = results[0]
    for r in results:
        assert r["agree"] and r["backend"] == "gloo" and not r["staged"]
        assert r[which] == r0[which]
        assert all(torch.equal(a, b) for a, b in
                   zip(r["params"][which], r0["params"][which]))


def params_close(leaves, arrays, prefix: str) -> None:
    from repro_torch.core import tree
    from repro_torch.models import model as M

    paths = [p for p, _ in tree.leaves_with_paths(
        M.abstract_params(ranked_cfg()))]
    for path, leaf in zip(paths, leaves):
        want = arrays[f"{prefix}/{path}"]
        err = float(np.abs(leaf.numpy() - want).max())
        mag = float(np.abs(want).max())
        assert err <= 1e-4 * (1.0 + mag), (path, err, mag)


def run_ranked(name, ref, tmp_path, world: int) -> tuple:
    """Scenario ``name`` as ``world`` ranks from the reference's initial
    parameters, held against the reference run ``ref[name]``."""
    from repro_torch.launch.train import spawn

    summ, arrays = ref[name]
    results = spawn(job_of(name, tmp_path, init_from(arrays, tmp_path)),
                    world)
    ranks_bitwise(results)
    r0 = results[0]
    assert_same_control(r0["main"], summ["main"])
    assert r0["resumed"] == summ["resumed"]
    params_close(r0["params"]["main"], arrays, "final")
    return results, summ, arrays


@pytest.fixture(scope="module", autouse=True)
def rank_server():
    """Stops the ranks' fork server (``launch.train.spawn``) when the
    module's tests are done."""
    yield
    import sys as _sys

    launch = _sys.modules.get("repro_torch.launch.train")
    if launch is not None:
        launch.stop_rank_server()


# ---------------------------------------------------------------------------
# tests of this file's scenarios
# ---------------------------------------------------------------------------

NAMES = ["randomized", "deterministic", "draco"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(NAMES, tmp_path_factory.mktemp("ref"))


def test_randomized_fixed_q_under_sign_flip(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("randomized", ref, tmp_path)
    assert_params_close(tr, arrays)
    h = summ["main"]["history"]
    ident = sorted(w for r in h for w in r.get("identified", []))
    # the run identifies Byzantine workers, never an honest one
    assert ident and set(ident) <= {2, 5}
    assert any("identified" in r for r in h)


def test_deterministic_under_noise(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("deterministic", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert summ["main"]["identified"][1] and summ["main"]["kappa"] == 1
    # after the elimination f_t = 1: clean checked iterations at 1/2
    assert summ["main"]["history"][-1]["efficiency"] == 0.5


def test_draco_votes_every_step(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("draco", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert summ["main"]["identified"][3]


def test_randomized_four_ranks(ref, tmp_path):
    """Check (sketches gathered) and identify (each leaf gathered, the
    vote on every rank) steps, two workers a rank."""
    results, summ, _ = run_ranked("randomized", ref, tmp_path, 4)
    ident = sorted(w for r in summ["main"]["history"]
                   for w in r.get("identified", []))
    assert ident and set(ident) <= {2, 5}
    assert all(r["counts"]["all_gather"] > 0 for r in results)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2:])
