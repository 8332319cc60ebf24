"""The port's ``Trainer`` with its workers as ranks
(``launch.train.spawn``: W gloo ranks on the CPU, one thread each, n/W
workers a rank) against the JAX package's ``Trainer`` with 8 host
devices, one worker a device, on the CPU.

The reference runs the scenarios of ``tests/test_torch_trainer.py``
(``SCENARIOS``, its model, tolerances and helpers), one subprocess a
scenario, all started when this file's first test starts, so that the
tests which need no reference run while they compile.  Held, for
``randomized`` and ``full`` at W = 4 (two workers a rank; check and
identify steps), ``filter`` and ``restart`` (rank 0 writes the
checkpoints, every rank restores) at W = 2: every control quantity
exactly, losses within 1e-4 relative, final parameters within
1e-4 * (1 + max|p|) per leaf, every rank's parameters bitwise rank 0's
(``Ranks.agree``, and the leaves themselves).  Also: one gloo rank is
bitwise the one-process ``Trainer``; a rank count that does not divide
n raises; a rank that raises ends the spawn with an error at once; the
torch example at W = 2.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_trainer import (BATCH, F, N, OPTS, SCENARIOS, SEQ,
                                assert_same_control)

ROOT = Path(__file__).resolve().parents[1]
# scenario -> ranks W
RANKED = {"filter": 2, "restart": 2, "full": 4, "randomized": 4}


@pytest.fixture(scope="module", autouse=True)
def refs(tmp_path_factory):
    """The reference's scenarios, one subprocess each, started now;
    ``refs(name)`` waits for one and returns (summary, arrays)."""
    out = tmp_path_factory.mktemp("ref")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "test_torch_trainer.py"),
         str(out), name], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for name in RANKED}

    def get(name):
        stdout, stderr = procs[name].communicate(timeout=900)
        assert procs[name].returncode == 0 and "REFERENCE_DONE" in stdout, \
            stderr[-4000:]
        with open(out / f"{name}.json") as fh:
            summ = json.load(fh)
        return summ, dict(np.load(out / f"{name}.npz"))

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()
    from repro_torch.launch.train import stop_rank_server

    stop_rank_server()


def _cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               dtype="float32")


def job_of(name: str, tmp_path, params=None, **kw):
    """A ``launch.train.Job`` of scenario ``name`` on gloo CPU ranks,
    built as ``test_torch_trainer.drive`` builds its trainers."""
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
        _cfg(), OptConfig(**OPTS[spec["opt"]]),
        BFTConfig(n=N, f=F, mode=spec["mode"], q=spec.get("q"),
                  p_assumed=0.6, seed=spec["seed"]),
        tc, AttackConfig(spec["attack"], 0.6, 5.0),
        StepConfig(detection=spec.get("detection", "sketch")), mask,
        actions=tuple(tuple(a) for a in spec["actions"]), device="cpu",
        backend="gloo", params=params, out=str(tmp_path), keep_params=True,
        threads=1, timeout_s=120, **kw)


def init_from(arrays, tmp_path) -> str:
    """The reference's initial parameters as the port's tree, saved."""
    from repro_torch.core import tree
    from repro_torch.models import model as M

    template = M.abstract_params(_cfg())
    init = tree.unflatten(template, [
        torch.from_numpy(np.array(arrays[f"init/{p}"]))
        for p, _ in tree.leaves_with_paths(template)])
    path = tmp_path / "init.pt"
    torch.save(init, path)
    return str(path)


def ranks_bitwise(results, which="main") -> None:
    """Every rank agrees (checksums) and holds rank 0's leaves bitwise,
    and every rank's control and losses are rank 0's."""
    r0 = results[0]
    for r in results:
        assert r["agree"] and r["backend"] == "gloo" and not r["staged"]
        assert r[which] == r0[which]
        assert all(torch.equal(a, b) for a, b in
                   zip(r["params"][which], r0["params"][which]))


def params_close(leaves, arrays, prefix: str) -> None:
    from repro_torch.core import tree
    from repro_torch.models import model as M

    paths = [p for p, _ in tree.leaves_with_paths(M.abstract_params(_cfg()))]
    for path, leaf in zip(paths, leaves):
        want = arrays[f"{prefix}/{path}"]
        err = float(np.abs(leaf.numpy() - want).max())
        mag = float(np.abs(want).max())
        assert err <= 1e-4 * (1.0 + mag), (path, err, mag)


def run_ranked(name, refs, tmp_path) -> tuple:
    from repro_torch.launch.train import spawn

    summ, arrays = refs(name)
    results = spawn(job_of(name, tmp_path, init_from(arrays, tmp_path)),
                    RANKED[name])
    ranks_bitwise(results)
    r0 = results[0]
    assert_same_control(r0["main"], summ["main"])
    assert r0["resumed"] == summ["resumed"]
    params_close(r0["params"]["main"], arrays, "final")
    return results, summ, arrays


# ---------------------------------------------------------------------------
# no reference needed: these run while the reference compiles
# ---------------------------------------------------------------------------

def test_rank_count_must_divide_the_workers():
    """Three ranks for n = 8 workers raise, in the trainer (over a
    ``fake`` process group of world 3) and in the launcher; a model axis
    above 1 raises, naming ROADMAP item 7b."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.randomized import BFTConfig
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        with pytest.raises(ValueError, match="item 7b"):
            make_worker_mesh(3, model=2)
        mesh = make_worker_mesh(3)
        with pytest.raises(ValueError, match="3 ranks do not divide n = 8"):
            Trainer(_cfg(), OptConfig(), BFTConfig(n=8, f=2),
                    TrainerConfig(), device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
    with pytest.raises(SystemExit, match="does not divide"):
        launch.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--nproc", "3"])


def _raise_on_rank_1(rank: int, world: int, init_method: str) -> None:
    """Rank 1 raises; rank 0 waits in an all-reduce rank 1 never joins."""
    from repro_torch.train import ranks as R

    R.init("gloo", rank, world, init_method=init_method, timeout_s=120)
    if rank == 1:
        raise RuntimeError("planted failure on rank 1")
    R.Ranks(None, "cpu").all_reduce_sum(torch.zeros(4))


def test_a_rank_that_raises_ends_the_spawn():
    import torch.multiprocessing as mp

    from repro_torch.launch.train import free_port, start_ranks

    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException,
                       match="planted failure on rank 1"):
        start_ranks(_raise_on_rank_1,
                    (2, f"tcp://localhost:{free_port()}"), 2)
    # ended by the failure, long before the process group's 120 s
    assert time.perf_counter() - t0 < 60


def test_one_gloo_rank_is_bitwise_the_one_process_trainer(tmp_path):
    """W = 1 goes through every collective (an all-reduce or gather of
    one rank) and must change no bit: control, losses, parameters and
    optimizer state equal the one-process ``Trainer``'s."""
    from repro_torch.core import tree
    from repro_torch.launch.train import spawn, summary
    from repro_torch.train import Trainer
    from repro_torch.train.ranks import checksums

    job = job_of("randomized", tmp_path)
    (r0,) = spawn(job, 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(job.threads)      # the rank's
    try:
        tr = Trainer(job.cfg, job.opt, job.bft, job.tc, attack=job.attack,
                     sc=job.sc, true_byzantine=job.true_byzantine,
                     device="cpu")
        tr.run(SCENARIOS["randomized"]["actions"][0][1])
    finally:
        torch.set_num_threads(threads)
    assert r0["main"] == summary(tr)
    assert any("identified" in r for r in r0["main"]["history"])
    assert all(torch.equal(a, b) for a, b in
               zip(r0["params"]["main"], tree.leaves(tr.params)))
    assert torch.equal(r0["checksums"][-1],
                       checksums(tr.params, tr.opt_state))
    assert r0["counts"]["all_reduce"] > 0 and r0["counts"]["all_gather"] > 0


def test_torch_example_two_ranks(capsys):
    """``examples/byzantine_train_torch.py --reduced --steps 2 --nproc 2
    --device cpu``."""
    spec = importlib.util.spec_from_file_location(
        "byzantine_train_torch", ROOT / "examples" / "byzantine_train_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    example.main(["--reduced", "--steps", "2", "--nproc", "2", "--device",
                  "cpu", "--seq-len", "16"])
    seconds = time.perf_counter() - t0
    out = capsys.readouterr().out
    assert "8 workers as 2 gloo ranks of 4 on cpu" in out
    assert "ranks agree bitwise   : True" in out
    print(f"example at W = 2: {seconds:.1f} s")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_filter_median_two_ranks(refs, tmp_path):
    _, summ, _ = run_ranked("filter", refs, tmp_path)
    assert all(r["efficiency"] == 1.0 for r in summ["main"]["history"])


def test_restart_two_ranks(refs, tmp_path):
    """Rank 0 writes the checkpoints (every 3 steps), every rank waits
    at a barrier; a second trainer on every rank restores step 6."""
    results, summ, arrays = run_ranked("restart", refs, tmp_path)
    ranks_bitwise(results, "restarted")
    r0 = results[0]
    assert r0["resumed"] == summ["resumed"] == 6
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000003", "step_00000006"]
    assert_same_control(r0["restarted"], summ["restarted"])
    params_close(r0["params"]["restarted"], arrays, "restarted")
    # the resumed run replays the first run's last steps bitwise
    assert all(torch.equal(a, b) for a, b in
               zip(r0["params"]["main"], r0["params"]["restarted"]))


def test_full_detection_four_ranks(refs, tmp_path):
    """Each leaf's (n, d) gradients gathered, detection on every rank."""
    _, summ, _ = run_ranked("full", refs, tmp_path)
    assert any("identified" in r for r in summ["main"]["history"])


def test_randomized_four_ranks(refs, tmp_path):
    """Check (sketches gathered) and identify (each leaf gathered, the
    vote on every rank) steps, two workers a rank."""
    results, summ, _ = run_ranked("randomized", refs, tmp_path)
    ident = sorted(w for r in summ["main"]["history"]
                   for w in r.get("identified", []))
    assert ident and set(ident) <= {2, 5}
    assert all(r["counts"]["all_gather"] > 0 for r in results)
