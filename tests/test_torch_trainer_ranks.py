"""The port's ``Trainer`` with its workers as ranks
(``launch.train.spawn``: W gloo ranks on the CPU, one thread each, n/W
workers a rank), the cases that need no reference run: one gloo rank is
bitwise the one-process ``Trainer``; a rank count that does not divide
n raises; a rank that raises ends the spawn with an error at once; the
torch example at W = 2.

The ranked runs against the JAX package's ``Trainer`` (``randomized``
and ``full`` at W = 4, ``filter`` and ``restart`` at W = 2) are in the
files whose module fixture already runs that reference scenario:
``tests/test_torch_trainer.py`` (which holds the helpers,
``run_ranked``), ``_modes.py`` and ``_restart.py``.
"""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from test_torch_trainer import SCENARIOS, job_of
from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from test_torch_trainer import ranked_cfg as _cfg
from torch_threads import one_thread  # noqa: F401 (one thread)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# no reference needed: these run while the reference compiles
# ---------------------------------------------------------------------------

def test_rank_count_must_divide_the_workers():
    """Three ranks for n = 8 workers raise, in the trainer (over a
    ``fake`` process group of world 3) and in the launcher; a 3 x 2 mesh
    over a world of 3 raises (a model axis of 2 forms over a world of 8,
    ``tests/test_torch_sharding.py::test_meshes``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.randomized import BFTConfig
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        with pytest.raises(ValueError, match="a 3 x 2 mesh over a world of 3"):
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
