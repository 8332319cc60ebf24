"""The port's ``Trainer`` against the JAX package's, on the CPU:
checkpoint restart (AdamW, its state checkpointed), also with the
workers as ranks, and crash / recover.
The scenarios, the reference subprocess and the tolerances are those
of ``tests/test_torch_trainer.py``, which holds them."""
import pytest

from test_torch_trainer import (assert_params_close, assert_same_control,
                                check_scenario, params_close, rank_server,
                                ranks_bitwise, reference, run_ranked,
                                summary)
from torch_threads import one_thread  # noqa: F401 (one thread)

NAMES = ["restart", "elastic"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(NAMES, tmp_path_factory.mktemp("ref"))


def test_checkpoint_restart(ref, tmp_path):
    tr, tr_b, summ, arrays = check_scenario("restart", ref, tmp_path)
    assert summ["resumed"] == 6
    assert_same_control(summary(tr_b), summ["restarted"])
    assert_params_close(tr, arrays, "final")
    assert_params_close(tr_b, arrays, "restarted")
    # the resumed run replays the first run's last steps bitwise
    from repro_torch.core import tree

    for a, b in zip(tree.leaves(tr.params), tree.leaves(tr_b.params)):
        assert bool((a == b).all())
    assert [r["loss"] for r in tr.history[6:]] == \
        [r["loss"] for r in tr_b.history]


def test_crash_and_recover(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("elastic", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert summ["main"]["active"] == [True, True, True, True, False, True,
                                      True, False]


def test_restart_two_ranks(ref, tmp_path):
    """Rank 0 writes the checkpoints (every 3 steps), every rank waits
    at a barrier; a second trainer on every rank restores step 6."""
    import os

    import torch

    results, summ, arrays = run_ranked("restart", ref, tmp_path, 2)
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
