"""The port's ``Trainer`` against the JAX package's, on the CPU:
checkpoint restart (AdamW, its state checkpointed) and crash / recover.
The scenarios, the reference subprocess and the tolerances are those
of ``tests/test_torch_trainer.py``, which holds them."""
import pytest

from test_torch_trainer import (assert_params_close, assert_same_control,
                                check_scenario, reference, summary)

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
