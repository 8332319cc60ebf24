"""The port's ``Trainer`` against the JAX package's, on the CPU: the
filter, full-detection, none and adaptive-q scenarios, and the filter
and full-detection ones with the workers as ranks.  The scenarios,
the reference subprocess and the tolerances are those of
``tests/test_torch_trainer.py``, which holds them."""
import numpy as np
import pytest

from test_torch_trainer import (assert_params_close, check_scenario, port,
                                rank_server,  # noqa: F401
                                reference, run_ranked)
from torch_threads import one_thread  # noqa: F401 (one thread)

NAMES = ["filter", "full", "none", "adaptive"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(NAMES, tmp_path_factory.mktemp("ref"))


def test_filter_median(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("filter", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert all(r["efficiency"] == 1.0 for r in summ["main"]["history"])


def test_full_detection(ref, tmp_path):
    """Paper-faithful replica comparison of whole gradients: the same
    check decisions as the reference's."""
    tr, _, summ, arrays = check_scenario("full", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert any("identified" in r for r in summ["main"]["history"])


def test_none_is_plain_parallel_sgd(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("none", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert summ["main"]["overall"] == 1.0


def test_adaptive_q_trace(ref, tmp_path):
    """q*_t depends on the previous loss, so it is held within 1e-5
    rather than exactly; the decisions must still agree, and the
    smallest distance between a check coin and its q*_t says how far
    from flipping one was."""
    from repro_torch.core.randomized import decide_generator

    summ, arrays = ref["adaptive"]
    tr, _, _ = port("adaptive", arrays, str(tmp_path))
    got, want = tr.history, summ["main"]["history"]
    assert len(got) == len(want)
    q_got = np.array([r["q"] for r in got])
    q_want = np.array([r["q"] for r in want])
    assert np.abs(q_got - q_want).max() <= 1e-5
    for g, w in zip(got, want):
        assert g.get("identified") == w.get("identified")
        assert g["efficiency"] == w["efficiency"]
        assert g["kappa"] == w["kappa"] and g["f_t"] == w["f_t"]
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
    coins = decide_generator(4).random(len(want))
    live = q_want > 0
    margin = float(np.abs(coins[live] - q_want[live]).min())
    print(f"adaptive q: max |q_port - q_ref| = "
          f"{np.abs(q_got - q_want).max():.3e}, smallest coin-to-q margin "
          f"{margin:.3e}")
    assert margin > np.abs(q_got - q_want).max()
    assert_params_close(tr, arrays)


def test_filter_median_two_ranks(ref, tmp_path):
    _, summ, _ = run_ranked("filter", ref, tmp_path, 2)
    assert all(r["efficiency"] == 1.0 for r in summ["main"]["history"])


def test_full_detection_four_ranks(ref, tmp_path):
    """Each leaf's (n, d) gradients gathered, detection on every rank."""
    _, summ, _ = run_ranked("full", ref, tmp_path, 4)
    assert any("identified" in r for r in summ["main"]["history"])
