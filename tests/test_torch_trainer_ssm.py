"""The port's ``Trainer`` against the JAX package's on mamba2-780m
(``reduced()``, f32), on the CPU: randomized mode with a fixed q under
sign_flip (momentum) and deterministic mode under noise (AdamW, whose
state covers the f32 ``A_log``, ``dt_bias`` and ``D`` leaves).  The
scenarios, the reference subprocess and the tolerances (control exact,
losses within 1e-4 relative, parameters within 1e-4 (1 + max|p|)) are
those of ``tests/test_torch_trainer.py``, which holds them."""
import pytest

from test_torch_trainer import assert_params_close, check_scenario, reference
from torch_threads import one_thread  # noqa: F401 (one thread)

NAMES = ["ssm_randomized", "ssm_deterministic"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(NAMES, tmp_path_factory.mktemp("ref"))


def test_randomized_fixed_q_under_sign_flip(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("ssm_randomized", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert len(tr.params["decoder"][0][0]["mixer"]) == 13
    h = summ["main"]["history"]
    ident = sorted(w for r in h for w in r.get("identified", []))
    assert ident and set(ident) <= {2, 5}


def test_deterministic_under_noise(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("ssm_deterministic", ref, tmp_path)
    assert_params_close(tr, arrays)
    assert summ["main"]["identified"][1] and summ["main"]["kappa"] == 1
    assert summ["main"]["history"][-1]["efficiency"] == 0.5
