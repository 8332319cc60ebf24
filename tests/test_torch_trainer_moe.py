"""The port's ``Trainer`` against the JAX package's on phi3.5-moe
(``reduced()``, f32: 2 layers, 4 experts top-2), on the CPU:
deterministic mode under sign_flip on workers 2 and 5 with AdamW, whose
state covers the router and expert leaves.  Every worker's loss carries
0.01 times its MoE aux loss, and each routes its own rows' tokens as
one group, as the reference's worker bodies do.  The scenario, the
reference subprocess and the tolerances (control exact, losses within
1e-4 relative, parameters within 1e-4 (1 + max|p|)) are those of
``tests/test_torch_trainer.py``, which holds them."""
import pytest

from test_torch_trainer import assert_params_close, check_scenario, reference
from torch_threads import one_thread  # noqa: F401 (one thread)

NAMES = ["moe_deterministic"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(NAMES, tmp_path_factory.mktemp("ref"))


def test_deterministic_under_sign_flip(ref, tmp_path):
    tr, _, summ, arrays = check_scenario("moe_deterministic", ref, tmp_path)
    assert_params_close(tr, arrays)
    ffn = tr.params["decoder"][0][0]["ffn"]
    assert sorted(ffn) == ["down", "gate", "router", "up"]
    assert tuple(ffn["gate"].shape) == (2, 4, 64, 64)
    h = summ["main"]["history"]
    ident = sorted(w for r in h for w in r.get("identified", []))
    assert ident and set(ident) <= {2, 5}
