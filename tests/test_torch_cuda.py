"""The port's hand-written CUDA kernels and its engine on the card.

These tests need an NVIDIA GPU and skip without one (marker ``cuda``).
On a machine with a card, from the root of the checkout:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports nothing of JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import gram, majority_vote, ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(T):
    return np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)


@pytest.mark.parametrize("Ie,d,T,B", [(10, 70001, 5, 3), (3, 255, 2, 1),
                                      (66, 4096, 40, 2)])
def test_gram_kernel_matches_plain(cuda, Ie, d, T, B):
    rng = np.random.default_rng(Ie + d)
    rows = torch.from_numpy(rng.normal(size=(Ie, d)).astype(np.float32)).to(cuda)
    W0 = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(cuda)
    keys = _keys(T)
    before = ops.launch_counts()["gram_factors"]
    got = gram.gram_factors_cuda(rows, W0, keys)
    want = gram.gram_factors_plain(rows, W0, keys)
    assert ops.launch_counts()["gram_factors"] == before + 1
    for g, w in zip(got[:2], want[:2]):       # G, S0: f32 spans, f64 sum
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    torch.testing.assert_close(got[2], want[2], rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(32, 8, 256), (32, 5, 65536), (7, 3, 70001)])
def test_relmax_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    x[:, 1] = x[:, 0]
    got = majority_vote.pairwise_relmax_batched_cuda(x)
    want = majority_vote.pairwise_relmax_batched_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert bool((got[:, 0, 1] == 0).all())


def test_run_batch_on_card_matches_cpu(cuda):
    specs = [repro_torch.TrialSpec(byz=(2, 5), attack="drift", q=0.3,
                                   steps=40, seed=s, n_data=64, d=4096,
                                   lr=16.0 / 4096) for s in range(4)]
    ops.reset_launch_counts()
    card = repro_torch.run_batch(specs)
    assert all(n > 0 for n in ops.launch_counts().values())
    cpu = repro_torch.run_batch(specs, device="cpu")
    np.testing.assert_array_equal(card.detect_flags, cpu.detect_flags)
    for a, b in zip(card, cpu):
        assert a.identify_step == b.identify_step
        assert a.q_trace == b.q_trace
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-4)
