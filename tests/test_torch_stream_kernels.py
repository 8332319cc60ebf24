"""The port's stream-plane kernels against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages.
On the CPU the port's wrappers run their plain PyTorch versions (the
hand-written CUDA kernels are held against those on the card by
chip_smoke.py and tests/test_torch_cuda.py); the reference runs its
Pallas kernels in interpret mode (``impl="pallas", interpret=True``)
and its jnp oracles.  Tolerances are tests/test_kernel_parity.py's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import coded_encode as tenc
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import majority_vote as tmv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sketch as tsk
from torch_threads import one_thread  # noqa: F401 (one thread)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _fused_inputs(B, Ie, d, seed):
    return (_normal(seed, Ie, d), _normal(seed + 1, B, d),
            _normal(seed + 2, B, Ie))


def _ref_outputs(rows, W, cw, key, rows_dtype=jnp.float32):
    r = jnp.asarray(rows, dtype=rows_dtype)
    return (jops.fused_step(r, jnp.asarray(W), jnp.asarray(cw), key,
                            impl="pallas", interpret=True),
            jref.fused_step_ref(r, jnp.asarray(W), jnp.asarray(cw), key))


@pytest.mark.parametrize("B,Ie,d", [
    (1, 3, 8),            # B = 1 singleton batch, tiny d
    (2, 10, 511),         # d off the 512 block and off the 256 sketch lane
    (3, 7, 513),          # just past one block
    (2, 8, 1024),         # exact block multiple
])
def test_fused_step_vs_reference(B, Ie, d):
    rows, W, cw = _fused_inputs(B, Ie, d, seed=B + Ie + d)
    W_t, resid_t, sk_t = tops.fused_step(_t(rows), _t(W), _t(cw), 1234)
    for W_r, resid_r, sk_r in _ref_outputs(rows, W, cw, 1234):
        np.testing.assert_allclose(W_t.numpy(), W_r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(resid_t.numpy(), resid_r, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(sk_t.numpy(), sk_r, rtol=2e-5, atol=1e-3)


def test_fused_step_zero_coeffs_keep_iterate_bitwise():
    rows, W, _ = _fused_inputs(3, 6, 1024, seed=11)
    W_t, resid_t, _ = tops.fused_step(_t(rows), _t(W),
                                      torch.zeros((3, 6)), 7)
    np.testing.assert_array_equal(W_t.numpy(), W)
    np.testing.assert_allclose(
        resid_t.numpy(), np.asarray(jref.coded_encode_ref(W, rows.T)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [511, 1024])
def test_fused_step_bf16_rows_vs_reference(d):
    """bf16-stored rows: the port and the reference read the same bf16
    values (the torch rounding, exactly representable in JAX's bf16),
    so only the summation order differs; tolerances as the reference's
    own bf16 test."""
    rows, W, cw = _fused_inputs(2, 8, d, seed=d)
    rows_bf = _t(rows).to(torch.bfloat16)
    rows_vals = rows_bf.to(torch.float32).numpy()
    W_t, resid_t, sk_t = tops.fused_step(rows_bf, _t(W), _t(cw), 99)
    for W_r, resid_r, sk_r in _ref_outputs(rows_vals, W, cw, 99,
                                           rows_dtype=jnp.bfloat16):
        np.testing.assert_allclose(W_t.numpy(), W_r, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(resid_t.numpy(), resid_r, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(sk_t.numpy(), sk_r, rtol=1e-4, atol=1e-2)
    # and the bf16 stream stays close to the f32 stream of the same data
    W_f, _, _ = tops.fused_step(_t(rows), _t(W), _t(cw), 99)
    np.testing.assert_allclose(W_t.numpy(), W_f.numpy(), rtol=3e-2,
                               atol=3e-1)


@pytest.mark.parametrize("B,d", [(1, 8), (3, 700), (5, 256), (2, 2049)])
def test_batched_sketch_vs_reference(B, d):
    g = _normal(B + d, B, d)
    got = tops.batched_sketch(_t(g), 12345).numpy()
    for want in (jops.batched_sketch(g, 12345, impl="pallas", interpret=True),
                 jref.batched_sketch_ref(g, 12345, 256)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("d", [8, 255, 256, 257, 2049])
def test_sketch_vs_reference(d):
    g = _normal(d, d)
    got = tops.sketch(_t(g), 99).numpy()
    for want in (jops.sketch(g, 99, k=256, interpret=True),
                 jref.sketch_ref(g, 99, 256)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("B,s,m,d", [(1, 1, 3, 8), (3, 1, 64, 700),
                                     (2, 4, 5, 2049), (4, 9, 2, 256)])
def test_batched_coded_encode_vs_reference(B, s, m, d):
    C, G = _normal(m, B, s, m), _normal(d, B, m, d)
    got = tops.batched_coded_encode(_t(C), _t(G)).numpy()
    for want in (jops.batched_coded_encode(C, G, impl="pallas",
                                           interpret=True),
                 jref.batched_coded_encode_ref(C, G)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_sym,m,d", [(2, 3, 8), (3, 3, 2047), (4, 2, 2049)])
def test_coded_encode_vs_reference(n_sym, m, d):
    C, G = _normal(m, n_sym, m), _normal(d, m, d)
    got = tops.coded_encode(_t(C), _t(G)).numpy()
    for want in (jops.coded_encode(C, G, interpret=True),
                 jref.coded_encode_ref(C, G)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("R,d", [(3, 8), (5, 2047), (5, 2048), (7, 2049)])
def test_pairwise_relmax_vs_reference(R, d):
    reps = _normal(R + d, R, d)
    reps[1] = reps[0]
    got = tops.pairwise_relmax(_t(reps)).numpy()
    for want in (jops.pairwise_relmax(reps, interpret=True),
                 jref.pairwise_maxdiff_ref(reps)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert got[0, 1] == 0


@pytest.mark.parametrize("case", ["one_bad", "two_bad", "no_majority",
                                  "all_agree"])
def test_vote_bitwise_vs_majority_vote_ref(case):
    honest = _normal(0, 1000)
    reps = np.tile(honest[None], (5, 1))
    if case in ("one_bad", "two_bad"):
        reps[1] *= -3.0
    if case == "two_bad":
        reps[3] += 1e-3
    if case == "no_majority":
        reps = _normal(1, 5, 1000)
    v_t, f_t, ok_t = tops.vote(_t(reps), tau=1e-5)
    v_r, f_r, ok_r = jref.majority_vote_ref(jnp.asarray(reps), tau=1e-5)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_r))
    assert bool(ok_t) == bool(ok_r)
    v_j, f_j, _ = jops.vote(jnp.asarray(reps), interpret=True)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_port_oracles_agree_with_plain_versions():
    """The port's new oracles (ref.py) against the JAX package's."""
    C, G = _normal(1, 3, 4), _normal(2, 4, 300)
    np.testing.assert_allclose(tref.coded_encode_ref(_t(C), _t(G)).numpy(),
                               np.asarray(jref.coded_encode_ref(C, G)),
                               rtol=1e-6, atol=1e-6)
    rows, W, cw = _fused_inputs(2, 5, 300, seed=3)
    for a, b in zip(tref.fused_step_ref(_t(rows), _t(W), _t(cw), 5),
                    jref.fused_step_ref(rows, W, cw, 5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


def test_stream_dispatch_contract_on_cpu():
    """A CPU tensor takes the plain version and counts no launch; asking
    for a CUDA kernel with one raises, and so does calling a CUDA
    wrapper directly."""
    rows, W, cw = (_t(x) for x in _fused_inputs(2, 4, 64, seed=0))
    C3, G3 = torch.zeros((2, 1, 4)), torch.zeros((2, 4, 64))
    calls = [
        lambda **kw: tops.fused_step(rows, W, cw, 1, **kw),
        lambda **kw: tops.batched_sketch(W, 1, **kw),
        lambda **kw: tops.sketch(W[0], 1, **kw),
        lambda **kw: tops.sketch_shard(W, 1, 256, 128, 64, **kw),
        lambda **kw: tops.batched_coded_encode(C3, G3, **kw),
        lambda **kw: tops.coded_encode(C3[0], G3[0], **kw),
        lambda **kw: tops.pairwise_relmax(W, **kw),
        lambda **kw: tops.vote(W, **kw),
    ]
    before = tops.launch_counts()
    for call in calls:
        call()
        with pytest.raises(ValueError, match="cuda"):
            call(impl="cuda")
    assert tops.launch_counts() == before
    for direct in (lambda: tfs.fused_step_cuda(rows, W, cw, 1),
                   lambda: tsk.sketch_batched_cuda(W, 1),
                   lambda: tsk.sketch_cuda(W[0], 1),
                   lambda: tsk.sketch_block_cuda(W, 1, 256, 128, 64),
                   lambda: tenc.coded_encode_batched_cuda(C3, G3),
                   lambda: tenc.coded_encode_cuda(C3[0], G3[0]),
                   lambda: tmv.pairwise_relmax_cuda(W)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            direct()
    assert set(before) == {
        "gram_factors", "pairwise_relmax_batched", "pairwise_relmax",
        "fused_step", "sketch_batched", "sketch", "sketch_shard",
        "sketch_shard_f32", "coded_encode_batched", "coded_encode", "flash_attention"}
