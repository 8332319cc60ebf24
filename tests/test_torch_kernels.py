"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages.
On the CPU the port's wrappers run their plain PyTorch versions (the
hand-written CUDA kernels are held against those on the card by
chip_smoke.py and tests/test_torch_cuda.py); the reference runs its
Pallas kernels in interpret mode and its jnp oracles.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import detection as jdetection
from repro.kernels import majority_vote as jmv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import detection as tdetection
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import majority_vote as tmv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _keys(T):
    return np.uint32(0x9E3779B9) * (np.arange(T, dtype=np.uint32) + 1)


@pytest.mark.parametrize("key", [0, 1, 0x9E3779B9, 0xFFFFFFFF,
                                 int(_keys(120)[-1])])
def test_hash_signs_bitwise(key):
    """Sign hash in int64-masked torch == the reference's uint32 hash."""
    rng = np.random.default_rng(key & 0xFFFF)
    idx = np.concatenate([
        np.arange(4096, dtype=np.uint32),
        rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32),
        np.array([2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1, 1 << 20], np.uint32)])
    want = np.asarray(jref.hash_signs_ref(jnp.asarray(idx), key))
    got = tref.hash_signs_ref(torch.from_numpy(idx.astype(np.int64)), key)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_signs_tensor_keys_broadcast():
    """The (T, d) sign table of the plain gram version, one row per key."""
    idx = np.arange(3000, dtype=np.uint32)
    keys = _keys(4)
    table = tref.hash_signs_ref(torch.from_numpy(idx.astype(np.int64))[None],
                                torch.from_numpy(keys.astype(np.int64))[:, None])
    for t, key in enumerate(keys):
        np.testing.assert_array_equal(
            table[t].numpy(), np.asarray(jref.hash_signs_ref(
                jnp.asarray(idx), int(key))))


@pytest.mark.parametrize("d", [700, 1024, 2049])
@pytest.mark.parametrize("Ie", [6, 10])
@pytest.mark.parametrize("T", [1, 3, 5])
def test_gram_factors_vs_reference(d, Ie, T):
    """Plain port gram_factors vs the reference's Pallas kernel (interpret
    mode) and its composed oracle; tolerances as
    tests/test_kernel_parity.py's gram test."""
    rng = np.random.default_rng(d + 10 * Ie + 100 * T)
    rows = rng.normal(size=(Ie, d)).astype(np.float32)
    W0 = rng.normal(size=(3, d)).astype(np.float32)
    keys = _keys(T)
    G, S0, SK = tops.gram_factors(torch.from_numpy(rows),
                                  torch.from_numpy(W0), keys)
    assert SK.shape == (T, Ie, 256)
    for impl_out in (
            jops.gram_factors(rows, W0, keys, impl="pallas", interpret=True),
            jref.gram_factors_ref(rows, W0, keys)):
        Gj, S0j, SKj = (np.asarray(x) for x in impl_out)
        np.testing.assert_allclose(G.numpy(), Gj, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(S0.numpy(), S0j, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(SK.numpy(), SKj, rtol=2e-5, atol=1e-3)


def test_gram_factors_sketch_only_and_empty_keys():
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.normal(size=(6, 700)).astype(np.float32))
    G, S0, SK = tops.gram_factors(rows, None, _keys(3), with_gram=False)
    assert G is None and S0 is None
    np.testing.assert_allclose(
        SK.numpy(), np.asarray(jref.gram_factors_ref(rows.numpy(), None,
                                                     _keys(3))[2]),
        rtol=2e-5, atol=1e-3)
    G0, S00, SK0 = tops.gram_factors(rows, None, np.zeros(0, np.uint32))
    assert S00 is None and SK0.shape == (0, 6, 256)
    np.testing.assert_allclose(G0.numpy(), (rows @ rows.T).numpy())


def test_port_oracles_agree_with_plain_versions():
    """The port's own oracles (ref.py) against its plain kernel versions."""
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(rng.normal(size=(5, 1300)).astype(np.float32))
    W0 = torch.from_numpy(rng.normal(size=(2, 1300)).astype(np.float32))
    keys = _keys(3)
    for a, b in zip(tgram.gram_factors_plain(rows, W0, keys),
                    tref.gram_factors_ref(rows, W0,
                                          torch.from_numpy(keys.astype(np.int64)))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=1e-3)
    x = torch.from_numpy(rng.normal(size=(4, 300)).astype(np.float32))
    np.testing.assert_allclose(
        tref.sketch_ref(x[0], 7, 256).numpy(),
        np.asarray(jref.sketch_ref(x[0].numpy(), 7, 256)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tref.batched_sketch_ref(x, 7, 256).numpy(),
        np.asarray(jref.batched_sketch_ref(x.numpy(), 7, 256)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tref.pairwise_maxdiff_ref(x).numpy(),
        np.asarray(jref.pairwise_maxdiff_ref(x.numpy())), rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 5, 300), (2, 8, 256), (1, 3, 2049),
                                   (4, 2, 5000)])
def test_relmax_vs_reference_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x[:, 1] = x[:, 0]                          # an agreeing pair
    want = np.asarray(jmv.pairwise_relmax_batched(x, interpret=True))
    got = tops.batched_pairwise_relmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:, 0, 1] == 0).all()


def test_relmax_plain_chunking_matches_unchunked():
    """The plain version folds d in chunks; the max does not depend on
    where the chunks fall."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(64, 8, 1500)).astype(np.float32))
    chunked = tmv.pairwise_relmax_batched_plain(x)     # chunk = 128 here
    np.testing.assert_array_equal(chunked.numpy(),
                                  tref.batched_pairwise_maxdiff_ref(x).numpy())


def _planted_stack(seed, B=6, n=9, k=64):
    """Symbols where each replica group holds one base vector, a random
    subset of members tampered (+ an offset), groups and idle workers
    drawn at random: the agree/disagree structure the engine feeds the
    vote and the detector."""
    rng = np.random.default_rng(seed)
    sym = np.zeros((B, n, k), np.float32)
    group = np.full((B, n), -1, np.int32)
    for b in range(B):
        r = int(rng.choice([1, 2, 3, 5]))
        perm = rng.permutation(n)
        m = n // r
        for g in range(m):
            mem = perm[g * r:(g + 1) * r]
            group[b, mem] = g
            base = rng.normal(size=k).astype(np.float32)
            sym[b, mem] = base
            bad = mem[rng.random(len(mem)) < 0.35]
            sym[b, bad] = base + np.float32(rng.choice([1.0, 1e-3, 50.0]))
    return sym, group


@pytest.mark.parametrize("seed", range(4))
def test_batched_vote_exact(seed):
    sym, group = _planted_stack(seed)
    wc_j, faulty_j = jops.batched_vote(jnp.asarray(sym), jnp.asarray(group),
                                       tau=1e-9, impl="xla")
    wc_t, faulty_t = tops.batched_vote(torch.from_numpy(sym),
                                       torch.from_numpy(group), tau=1e-9)
    np.testing.assert_array_equal(wc_t.numpy(), np.asarray(wc_j))
    np.testing.assert_array_equal(faulty_t.numpy(), np.asarray(faulty_j))


@pytest.mark.parametrize("seed", range(4))
def test_detect_groups_batched_exact(seed):
    sym, group = _planted_stack(100 + seed)
    fj, mj = jdetection.detect_groups_batched(jnp.asarray(sym),
                                              jnp.asarray(group), tau=1e-9)
    ft, mt = tdetection.detect_groups_batched(torch.from_numpy(sym),
                                              torch.from_numpy(group), tau=1e-9)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_dispatch_contract_on_cpu():
    """A CPU tensor takes the plain version; asking for the CUDA kernel
    with one raises, and so does calling a CUDA wrapper directly."""
    x = torch.zeros((1, 2, 8))
    rows = torch.zeros((3, 8))
    assert tops.resolve_impl(None, "cpu") == "torch"
    assert tops.resolve_impl("torch", "cpu") == "torch"
    with pytest.raises(ValueError):
        tops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError):
        tops.resolve_impl("pallas", "cpu")
    with pytest.raises(ValueError):
        tops.batched_pairwise_relmax(x, impl="cuda")
    with pytest.raises(ValueError):
        tops.gram_factors(rows, None, _keys(1), impl="cuda")
    with pytest.raises(ValueError):
        tmv.pairwise_relmax_batched_cuda(x)
    with pytest.raises(ValueError):
        tgram.gram_factors_cuda(rows, None, _keys(1))
    before = tops.launch_counts()
    tops.batched_pairwise_relmax(x)
    tops.gram_factors(rows, None, _keys(1))
    assert tops.launch_counts() == before     # plain versions launch nothing
