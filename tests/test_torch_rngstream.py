"""The port's counter RNG, masked regroup and vectorized q*_t against the
JAX package.

Every quantity here is a control quantity of the device control plane,
so the contract is BITWISE: the threefry words (numpy and torch forms),
the stream blocks (also against the golden ``stream|*`` arrays of
``tests/golden/control_traces.npz``, opened read-only), the counter
permutations and the regroup layouts, ties in the keys included.  The
vectorized q*_t is exact given the same lambda; lambda itself goes
through ``exp``, whose float32 last ulp may differ between XLA and
PyTorch.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import adaptive as jadaptive
from repro.core import rngstream as jrng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import rngstream as trng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401 (one thread)

GOLDEN = Path(__file__).resolve().parent / "golden" / "control_traces.npz"
STREAM_SEED = 0xC0FFEE           # tests/make_golden.py's stream seed
SEEDS = [0, 1, 7, 12345, 0xC0FFEE, (1 << 32) + 5, (1 << 63) + 99, -3]


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (257,), (4, 33)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_words_bitwise(seed, shape):
    rng = np.random.default_rng(seed)
    k0, k1, c0, c1 = (_u32(rng, shape) for _ in range(4))
    want = jrng.threefry2x32(k0, k1, c0, c1)
    got_np = trng.threefry2x32(k0, k1, c0, c1)
    got_t = trng.threefry2x32_torch(_t64(k0), _t64(k1), _t64(c0), _t64(c1))
    for w, a, b in zip(want, got_np, got_t):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, w)
        assert b.dtype == torch.int64
        np.testing.assert_array_equal(b.numpy().astype(np.uint32), w)


def test_threefry_edge_words_and_broadcast():
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)
    k0, c1 = edge[:, None], edge[None, :]
    k1 = np.uint32(0xDEADBEEF)
    c0 = np.uint32(3)
    want = jrng.threefry2x32(np.broadcast_to(k0, (6, 6)),
                             np.full((6, 6), k1), np.full((6, 6), c0),
                             np.broadcast_to(c1, (6, 6)))
    got = trng.threefry2x32_torch(_t64(k0), torch.tensor(int(k1)),
                                  torch.tensor(int(c0)), _t64(c1))
    for w, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().astype(np.uint32), w)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_for_and_counter(seed):
    for tag in (jrng.DECIDE, jrng.TAMPER, jrng.PERM):
        a, b = jrng.key_for(seed, tag), trng.key_for(seed, tag)
        assert (a[0], a[1]) == (b[0], b[1])
        assert type(b[0]) is np.uint32 and type(b[1]) is np.uint32
    assert trng.counter(5, 1, 3) == jrng.counter(5, 1, 3)


def test_uniform01_bitwise_both_forms():
    bits = _u32(np.random.default_rng(4), (4096,))
    bits[:4] = [0, 255, 256, 0xFFFFFFFF]
    want = jrng.uniform01(bits)
    got_np = trng.uniform01(bits)
    got_t = trng.uniform01(_t64(bits))
    assert got_np.dtype == np.float32 and got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert (want >= 0).all() and (want < 1).all()


def test_stream_blocks_equal_the_golden_arrays():
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in ("stream|decide", "stream|tamper",
                                    "stream|perm")}
    dec = trng.decide_uniforms(STREAM_SEED, 16)
    tam = trng.tamper_uniforms(STREAM_SEED, 6, 5)
    perm = trng.perm_keys(STREAM_SEED, 4, 5)
    for got, key in ((dec, "stream|decide"), (tam, "stream|tamper"),
                     (perm, "stream|perm")):
        want = golden[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_blocks_bitwise(seed):
    np.testing.assert_array_equal(trng.decide_uniforms(seed, 37),
                                  jrng.decide_uniforms(seed, 37))
    np.testing.assert_array_equal(trng.tamper_uniforms(seed, 11, 9),
                                  jrng.tamper_uniforms(seed, 11, 9))
    np.testing.assert_array_equal(trng.perm_keys(seed, 11, 9),
                                  jrng.perm_keys(seed, 11, 9))
    assert trng.decide_uniforms(seed, 0).shape == (0,)
    assert trng.perm_keys(seed, 3, 0).shape == (3, 2, 0)


def _key_words(seeds, tag):
    ks = [trng.key_for(s, tag) for s in seeds]
    return (torch.tensor([int(a) for a, _ in ks], dtype=torch.int64),
            torch.tensor([int(b) for _, b in ks], dtype=torch.int64))


def test_device_blocks_equal_the_host_blocks():
    """A chunk's coins and keys, drawn at once on the torch side, equal
    each trial's numpy stream, so the in-loop decisions are the host
    replay's."""
    T, n = 13, 7
    k0, k1 = _key_words(SEEDS, trng.DECIDE)
    dec = trng.decide_uniforms_torch(k0, k1, T)
    assert dec.shape == (T, len(SEEDS)) and dec.dtype == torch.float32
    for tag in (trng.TAMPER, trng.PERM):
        k0, k1 = _key_words(SEEDS, tag)
        words = trng.phase_worker_torch(k0, k1, T, n)
        assert words.shape == (T, 2, len(SEEDS), n)
        for b, s in enumerate(SEEDS):
            want = jrng._phase_worker_block(s, T, n, tag)
            np.testing.assert_array_equal(
                words[:, :, b].numpy().astype(np.uint32), want)
            if tag == trng.TAMPER:
                np.testing.assert_array_equal(
                    trng.uniform01(words[:, :, b]).numpy(),
                    jrng.tamper_uniforms(s, T, n))
    for b, s in enumerate(SEEDS):
        np.testing.assert_array_equal(dec[:, b].numpy(),
                                      jrng.decide_uniforms(s, T))


def test_counter_permuter_follows_the_reference():
    keys = jrng.perm_keys(3, 6, 9)
    keys[2, 0, :4] = 17                       # force key ties
    jclock, tclock = jrng.StepClock(), trng.StepClock()
    jp = jrng.CounterPermuter(keys, jclock)
    tp = trng.CounterPermuter(keys, tclock)
    rng = np.random.default_rng(0)
    for t in range(6):
        jclock.t = tclock.t = t
        for _ in range(2):
            act = np.flatnonzero(rng.random(9) < 0.8)
            np.testing.assert_array_equal(tp.permutation(act),
                                          jp.permutation(act))


REGROUP_CASES = ["random", "ties", "all_equal_keys", "repl_above_active",
                 "edges"]


def _regroup_case(name):
    rng = np.random.default_rng(REGROUP_CASES.index(name))
    B, n = 48, 9
    keys = _u32(rng, (B, n))
    active = rng.random((B, n)) < 0.75
    repl = rng.integers(1, 6, B)
    if name == "ties":
        keys = rng.integers(0, 3, (B, n)).astype(np.uint32)
    elif name == "all_equal_keys":
        keys[:] = 0xFFFFFFFF
    elif name == "repl_above_active":
        repl = active.sum(axis=1) + rng.integers(1, 4, B)
    elif name == "edges":
        active[0] = False                      # no active worker
        active[1] = True
        repl[1] = 1                            # every worker its own group
        repl[2] = 0                            # clamped to 1
        active[3, :] = False
        active[3, 4] = True                    # one active worker, r > 1
        repl[3] = 2
    return keys, active, repl.astype(np.int32)


@pytest.mark.parametrize("case", REGROUP_CASES)
def test_batched_regroup_bitwise(case):
    keys, active, repl = _regroup_case(case)
    want = jops.batched_regroup(jnp.asarray(keys), jnp.asarray(active),
                                jnp.asarray(repl))
    oracle_j = jref.batched_regroup_ref(keys, active, repl)
    oracle_t = tref.batched_regroup_ref(keys, active, repl)
    got = tops.batched_regroup(_t64(keys), torch.from_numpy(active),
                               torch.from_numpy(repl))
    for w, oj, ot, g in zip(want, oracle_j, oracle_t, got):
        w = np.asarray(w)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_array_equal(g.numpy(), ot)


@pytest.mark.parametrize("case", ["random", "ties", "repl_above_active"])
@pytest.mark.parametrize("gated", [False, True])
def test_masked_vote_and_detect_bitwise(case, gated):
    keys, active, repl = _regroup_case(case)
    B, n = active.shape
    rng = np.random.default_rng(11)
    # replicas: copies of a few values, so groups agree or split
    base = rng.normal(size=(B, 3, 16)).astype(np.float32)
    reps = base[np.arange(B)[:, None], rng.integers(0, 3, (B, n))]
    gate = rng.random(B) < 0.6 if gated else None
    jv = jops.batched_vote_masked(
        jnp.asarray(reps), jnp.asarray(keys), jnp.asarray(active),
        jnp.asarray(repl), tau=1e-6,
        gate=None if gate is None else jnp.asarray(gate))
    tv = tops.batched_vote_masked(
        torch.from_numpy(reps), _t64(keys), torch.from_numpy(active),
        torch.from_numpy(repl), tau=1e-6,
        gate=None if gate is None else torch.from_numpy(gate))
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd = jops.batched_detect_masked(
        jnp.asarray(reps), jnp.asarray(keys), jnp.asarray(active),
        jnp.asarray(repl), gate=None if gate is None else jnp.asarray(gate))
    td = tops.batched_detect_masked(
        torch.from_numpy(reps), _t64(keys), torch.from_numpy(active),
        torch.from_numpy(repl),
        gate=None if gate is None else torch.from_numpy(gate))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _q_inputs():
    rng = np.random.default_rng(0)
    loss = np.concatenate([rng.lognormal(0.0, 3.0, 3000),
                           [0.0, -1.0, 1e-30, 50.0, 1e4, np.inf]])
    loss = loss.astype(np.float32)
    f_t = rng.integers(-1, 6, loss.size).astype(np.int32)
    p = rng.choice([0.0, 1e-3, 0.1, 0.5, 0.8, 1.0], loss.size).astype(
        np.float32)
    return loss, f_t, p


def test_lam_from_loss_arr_against_the_reference():
    loss, _, _ = _q_inputs()
    want = np.asarray(jadaptive.lam_from_loss_arr(jnp.asarray(loss), jnp))
    got = tadaptive.lam_from_loss_arr(torch.from_numpy(loss)).numpy()
    assert got.dtype == want.dtype == np.float32
    # exp's float32 last ulp is the library's: within 1 ulp of 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -23)
    np.testing.assert_allclose(
        got, [1.0 - np.exp(-max(0.0, float(x))) for x in loss],
        rtol=0, atol=2 ** -22)


def test_q_star_arr_against_the_reference():
    loss, f_t, p = _q_inputs()
    lam = np.array(jadaptive.lam_from_loss_arr(jnp.asarray(loss), jnp))
    want = np.asarray(jadaptive.q_star_arr(
        jnp.asarray(f_t), jnp.asarray(p), jnp.asarray(lam), jnp))
    got = tadaptive.q_star_arr(torch.from_numpy(f_t), torch.from_numpy(p),
                               torch.from_numpy(lam)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the guards: f_t <= 0 or p == 0 give 0, results in [0, 1]
    assert (got[(f_t <= 0) | (p == 0)] == 0).all()
    assert ((got >= 0) & (got <= 1)).all()
    # and the float64 scalar closed form within float32 accuracy where
    # b = 1 - (1 - p)^f_t does not cancel (p >= 0.1; at p = 1e-3 the
    # float32 form of both packages keeps ~4 digits of b)
    big = p >= 0.1
    ref64 = [tadaptive.q_star(int(f), float(pp), float(lm))
             for f, pp, lm in zip(f_t[big], p[big], lam[big])]
    np.testing.assert_allclose(got[big], ref64, rtol=1e-5, atol=1e-6)
