"""The trainer's parts against the JAX package, on the CPU.

Seeded numpy inputs go through the reference function and the port's
counterpart; each test states its tolerance:

  * ``core.prngkey`` against ``jax.random``: keys, fold_in, split, bits,
    uniform and bernoulli bitwise; normal within 1e-6;
  * ``core.byzantine``: every attack, ``maybe_tamper``'s coin and tree,
    bitwise (noise within 1e-6 * scale);
  * ``detection.sketch_tree`` within 1e-5 relative; ``detect_groups``
    and ``detect_full`` flags exact;
  * ``optim``: ``lr_at`` and ``opt_update`` (sgd / momentum / adamw,
    with and without clipping) within 1e-6; compression's signs bitwise
    and its f32 mean within 1e-6 (another summation order); the data
    pipeline bitwise;
  * the identify vote against the reference's formula on tampered
    replicas: the identified set exact;
  * checkpoints in the reference's layout, readable by either package.

The model's loss, gradients and plain steps are in
``tests/test_torch_train_model.py``.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jget_config
from repro.core import byzantine as jbyz
from repro.core import detection as jdet
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.core import byzantine, detection, prngkey, tree
from repro_torch.core.assignment import check_assignment
from repro_torch.core.randomized import ProtocolState, BFTConfig
from repro_torch.data import pipeline as data
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import compression as comp
from repro_torch.optim import optimizer as opt_mod
from repro_torch.train import steps
from torch_threads import one_thread  # noqa: F401 (one thread)

ARCHS = ["llama3.2-1b", "gemma3-1b", "qwen3-4b"]


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _jcfg(name):
    return dataclasses.replace(jget_config(name).reduced(), dtype="float32")


def _kd(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)).ravel())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jparams(name):
    return jax.tree.map(np.asarray, JM.init(_jcfg(name),
                                            jax.random.PRNGKey(0)))


def _grad_tree(seed=0, name="llama3.2-1b"):
    """A gradient-shaped tree: the reduced model's parameter shapes with
    seeded normal values, as (jax tree of numpy, port tree of tensors)."""
    jt = _jparams(name)
    rng = np.random.default_rng(seed)
    vals = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jt)
    return vals, convert.from_jax_train_params(_cfg(name), vals, "cpu")


def _same_tree(got, want, atol=0.0):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if atol == 0.0:
            assert np.array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= atol


# ---------------------------------------------------------------------------
# prngkey
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 2, 7, 8, 11, 99, 12345, 2**31 - 1, 2**32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_keys_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prngkey.PRNGKey(seed)
    assert _kd(jk) == tk
    for x in (0, 1, 5, 1000, 2**31 + 3):
        assert _kd(jax.random.fold_in(jk, x)) == prngkey.fold_in(tk, x)
    for n in (1, 2, 5, 11):
        assert [_kd(k) for k in jax.random.split(jk, n)] == \
            prngkey.split(tk, n)
    kj = jax.random.fold_in(jax.random.fold_in(jk, 3), 6)
    assert int(jdet.key_scalar_for_step(kj)) == \
        prngkey.key_scalar_for_step(prngkey.fold_in(prngkey.fold_in(tk, 3),
                                                    6))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_draws(seed):
    jk, tk = jax.random.PRNGKey(seed), prngkey.PRNGKey(seed)
    for shape in ((), (5,), (3, 7), (2, 3, 129)):
        b = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(b.astype(np.int64),
                              prngkey.bits(tk, shape).numpy())
        assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                              prngkey.uniform(tk, shape).numpy())
        n = np.asarray(jax.random.normal(jk, shape))
        assert np.abs(n - prngkey.normal(tk, shape).numpy()).max() <= 1e-6
    assert np.float32(jax.random.uniform(jk, ())) == \
        prngkey.uniform_scalar(tk)
    for p in (0.0, 0.25, 0.6, 0.999, 1.0):
        for sub in prngkey.split(tk, 8):
            want = bool(jax.random.bernoulli(jnp.array(sub, jnp.uint32), p))
            assert prngkey.bernoulli_scalar(sub, p) == want


def test_prngkey_normal_tails():
    """Many draws: the erfinv polynomial tracks XLA's into the tails."""
    jk, tk = jax.random.PRNGKey(3), prngkey.PRNGKey(3)
    n = np.asarray(jax.random.normal(jk, (200_000,)))
    t = prngkey.normal(tk, (200_000,)).numpy()
    assert np.abs(n - t).max() <= 1e-6
    assert np.abs(n).max() > 4.0


# ---------------------------------------------------------------------------
# byzantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", jbyz.ATTACKS)
def test_apply_attack_matches_reference(attack):
    assert byzantine.ATTACKS == jbyz.ATTACKS
    jt, tt = _grad_tree(1)
    key = (0, 17)
    want = jbyz.apply_attack(jt, attack, jnp.array(key, jnp.uint32), 5.0)
    got = byzantine.apply_attack(tt, attack, key, 5.0)
    _same_tree(got, want, atol=5e-6 if attack == "noise" else 0.0)


@pytest.mark.parametrize("attack", ["sign_flip", "noise", "inf"])
@pytest.mark.parametrize("is_byz", [False, True])
def test_maybe_tamper_coin_and_tree(attack, is_byz):
    jt, tt = _grad_tree(2)
    fired = 0
    for w in range(16):
        key = prngkey.fold_in(prngkey.fold_in(prngkey.PRNGKey(5), 3), w)
        jtree, jdo = jbyz.maybe_tamper(
            jt, is_byz=jnp.bool_(is_byz), key=jnp.array(key, jnp.uint32),
            attack=attack, p_tamper=0.6, scale=5.0)
        ttree, tdo = byzantine.maybe_tamper(
            tt, is_byz=is_byz, key=key, attack=attack, p_tamper=0.6,
            scale=5.0)
        assert bool(jdo) == tdo
        fired += tdo
        _same_tree(ttree, jtree, atol=5e-6 if attack == "noise" else 0.0)
    assert (fired > 0) == is_byz


def test_worker_key_is_the_references():
    key = jax.random.PRNGKey(8)
    for step, w in ((0, 0), (5, 3), (17, 7)):
        want = jax.random.fold_in(jax.random.fold_in(key, step), w)
        assert _kd(want) == steps.worker_key(prngkey.PRNGKey(8), step, w)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [256, 96])
def test_sketch_tree_matches_reference(k):
    jt, tt = _grad_tree(3)
    ks = 0x1234ABCD
    want = np.asarray(jdet.sketch_tree(jt, jnp.uint32(ks), k))
    got = detection.sketch_tree(tt, ks, k).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the key offsets per leaf: one leaf's sketch is the reference's
    leaf = tree.leaves(tt)[4]
    key4 = (ks + detection.LEAF_KEY_STEP * 5) & 0xFFFFFFFF
    np.testing.assert_allclose(
        detection.hash_sign_sketch(leaf.reshape(-1), key4, k).numpy(),
        np.asarray(jdet.hash_sign_sketch(jnp.asarray(leaf.numpy()).ravel(),
                                         jnp.uint32(key4), k)),
        rtol=1e-5, atol=1e-5)


def _symbols(seed, n=8, k=32, G=3, r=2, bad=(), scale=1.0):
    rng = np.random.default_rng(seed)
    gow = np.full(n, -1, np.int32)
    perm = rng.permutation(n)[: G * r]
    gow[perm] = np.repeat(np.arange(G), r)
    base = rng.standard_normal((G, k)).astype(np.float32) * scale
    sym = np.zeros((n, k), np.float32)
    for w in range(n):
        sym[w] = base[gow[w]] if gow[w] >= 0 else rng.standard_normal(k)
    for w in bad:
        sym[w] = sym[w] * -3.0 + 0.5
    return sym, gow


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bad", [(), (0,), (1, 4), (2, 3, 7)])
def test_detect_groups_flags_exact(seed, bad):
    sym, gow = _symbols(seed, bad=bad, scale=10.0 ** (seed - 2))
    G = 3
    jf, jm = jdet.detect_groups(jnp.asarray(sym), jnp.asarray(gow), G)
    tf, tm = detection.detect_groups(torch.from_numpy(sym),
                                     torch.from_numpy(gow), G)
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_detect_full_flags_exact(seed):
    rng = np.random.default_rng(seed)
    rep = np.repeat(rng.standard_normal((1, 500)).astype(np.float32), 3, 0)
    for bad in (None, 1, 2):
        r = rep.copy()
        if bad is not None:
            r[bad, rng.integers(500)] *= 1.0 + 1e-3
        assert bool(jdet.detect_full(jnp.asarray(r))) == \
            bool(detection.detect_full(torch.from_numpy(r)))


# ---------------------------------------------------------------------------
# the identify vote
# ---------------------------------------------------------------------------

def _reference_vote(reps, tau):
    """The reference identify body's formula (``steps.py:298-312``) on
    one leaf's replicas (G, r, d)."""
    reps = jnp.asarray(reps)
    G, r = reps.shape[:2]
    scale = 1.0 + jnp.minimum(jnp.abs(reps[:, :, None]),
                              jnp.abs(reps[:, None, :]))
    agree = (jnp.abs(reps[:, :, None] - reps[:, None, :])
             <= tau * scale).all(axis=-1)
    counts = agree.sum(axis=-1)
    winner = jnp.argmax(counts > (r // 2), axis=-1)
    value = reps[jnp.arange(G), winner]
    faulty = ~agree[jnp.arange(G), winner]
    return np.asarray(value.mean(axis=0)), np.asarray(faulty)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("G,r", [(1, 5), (2, 3), (1, 3)])
def test_identify_vote_matches_reference(seed, G, r):
    rng = np.random.default_rng(seed)
    d = 777
    honest = rng.standard_normal((G, 1, d)).astype(np.float32)
    reps = np.repeat(honest, r, axis=1)
    n_bad = (r - 1) // 2
    for g in range(G):
        for i in rng.choice(r, size=rng.integers(0, n_bad + 1), replace=False):
            kind = rng.integers(3)
            if kind == 0:
                reps[g, i] *= -5.0                       # sign flip
            elif kind == 1:
                reps[g, i, rng.integers(d)] += 1e-3       # one coordinate
            else:
                reps[g, i] += rng.standard_normal(d).astype(np.float32)
    want_v, want_f = _reference_vote(reps, 1e-5)
    got_v, got_f = steps.vote_leaf(torch.from_numpy(reps), 1e-5)
    assert np.array_equal(got_f.numpy(), want_f)
    assert np.array_equal(got_v.numpy(), want_v)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_opt_update_matches_reference(kind, clip):
    o = dict(kind=kind, peak_lr=0.05, warmup_steps=3, total_steps=20,
             grad_clip=clip)
    jo, to = jopt.OptConfig(**o), opt_mod.OptConfig(**o)
    jp, tp = _grad_tree(4)
    jp = jax.tree.map(jnp.asarray, jp)
    js = jopt.init_opt_state(jo, jp)
    ts = opt_mod.init_opt_state(to, tp)
    for step in range(6):
        jg, tg = _grad_tree(10 + step)
        jp, js, jm = jopt.opt_update(jo, jax.tree.map(jnp.asarray, jg), js,
                                     jp, step)
        tp, ts, tm = opt_mod.opt_update(to, tg, ts, tp, step)
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= 1e-6 * float(jm["lr"])
        assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    _same_tree(tp, jp, atol=1e-6)
    _same_tree(ts, js, atol=1e-6)


def test_lr_schedule_matches_reference():
    o = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    jo, to = jopt.OptConfig(**o), opt_mod.OptConfig(**o)
    for step in range(0, 130, 3):
        want = float(jopt.lr_at(jo, step))
        assert abs(float(opt_mod.lr_at(to, step)) - want) <= 1e-6 * want


def test_opt_update_keeps_the_param_dtype():
    p = {"w": torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16)}
    g = {"w": torch.ones(4, 5)}
    o = opt_mod.OptConfig(kind="adamw")
    s = opt_mod.init_opt_state(o, p)
    p, s, _ = opt_mod.opt_update(o, g, s, p, 0)
    assert p["w"].dtype == torch.bfloat16 and s["mu"]["w"].dtype == \
        torch.float32


def test_compression_matches_reference():
    """Signs bitwise; the per-tensor scale is an f32 mean whose sum runs
    in another order than XLA's, so scales, decompressed values and the
    carried errors hold 1e-6 relative (a few ulps)."""
    jt, tt = _grad_tree(5)
    je = jcomp.init_error_feedback(jt)
    te = comp.init_error_feedback(tt)
    for i in range(3):
        jg, tg = _grad_tree(20 + i)
        jc, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, jg), je)
        tc, te = comp.compress_tree(tg, te)
        # leaves alternate scale, sign (sorted keys) in both trees
        for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
            b = np.asarray(b)
            if a.dtype == torch.int8:
                assert b.dtype == np.int8 and np.array_equal(_np(a), b)
            else:
                assert abs(float(a) - float(b)) <= 1e-6 * float(b)
        for got, want in ((comp.decompress_tree(tc),
                           jcomp.decompress_tree(jc)), (te, je)):
            for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b)
                assert np.abs(_np(a) - b).max() <= 1e-6 * (1 + np.abs(b).max())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 13])
@pytest.mark.parametrize("seed", [0, 7])
def test_data_pipeline_bitwise(step, seed):
    cfg, jc = _cfg("llama3.2-1b"), _jcfg("llama3.2-1b")
    kw = dict(global_batch=16, seq_len=24, step=step, seed=seed)
    got = data.global_batch_for_step(cfg, **kw)
    want = jdata.global_batch_for_step(jc, **kw)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    from repro.core.assignment import check_assignment as jcheck

    a = check_assignment(np.ones(8, bool), 2, np.random.default_rng(seed))
    ja = jcheck(np.ones(8, bool), 2, np.random.default_rng(seed))
    wb, jwb = data.worker_batches(got, a), jdata.worker_batches(want, ja)
    for k in ("tokens", "labels"):
        assert np.array_equal(wb[k], jwb[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_trees(dtype):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype=dtype)
    params = M.init_train(cfg, 0, "cpu")
    o = opt_mod.OptConfig(kind="adamw")
    state = opt_mod.init_opt_state(o, params)
    for i, m in enumerate(tree.leaves(state)):
        m.add_(float(i))
    return params, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_and_layout(dtype, tmp_path):
    params, state = _state_trees(dtype)
    ps = ProtocolState.create(BFTConfig(n=8, f=2, seed=3))
    ps.on_identified(np.array([4]))
    ps.step = 9
    ckpt.save(str(tmp_path / "port"), 9, params=params, opt_state=state,
              protocol_state=ps, extra={"last_loss": 2.5})
    assert ckpt.latest_step(str(tmp_path / "port")) == 9
    # the reference writes the same files for the same trees
    def to_jax(t):
        return np.asarray(jnp.asarray(t.float().numpy(), t.dtype == torch.bfloat16
                                      and jnp.bfloat16 or jnp.float32))

    jparams = M.map_params(to_jax, params)
    jstate = M.map_params(to_jax, state)
    jckpt.save(str(tmp_path / "ref"), 9, params=jparams, opt_state=jstate)
    with open(tmp_path / "port" / "step_00000009" / "manifest.json") as fh:
        got = json.load(fh)
    with open(tmp_path / "ref" / "step_00000009" / "manifest.json") as fh:
        want = json.load(fh)
    assert got == want
    for group in ("params", "opt_state"):
        for e in want["arrays"][group]:
            a = np.load(tmp_path / "port" / "step_00000009" / group / e["file"])
            b = np.load(tmp_path / "ref" / "step_00000009" / group / e["file"])
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port restores the reference's checkpoint, and its own
    ps2 = ProtocolState.create(BFTConfig(n=8, f=2, seed=3))
    for d in ("port", "ref"):
        p2, s2, extra = ckpt.restore(str(tmp_path / d), 9,
                                     params_template=params,
                                     opt_template=state,
                                     protocol_state=ps2 if d == "port"
                                     else None)
        for a, b in zip(tree.leaves(p2) + tree.leaves(s2),
                        tree.leaves(params) + tree.leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert extra == {} and ps2.step == 9 and ps2.identified[4]
    assert ps2.rng.random() == ps.rng.random()


def test_checkpoint_manager_keeps_the_last(tmp_path):
    params, state = _state_trees("float32")
    mgr = ckpt.CheckpointManager(str(tmp_path), every=2, keep=2)
    for step in range(1, 9):
        mgr.maybe_save(step, params=params, opt_state=state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000008"]
    assert ckpt.latest_step(str(tmp_path)) == 8
    assert ckpt.latest_step(str(tmp_path / "none")) is None
