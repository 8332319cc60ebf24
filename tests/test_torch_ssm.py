"""The port's Mamba2 layer and the mamba model against the JAX package,
on the CPU.

mamba2-780m at ``reduced()`` size (d_model 64, d_inner 128, 16 heads of
8, d_state 16, chunk 16, 2 layers) in f32.  The reference's parameters
(``repro.models.model.init(cfg, PRNGKey(0))``) are carried over with
``convert``; inputs come from a numpy seed.  Held:

  * ``ssm.mamba`` at T = 32 and 64 (2 and 4 chunks), from a zero and
    from a given initial state, output and final state within
    1e-4 (1 + max|.|);
  * ``ssm.mamba_decode_step`` and its new cache, and the model's
    ``forward``, ``prefill`` and ``decode_step`` with the whole cache,
    within the same tolerance;
  * the port's chunked SSD against its own sequential decode within the
    reference's own 2e-4 (``tests/test_models.py``);
  * ``train_loss`` and its gradients against ``jax.value_and_grad``:
    loss within 1e-5, gradients within 1e-4 (1 + max|g|);
  * a decode step run twice on one cache: bitwise equal, the input
    cache's mamba tensors unchanged;
  * the stacked training tree: the reference's 16 leaves;
  * bf16: one mamba layer against the reference's in bf16 within
    1e-2 (1 + max|.|), about one bf16 ulp at the largest output (read:
    output 8.7e-4 of it, state 5.7e-9, at this seed; at most 8.7e-4 over
    five seeds); the port rounds after every bf16 op, XLA on the CPU
    may keep f32 in the fused conv adds.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.layers import materialize
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from torch_threads import one_thread  # noqa: F401 (one thread)

NAME = "mamba2-780m"
B = 2


def _cfg(dtype="float32"):
    return dataclasses.replace(get_config(NAME).reduced(), dtype=dtype)


def _jcfg(dtype="float32"):
    return dataclasses.replace(jget_config(NAME).reduced(), dtype=dtype)


def _tol(x, rel=1e-4) -> float:
    return rel * (1.0 + float(np.abs(_np(x)).max()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_tol(want, rel))


@functools.lru_cache(maxsize=None)
def _layer(dtype="float32"):
    """One mamba layer's parameters: (JAX tree, port tree)."""
    jp = materialize(jssm.abstract_mamba(_jcfg(dtype)),
                     jax.random.PRNGKey(1))
    return jp, {k: convert.to_tensor(np.asarray(v)) for k, v in jp.items()}


@functools.lru_cache(maxsize=None)
def _model():
    """(JAX params, port params on the CPU)."""
    jp = JM.init(_jcfg(), jax.random.PRNGKey(0))
    return jp, convert.from_jax_params(_cfg(), jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _inputs(T, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, T, _cfg().d_model))).astype(dtype)


def _state(seed=1):
    d_inner, H, G, N = ssm.dims(_cfg())
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(
        (B, H, N, _cfg().ssm.head_dim))).astype(np.float32)


def _zero_jcache(T):
    return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                        JM.abstract_cache(_jcfg(), B, T),
                        is_leaf=lambda x: hasattr(x, "logical"))


@pytest.mark.parametrize("T", [32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_matches_reference(T, with_state):
    jp, tp = _layer()
    x = _inputs(T)
    s0 = _state() if with_state else None
    jy, jS = jssm.mamba(jp, jnp.asarray(x), _jcfg(),
                        initial_state=None if s0 is None else jnp.asarray(s0),
                        return_state=True)
    ty, tS = ssm.mamba(tp, torch.from_numpy(x), _cfg(),
                       initial_state=None if s0 is None
                       else torch.from_numpy(s0), return_state=True)
    assert ty.shape == (B, T, _cfg().d_model) and ty.dtype == torch.float32
    assert tS.shape == jS.shape and tS.dtype == torch.float32
    _close(ty, jy)
    _close(tS, jS)
    # return_state=False gives the same output alone
    assert torch.equal(ssm.mamba(tp, torch.from_numpy(x), _cfg(),
                                 initial_state=None if s0 is None
                                 else torch.from_numpy(s0)), ty)


def test_mamba_rejects_a_ragged_sequence():
    _, tp = _layer()
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.mamba(tp, torch.from_numpy(_inputs(24)), _cfg())


def test_mamba_decode_step_matches_reference():
    """Five tokens from a random cache: output and every cache tensor."""
    jp, tp = _layer()
    cfg, jc = _cfg(), _jcfg()
    d_inner, H, G, N = ssm.dims(cfg)
    rng = np.random.default_rng(3)
    W = cfg.ssm.d_conv - 1
    cache = {"state": _state(2),
             "conv_x": rng.standard_normal((B, W, d_inner)),
             "conv_B": rng.standard_normal((B, W, G * N)),
             "conv_C": rng.standard_normal((B, W, G * N))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    x = _inputs(5, seed=4)
    for t in range(5):
        jy, jcache = jssm.mamba_decode_step(jp, jnp.asarray(x[:, t]), jcache,
                                            jc)
        ty, tcache = ssm.mamba_decode_step(tp, torch.from_numpy(x[:, t]),
                                           tcache, cfg)
        _close(ty, jy)
        for k in jcache:
            assert tcache[k].shape == jcache[k].shape
            _close(tcache[k], jcache[k])


@pytest.mark.parametrize("T", [32, 64])
def test_chunked_equals_sequential(T):
    """The port's SSD against its own decode run token by token, within
    the reference's 2e-4 (``tests/test_models.py``)."""
    _, tp = _layer()
    cfg = _cfg()
    x = torch.from_numpy(_inputs(T, seed=5)) * 0.6
    y = ssm.mamba(tp, x, cfg)
    cache = {k: v[0] for k, v in
             ssm.allocate_mamba_cache(cfg, B, 1, "cpu").items()}
    outs = []
    for t in range(T):
        o, cache = ssm.mamba_decode_step(tp, x[:, t], cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(_np(y), _np(torch.stack(outs, 1)), rtol=2e-4,
                               atol=2e-4)


def test_forward_prefill_and_decode_match_reference():
    """The model's logits, then the prompt replayed through decode_step
    from the zero cache (the reference's serving replay) and three more
    steps: logits and the whole mamba cache after each."""
    jp, tp = _model()
    jc, tc = _jcfg(), _cfg()
    T = 32
    prompt = np.random.default_rng(6).integers(0, tc.vocab_size, (B, T),
                                               dtype=np.int32)
    jl, _, _ = JM.forward(jp, {"tokens": jnp.asarray(prompt)}, jc)
    tl, kv, _ = M.forward(tp, {"tokens": prompt}, tc)
    assert kv == [] and tl.shape == (B, T, tc.vocab_size)
    _close(tl, jl)
    pl, cache = M.prefill(tp, {"tokens": prompt}, tc, cache_len=T + 3)
    _close(pl, jl[:, -1])
    assert set(cache) == {"mamba"}            # no k/v: attention-free
    assert all(not bool(t.any()) for t in cache["mamba"].values())
    jcache = _zero_jcache(T + 3)
    for name, t in cache["mamba"].items():
        assert t.shape == jcache["mamba"][name].shape
        assert _np(t).dtype == np.float32
    dec = jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, jc))
    for i in range(T + 3):
        tok = (prompt[:, i] if i < T
               else np.array(jnp.argmax(jl, -1), np.int32))
        jl, jcache = dec(jp, jnp.asarray(tok), jnp.int32(i), jcache)
        tl, cache = M.decode_step(tp, tok, i, cache, tc)
        if i >= T - 1:
            _close(tl, jl)
            for name, t in cache["mamba"].items():
                _close(t, jcache["mamba"][name])


def test_decode_twice_is_bitwise_and_keeps_its_input():
    """The audit replays a step on the same cache: the mamba part of the
    cache is functional, so the replay starts from the same state."""
    _, tp = _model()
    tc = _cfg()
    prompt = np.random.default_rng(8).integers(0, tc.vocab_size, (B, 6))
    cache = M.allocate_cache(tc, B, 8, "cpu")
    for t in range(5):
        _, cache = M.decode_step(tp, prompt[:, t], t, cache, tc)
    before = {k: v.clone() for k, v in cache["mamba"].items()}
    l1, c1 = M.decode_step(tp, prompt[:, 5], 5, cache, tc)
    l2, c2 = M.decode_step(tp, prompt[:, 5], 5, cache, tc)
    assert torch.equal(l1, l2)
    for k in before:
        assert torch.equal(cache["mamba"][k], before[k])
        assert torch.equal(c1["mamba"][k], c2["mamba"][k])
        assert not torch.equal(c1["mamba"][k], before[k])


def test_train_loss_and_grads_match_reference():
    cfg, jc = _cfg(), _jcfg()
    jp = jax.tree.map(np.asarray, _model()[0])
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(tp)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    rng = np.random.default_rng(1)
    T = 32
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, T), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (3, T), np.int32)}
    batch["labels"][0, :5] = -100
    (jl, _), jg = jax.value_and_grad(JM.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    req = [p.requires_grad_() for p in tree.leaves(tp)]
    tl, taux = M.train_loss(tp, batch, cfg)
    tg = torch.autograd.grad(tl, req)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(taux["moe_aux"]) == 0.0
    for a, b in zip(tg, jax.tree.leaves(jg)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=_tol(b))


def test_train_tree_has_the_references_sixteen_leaves():
    """Full width: the reference's abstract tree has 16 leaves; the port's
    stacked tree (reduced) has the same paths, shapes by layer count
    aside, and dtypes; layer_views inverts stack_layers."""
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(
                  JM.abstract_params(jget_config(NAME)),
                  is_leaf=lambda x: hasattr(x, "logical"))[0]]
    assert len(jpaths) == 16
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype="bfloat16")
    small = M.init_train(cfg, 0, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(small)] == jpaths
    want = jax.tree.leaves(JM.abstract_params(jget_config(NAME).reduced()),
                           is_leaf=lambda x: hasattr(x, "logical"))
    for got, w in zip(tree.leaves(small), want):
        assert tuple(got.shape) == tuple(w.shape)
        assert str(got.dtype).removeprefix("torch.") == \
            jnp.dtype(w.dtype).name
    per_layer = M.init(cfg, 3, "cpu")
    back = M.layer_views(M.stack_layers(per_layer, cfg), cfg)
    for a, b in zip(tree.leaves(back), tree.leaves(per_layer)):
        assert torch.equal(a, b)
    assert tfm.mamba_layer_indices(cfg) == [0, 1]
    assert tfm.attn_layer_indices(cfg) == []


def test_init_draws_the_reference_distributions():
    """A_log = log U(1, 16), softplus(dt_bias) in (1e-3, 1e-1), D ones
    (all f32); conv weights truncated normal with sigma 1/sqrt(d_conv) =
    0.5, the projections 1/sqrt(d_model); the norm ones."""
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype="bfloat16",
                              num_layers=16)
    p = M.init(cfg, 3, device="cpu")
    assert torch.equal(p["layers"][4]["mixer"]["in_x"],
                       M.init(cfg, 3, device="cpu")["layers"][4]["mixer"][
                           "in_x"])
    mix = [layer["mixer"] for layer in p["layers"]]
    a_log = torch.cat([m["A_log"] for m in mix])
    dt = torch.nn.functional.softplus(torch.cat([m["dt_bias"] for m in mix]))
    assert a_log.dtype == dt.dtype == torch.float32
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert 0.3 < float(torch.exp(a_log).std()) / (15 / np.sqrt(12)) < 1.7
    for m in mix:
        assert bool((m["D"] == 1).all()) and m["D"].dtype == torch.float32
        assert bool((m["norm"] == 1).all()) and m["norm"].dtype == \
            torch.bfloat16
    conv = torch.cat([m["conv_x"].float().ravel() for m in mix])
    assert float(conv.abs().max()) <= 2 * 0.5 * (1 + 1e-2)
    assert abs(float(conv.std()) / (0.880 * 0.5) - 1.0) < 0.03
    w = torch.cat([m["in_z"].float().ravel() for m in mix])
    sigma = 1.0 / np.sqrt(cfg.d_model)
    assert abs(float(w.std()) / (0.880 * sigma) - 1.0) < 0.03


def test_bf16_layer_matches_reference():
    """One mamba layer in bf16: output and state within 1e-2 (1 + max|.|)
    of the reference's (read: 8.7e-4 and 5.7e-9 of 1 + max|.|)."""
    jp, tp = _layer("bfloat16")
    x = _inputs(32, seed=9)
    jy, jS = jssm.mamba(jp, jnp.asarray(x, jnp.bfloat16), _jcfg("bfloat16"),
                        return_state=True)
    ty, tS = ssm.mamba(tp, torch.from_numpy(x).to(torch.bfloat16),
                       _cfg("bfloat16"), return_state=True)
    assert ty.dtype == torch.bfloat16 and tS.dtype == torch.float32
    _close(ty, jy, 1e-2)
    _close(tS, jS, 1e-2)


def test_launch_train_runs_mamba_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-780m`` on the
    CPU (reduced): checkpoints in the reference's layout and a restart
    that resumes from the last one."""
    from repro_torch.launch import train as launch

    args = ["--arch", NAME, "--reduced", "--device", "cpu", "--seq-len",
            "32", "--global-batch", "16", "--f", "2", "--byz", "2,5", "--q",
            "0.5", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "[launch] done: loss=" in out and "mamba2-780m-smoke" in out
    launch.main(args + ["--steps", "3", "--restore"])
    out = capsys.readouterr().out
    assert "[launch] restored step 2" in out and "[launch] done" in out
