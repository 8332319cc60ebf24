"""The MoE decoders (phi3.5-moe, llama4-maverick) and the hybrid
(jamba) against the JAX package, on the CPU.

Each at ``reduced()`` size in f32 (phi3.5-moe: 2 layers, 4 experts
top-2; llama4-maverick: 4 layers, MoE with a shared expert on the odd
ones, top-1; jamba: 16 layers, attention at 4 and 12, mamba elsewhere,
MoE on the odd layers), the reference's parameters
(``repro.models.model.init(cfg, PRNGKey(0))``) carried over with
``convert``, prompts from a numpy seed.  Held:

  * ``forward``'s logits within 1e-4 (1 + max|.|) and its aux within
    1e-5 relative; ``prefill``'s last logits and k/v, and three decode
    steps' logits and whole cache (jamba's mamba part included), within
    1e-4 (1 + max|.|);
  * ``train_loss`` (CE + 0.01 aux) and its gradients against
    ``jax.value_and_grad``: loss and aux within 1e-5, gradients within
    1e-4 (1 + max|g|); the stacked tree's leaf paths and order equal
    the reference's, ``convert`` carries every leaf and
    ``stack_layers`` inverts ``layer_views``;
  * jamba's cache: k/v for its attention layers, the mamba part for
    the others, in the reference's shapes and dtypes;
  * ``ServeEngine.generate`` at q_audit 0 and 0.5 against the
    reference's engine for phi3.5-moe and jamba: greedy tokens under
    the margin rule (``serving.token_agreement``), each step's logits
    while the tokens agree within 1e-4 (1 + max|.|), the same audits and
    no failure; a tampered replica is caught;
  * ``python -m repro_torch.launch.train`` on reduced phi3.5-moe.
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
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core import detection as tdet
from repro_torch.core import tree
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServeEngine, token_agreement
from repro_torch.serving.engine import sketches_agree
from torch_threads import one_thread  # noqa: F401 (one thread)

PHI, LLAMA4, JAMBA = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
                      "jamba-v0.1-52b")
ARCHS = [PHI, LLAMA4, JAMBA]
B, S, STEPS = 2, 32, 6             # jamba's prompt is two SSD chunks


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _jcfg(name):
    return dataclasses.replace(jget_config(name).reduced(), dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _tol(x, rel=1e-4) -> float:
    return rel * (1.0 + float(np.abs(_np(x)).max()))


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_tol(want, rel))


def _paths(t):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(the reference's params, its numpy tree, the port's, a prompt)."""
    jparams = JM.init(_jcfg(name), jax.random.PRNGKey(0))
    jnp_tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.from_jax_params(_cfg(name), jnp_tree, device="cpu")
    prompt = np.random.default_rng(7).integers(
        0, _cfg(name).vocab_size, size=(B, S), dtype=np.int32)
    return jparams, jnp_tree, tparams, prompt


def _jzero_cache(name, length):
    return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                        JM.abstract_cache(_jcfg(name), B, length),
                        is_leaf=lambda x: hasattr(x, "logical"))


@functools.lru_cache(maxsize=None)
def _jdecode(name):
    """The reference's decode step, compiled once a model."""
    jc = _jcfg(name)
    return jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, jc))


@functools.lru_cache(maxsize=None)
def _jprefill(name):
    """The reference's prefill of the prompt: (last logits, cache)."""
    jparams, _, _, prompt = _setup(name)
    return JM.prefill(jparams, {"tokens": jnp.asarray(prompt)}, _jcfg(name),
                      cache_len=S + STEPS)


@pytest.mark.parametrize("name", ARCHS)
def test_require_ported_admits_moe_and_hybrid(name):
    tfm.require_ported(get_config(name))
    tfm.require_ported(get_config(name).reduced())


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_decode_match_reference(name):
    jparams, _, tparams, prompt = _setup(name)
    jc, tc = _jcfg(name), _cfg(name)
    want, _, jaux = JM.forward(jparams, {"tokens": jnp.asarray(prompt)}, jc)
    got, _, aux = M.forward(tparams, {"tokens": prompt}, tc)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))

    jl, jcache = _jprefill(name)
    tl, tcache = M.prefill(tparams, {"tokens": prompt}, tc,
                           cache_len=S + STEPS)
    _close(tl, jl)
    assert set(jcache) == {"k", "v"} and set(tcache) == (
        {"k", "v", "mamba"} if name == JAMBA else {"k", "v"})
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])
    if name == JAMBA:               # the reference's prefill leaves it 0
        assert all(bool((t == 0).all()) for t in
                   tree.leaves(tcache["mamba"]))

    # decode from a zero cache, as the engine's replay does for jamba
    jcache = _jzero_cache(name, S + STEPS)
    tcache = M.allocate_cache(tc, B, S + STEPS, "cpu")
    for t in range(3):
        jlg, jcache = _jdecode(name)(jparams, jnp.asarray(prompt[:, t]),
                                     jnp.int32(t), jcache)
        tlg, tcache = M.decode_step(tparams, prompt[:, t], t, tcache, tc)
        _close(tlg, jlg)
        assert _paths(jcache) == [p for p, _ in
                                  tree.leaves_with_paths(tcache)]
        for a, b in zip(tree.leaves(tcache), jax.tree.leaves(jcache)):
            _close(a, b)


def test_jamba_cache_layout():
    """k/v (L_attn, B, len, K*hd) for its 2 attention layers, the mamba
    part for its 14 mamba layers, as ``abstract_cache`` has them."""
    tc, jc = _cfg(JAMBA), _jcfg(JAMBA)
    assert tfm.attn_layer_indices(tc) == [4, 12]
    assert len(tfm.mamba_layer_indices(tc)) == 14
    want = jax.tree_util.tree_flatten_with_path(
        JM.abstract_cache(jc, B, 40),
        is_leaf=lambda x: hasattr(x, "logical"))[0]
    got = tree.leaves_with_paths(M.allocate_cache(tc, B, 40, "cpu"))
    assert [p for p, _ in got] == [
        "/".join(k.key for k in path) for path, _ in want]
    for (_, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == tuple(a.shape)
        assert str(t.dtype).removeprefix("torch.") == np.dtype(a.dtype).name


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_reference(name):
    cfg, jc = _cfg(name), _jcfg(name)
    _, jp, tparams, _ = _setup(name)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(tp)] == _paths(jp)
    assert [p for p, _ in tree.leaves_with_paths(
        M.init_train(cfg, 0, "cpu"))] == _paths(jp)
    # the per-layer tree is the stacked one's views
    for a, b in zip(tree.leaves(M.stack_layers(tparams, cfg)),
                    tree.leaves(tp)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, S), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (3, S), np.int32)}
    batch["labels"][0, :5] = -100
    (jl, jm), jg = jax.value_and_grad(JM.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    req = [p.requires_grad_() for p in tree.leaves(tp)]
    tl, tm = M.train_loss(tp, batch, cfg)
    tg = torch.autograd.grad(tl, req)
    assert float(jm["moe_aux"]) > 0.5
    assert abs(float(tm["moe_aux"].detach()) - float(jm["moe_aux"])) <= \
        1e-5 * float(jm["moe_aux"])
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= 1e-5
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert abs(float(tl.detach()) - float(tm["ce"]) - M.MOE_AUX_COEF *
               float(tm["moe_aux"])) <= 1e-6
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * (1 + np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _jax_greedy(name):
    """The reference's greedy run, step by step as its engine runs it:
    (tokens (B, STEPS), [logits (B, V)] per step)."""
    jparams, _, _, prompt = _setup(name)
    dec = _jdecode(name)
    logits, pre = _jprefill(name)
    cache = _jzero_cache(name, S + STEPS)
    cache["k"], cache["v"] = pre["k"], pre["v"]
    if "mamba" in cache:
        for t in range(S):
            logits, cache = dec(jparams, jnp.asarray(prompt[:, t]),
                                jnp.int32(t), cache)
    toks, lgs = [], []
    for i in range(STEPS):
        lgs.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = dec(jparams, tok, jnp.int32(S + i), cache)
    return np.stack(toks, axis=1), lgs


@pytest.mark.parametrize("q_audit", [0.0, 0.5])
@pytest.mark.parametrize("name", [PHI, JAMBA])
def test_generate_matches_reference(name, q_audit, monkeypatch):
    jparams, _, tparams, prompt = _setup(name)
    ref_tokens, ref_logits = _jax_greedy(name)
    if q_audit == 0.0:     # the reference's engine, once a model
        jeng = JServeEngine(_jcfg(name), jparams, q_audit=0.0, seed=0)
        np.testing.assert_array_equal(
            np.asarray(jeng.generate(jnp.asarray(prompt), STEPS)),
            ref_tokens)
    calls = []
    step = M.decode_step
    monkeypatch.setattr(M, "decode_step",
                        lambda *a: calls.append(a[2]) or step(*a))
    eng = ServeEngine(_cfg(name), tparams, q_audit=q_audit, seed=0,
                      device="cpu", record_logits=True)
    got = eng.generate(prompt, STEPS)
    want_audits = int((np.random.default_rng(0).random(STEPS)
                       < q_audit).sum())
    assert got.shape == (B, STEPS)
    assert (eng.audits, eng.audit_failures) == (want_audits, 0)
    assert (want_audits > 0) == (q_audit > 0)
    # phi3.5-moe: prefill k/v, no replay; jamba: the prompt replayed
    replay = list(range(S)) if name == JAMBA else []
    assert calls[:len(replay)] == replay
    assert len(calls) == len(replay) + STEPS + want_audits
    tol = _tol(np.stack(ref_logits))
    compared, agreed = token_agreement(ref_logits, ref_tokens, got, tol)
    assert compared >= B and agreed == compared, (compared, agreed)
    for i in range(STEPS):         # logits too, while the tokens agree
        if not np.array_equal(_np(got[:, :i]), ref_tokens[:, :i]):
            break
        np.testing.assert_allclose(_np(eng.logits[i]), ref_logits[i],
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("name", [PHI, JAMBA])
def test_tampered_replica_is_caught(name):
    """Final-norm scale[0] x 3: the audit sketch of its decode logits
    differs from the honest replica's, which a rerun matches."""
    _, _, tparams, prompt = _setup(name)
    tc = _cfg(name)
    scale = tparams["final_norm"]["scale"].clone()
    scale[0] *= 3.0
    bad = dict(tparams, final_norm={"scale": scale})
    ks = tdet.key_scalar_for_seed(7)

    def sketch_of(p):
        lg, _ = M.decode_step(p, prompt[:, 0], 0,
                              M.allocate_cache(tc, B, 16, "cpu"), tc)
        return tdet.hash_sign_sketch(lg.reshape(-1), ks, 256)

    honest = sketch_of(tparams)
    assert not sketches_agree(honest, sketch_of(bad))
    assert sketches_agree(honest, sketch_of(tparams))


def test_launch_train_runs_phi_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b
    --reduced --device cpu``."""
    from repro_torch.launch import train as launch

    launch.main(["--arch", PHI, "--reduced", "--device", "cpu", "--steps",
                 "2", "--seq-len", "16", "--global-batch", "16", "--f", "2",
                 "--byz", "2,5", "--q", "0.5"])
    out = capsys.readouterr().out
    assert "[launch] done: loss=" in out and "phi3.5-moe-42b-a6.6b-smoke" \
        in out
