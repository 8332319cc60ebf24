"""The port's dense models and audited serving against the JAX package,
on the CPU.

llama3.2-1b, gemma3-1b (local/global layers, qk-norm, one kv head) and
qwen3-4b (qk-norm) at ``reduced()`` size in f32.  The reference's
parameters (``repro.models.model.init(cfg, PRNGKey(0))``) are carried
over with ``from_jax_params``; prompts come from a numpy seed.  Logits
and caches must agree within 1e-4 (1 + max|.|); greedy tokens are
compared under the margin rule (``serving.token_agreement``): step by
step until the reference's top-2 margin is within that tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs.base import layer_groups as jlayer_groups
from repro.core import detection as jdet
from repro.models import model as JM
from repro.serving import ServeEngine as JServeEngine
from repro.serving import engine as jengine
from repro_torch.configs import get_config, layer_groups, layer_kinds
from repro_torch.configs import list_configs
from repro_torch.core import detection as tdet
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.serving import ServeEngine, audit_decode, token_agreement
from torch_threads import one_thread  # noqa: F401 (one thread)

ARCHS = ["llama3.2-1b", "gemma3-1b", "qwen3-4b"]
B, S, STEPS = 2, 40, 8            # S is past the reduced window of 32


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _jcfg(name):
    return dataclasses.replace(jget_config(name).reduced(), dtype="float32")


def _tol(x) -> float:
    return 1e-4 * (1.0 + float(np.abs(np.asarray(x)).max()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX params, port params on the CPU, prompt) for one arch; built
    once per module, as the JAX side dominates the file's time."""
    jparams = JM.init(_jcfg(name), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.from_jax_params(_cfg(name), tree, device="cpu")
    prompt = np.random.default_rng(7).integers(
        0, _cfg(name).vocab_size, size=(B, S), dtype=np.int32)
    return jparams, tparams, prompt


@functools.lru_cache(maxsize=None)
def _jax_greedy(name):
    """The reference's greedy run with its per-step logits: (tokens
    (B, STEPS), [logits (B, V)] per step), from its prefill and decode."""
    jparams, _, prompt = _setup(name)
    cfg = _jcfg(name)
    pre = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, cfg,
                                          cache_len=S + STEPS))
    dec = jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, cfg))
    logits, cache = pre(jparams, jnp.asarray(prompt))
    toks, lgs = [], []
    for i in range(STEPS):
        lgs.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = dec(jparams, tok, jnp.int32(S + i), cache)
    return np.stack(toks, axis=1), lgs


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    jparams, _, prompt = _setup(name)
    eng = JServeEngine(_jcfg(name), jparams, q_audit=0.5, seed=0)
    out = eng.generate(jnp.asarray(prompt), STEPS)
    return np.asarray(out), eng.audits, eng.audit_failures


def test_configs_equal_reference():
    assert list_configs() == jlist_configs()
    for name in list_configs():
        for c, jc in ((get_config(name), jget_config(name)),
                      (get_config(name).reduced(),
                       jget_config(name).reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(jc), name
            assert [g.repeats for g in layer_groups(c)] == \
                [g.repeats for g in jlayer_groups(jc)]
            assert [[k.tag for k in g.pattern] for g in layer_groups(c)] == \
                [[k.tag for k in g.pattern] for g in jlayer_groups(jc)]


@pytest.mark.parametrize("name", ARCHS)
def test_converter_keeps_layer_order(name):
    """Layer i of the port is the reference's ``_layer_param(i)`` (the
    repeat-major interleave of stacked groups; gemma3's 6-layer pattern
    x 2 catches a wrong one)."""
    jparams, tparams, _ = _setup(name)
    jc = _jcfg(name)
    for i in range(jc.num_layers):
        want = JM._layer_param(jparams["decoder"], jlayer_groups(jc), i)
        got = tparams["layers"][i]
        for part in want:
            for leaf, w in want[part].items():
                np.testing.assert_array_equal(_np(got[part][leaf]),
                                              np.asarray(w))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    jparams, tparams, prompt = _setup(name)
    want, _, _ = JM.forward(jparams, {"tokens": jnp.asarray(prompt)},
                            _jcfg(name))
    got, _, _ = M.forward(tparams, {"tokens": prompt}, _cfg(name))
    assert got.shape == (B, S, _cfg(name).vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=_tol(want))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """Last-token logits and the whole cache after prefill, then three
    decode steps (logits and cache after each)."""
    jparams, tparams, prompt = _setup(name)
    jc, tc = _jcfg(name), _cfg(name)
    jl, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jc,
                            cache_len=S + 3)
    tl, tcache = M.prefill(tparams, {"tokens": prompt}, tc, cache_len=S + 3)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=_tol(jl))
    for n in ("k", "v"):
        assert tuple(tcache[n].shape) == tuple(jcache[n].shape)
        np.testing.assert_allclose(_np(tcache[n]), _np(jcache[n]), rtol=0,
                                   atol=_tol(jcache[n]))
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for i in range(3):
        jl, jcache = JM.decode_step(jparams, jnp.asarray(tok),
                                    jnp.int32(S + i), jcache, jc)
        tl, tcache = M.decode_step(tparams, tok, S + i, tcache, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=_tol(jl))
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[n]), _np(jcache[n]),
                                       rtol=0, atol=_tol(jcache[n]))
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name):
    """ServeEngine.generate at q_audit 0.5: greedy tokens equal under the
    margin rule, the same audits (same coin stream) and no failures."""
    _, tparams, prompt = _setup(name)
    want, audits, failures = _jax_engine(name)
    ref_tokens, ref_logits = _jax_greedy(name)
    np.testing.assert_array_equal(ref_tokens, want)
    eng = ServeEngine(_cfg(name), tparams, q_audit=0.5, seed=0, device="cpu",
                      record_logits=True)
    got = eng.generate(prompt, STEPS)
    assert got.shape == (B, STEPS)
    assert (eng.audits, eng.audit_failures) == (audits, failures)
    assert audits == int((np.random.default_rng(0).random(STEPS) < 0.5).sum())
    assert failures == 0
    tol = _tol(np.stack(ref_logits))
    compared, agreed = token_agreement(ref_logits, want, got, tol)
    assert compared >= B and agreed == compared, (compared, agreed)
    for i in range(STEPS):         # logits too, while the tokens agree
        if not np.array_equal(_np(got[:, :i]), want[:, :i]):
            break
        np.testing.assert_allclose(_np(eng.logits[i]), ref_logits[i], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("name", ["llama3.2-1b", "gemma3-1b"])
def test_audit_decode_matches_reference(name):
    """Flag, logits and the logit sketches of one audited step; the
    port's in-place cache write leaves the replay the same cache."""
    jparams, tparams, prompt = _setup(name)
    jc, tc = _jcfg(name), _cfg(name)
    jl, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jc,
                            cache_len=S + 1)
    _, tcache = M.prefill(tparams, {"tokens": prompt}, tc, cache_len=S + 1)
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jlog, jnew, jok = jengine.audit_decode(
        jparams, jnp.asarray(tok), jnp.int32(S), jcache, jc,
        key=jax.random.PRNGKey(1003))
    before = {n: tcache[n].clone() for n in tcache}
    tlog, tnew, tok_flag = audit_decode(tparams, tok, S, tcache, tc, key=1003)
    assert bool(jok) and tok_flag is True
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=_tol(jlog))
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tnew[n]), _np(jnew[n]), rtol=0,
                                   atol=_tol(jnew[n]))
        # only position S was written
        assert torch.equal(tnew[n][:, :, :S], before[n][:, :, :S])
    # a third run on the audited cache gives the audited logits bitwise
    again, _ = M.decode_step(tparams, tok, S, tnew, tc)
    assert torch.equal(again, tlog)
    ks = jdet.key_scalar_for_step(jax.random.PRNGKey(1003))
    assert int(ks) == tdet.key_scalar_for_seed(1003)
    js = jdet.hash_sign_sketch(jlog.reshape(-1), ks, 256)
    ts = tdet.hash_sign_sketch(tlog.reshape(-1), int(ks), 256)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=1e-5)


def test_tampered_replica_is_caught():
    """examples/serve_audit.py's Byzantine replica (final-norm scale[0]
    x 3): both packages' sketches of its logits differ from the honest
    replica's."""
    name = "llama3.2-1b"
    jparams, tparams, prompt = _setup(name)
    jc, tc = _jcfg(name), _cfg(name)
    tok = prompt[:, 0]
    ks = jdet.key_scalar_for_step(jax.random.PRNGKey(7))
    jbad = jax.tree.map(lambda x: x, jparams)
    jbad["final_norm"]["scale"] = jbad["final_norm"]["scale"].at[0].multiply(
        3.0)
    tbad = dict(tparams, final_norm={"scale": tparams["final_norm"]["scale"]
                                     * torch.tensor([3.0] + [1.0] * (
                                         tc.d_model - 1))})

    def jsk(p):
        cache = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                             JM.abstract_cache(jc, B, 16),
                             is_leaf=lambda x: hasattr(x, "logical"))
        lg, _ = JM.decode_step(p, jnp.asarray(tok), jnp.int32(0), cache, jc)
        return jdet.hash_sign_sketch(lg.reshape(-1), ks, 256)

    def tsk(p):
        lg, _ = M.decode_step(p, tok, 0, M.allocate_cache(tc, B, 16, "cpu"),
                              tc)
        return tdet.hash_sign_sketch(lg.reshape(-1), int(ks), 256)

    from repro_torch.serving.engine import sketches_agree

    js_ok, js_bad = jsk(jparams), jsk(jbad)
    assert bool((jnp.abs(js_ok - js_bad) > 1e-5 * (1 + jnp.abs(js_ok))).any())
    ts_ok, ts_bad = tsk(tparams), tsk(tbad)
    assert not sketches_agree(ts_ok, ts_bad)
    assert sketches_agree(ts_ok, tsk(tparams))
    np.testing.assert_allclose(_np(ts_bad), _np(js_bad), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [0, 7, 1003, 2**32 - 1, 2**32 + 5, -1])
def test_key_scalar_for_seed_matches_reference(n):
    assert tdet.key_scalar_for_seed(n) == int(
        jdet.key_scalar_for_step(jax.random.PRNGKey(n)))


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_ctx_models_are_accepted(name):
    """The VLM and the encoder-decoder: ``init``, ``allocate_cache`` (with
    its zero cross caches) and ``ServeEngine`` take them; ``forward``
    without ``ctx`` raises ``ValueError`` naming it, with it runs."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = M.init(cfg, 0, device="cpu")
    cache = M.allocate_cache(cfg, 1, 8, "cpu")
    T = cfg.num_encoder_positions if cfg.is_encoder_decoder \
        else cfg.num_vision_tokens
    assert tuple(cache["cross_k"].shape)[1:] == (1, T, cfg.num_kv_heads *
                                                 cfg.head_dim)
    ServeEngine(cfg, params, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="ctx"):
        M.forward(params, {"tokens": tokens}, cfg)
    ctx = np.zeros((1, T, cfg.d_model), np.float32)
    logits, _, _ = M.forward(params, {"tokens": tokens, "ctx": ctx}, cfg)
    assert logits.shape == (1, 4, cfg.vocab_size)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg("llama3.2-1b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        M.init(cfg, 0)
    params = M.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.from_jax_params(cfg, M.map_params(lambda t: t.numpy(), {
            "embed": params["embed"], "final_norm": params["final_norm"],
            "decoder": []}))


def test_init_draws_the_reference_distributions():
    """Matrices: truncated normal on +-2 sigma with sigma = 1/sqrt(fan_in)
    (the bound holds exactly, the spread within 3%); norms one."""
    cfg = _cfg("gemma3-1b")
    p = M.init(cfg, 3, device="cpu")
    again = M.init(cfg, 3, device="cpu")
    assert torch.equal(p["layers"][5]["ffn"]["down"],
                       again["layers"][5]["ffn"]["down"])
    for w in (p["embed"]["tokens"], p["layers"][0]["mixer"]["wq"],
              p["layers"][11]["ffn"]["down"]):
        sigma = 1.0 / np.sqrt(w.shape[0])
        assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6)
        # a standard normal cut at +-2 has sd 0.880
        assert abs(float(w.std()) / (0.880 * sigma) - 1.0) < 0.03
    assert bool((p["layers"][3]["mixer"]["q_norm"] == 1).all())
    assert len(p["layers"]) == len(layer_kinds(cfg)) == 12


def test_generate_emits_audit_spans_and_counters(monkeypatch):
    """Reduced llama3.2-1b at q_audit 1.0: one ``serve.audit_decode`` span
    (with its step) and one ``serve.audits`` increment per step, the
    spans the reference's engine emits for the same run; a replica whose
    replay disagrees (its second decode of each step scaled) counts one
    ``serve.audit_failures`` per step."""
    from repro.obs import trace as jtrace
    from repro_torch.obs import metrics as tmetrics
    from repro_torch.obs import trace as ttrace

    name = "llama3.2-1b"
    jparams, tparams, prompt = _setup(name)

    def audit_steps(tracer):
        return [e["args"]["step"] for e in tracer.spans()
                if e["name"] == "serve.audit_decode"]

    def counts():
        return (tmetrics.counter("serve.audits").value,
                tmetrics.counter("serve.audit_failures").value)

    jtrace.clear()
    JServeEngine(_jcfg(name), jparams, q_audit=1.0, seed=0).generate(
        jnp.asarray(prompt), STEPS)
    assert audit_steps(jtrace) == list(range(STEPS))

    ttrace.clear()
    before = counts()
    eng = ServeEngine(_cfg(name), tparams, q_audit=1.0, seed=0, device="cpu")
    honest = eng.generate(prompt, STEPS)
    assert audit_steps(ttrace) == audit_steps(jtrace)
    assert (eng.audits, eng.audit_failures) == (STEPS, 0)
    assert counts() == (before[0] + STEPS, before[1])

    decode, calls = M.decode_step, []

    def replay_disagrees(*args, **kwargs):
        logits, cache = decode(*args, **kwargs)
        calls.append(None)
        return (logits * 1.5 if len(calls) % 2 == 0 else logits), cache

    monkeypatch.setattr(M, "decode_step", replay_disagrees)
    ttrace.clear()
    before = counts()
    bad = ServeEngine(_cfg(name), tparams, q_audit=1.0, seed=0, device="cpu")
    out = bad.generate(prompt, STEPS)
    assert torch.equal(out, honest)          # the first decode is served
    assert len(calls) == 2 * STEPS
    assert audit_steps(ttrace) == list(range(STEPS))
    assert (bad.audits, bad.audit_failures) == (STEPS, STEPS)
    assert counts() == (before[0] + STEPS, before[1] + STEPS)
