"""Audited serving of mamba2-780m against the JAX package, on the CPU.

mamba2-780m at ``reduced()`` size in f32, the reference's parameters
carried over with ``convert.from_jax_params``, prompts from a numpy
seed.  ``ServeEngine.generate`` runs the chunked prefill, then replays
the prompt through ``decode_step`` from a zero cache to fill the mamba
state (the reference's own replay), then decodes greedily with audits.
Held against the reference's ``ServeEngine`` and its prefill / decode
functions: greedy tokens under the margin rule
(``serving.token_agreement``), each step's logits within
1e-4 (1 + max|.|) while the tokens agree, the same audits (the same
coin stream) and no failure; the first token is the argmax of the full
forward's last position; the audit's replay sees the cache the first
run saw; a tampered replica is caught.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.core import detection as jdet
from repro.models import model as JM
from repro.serving import ServeEngine as JServeEngine
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.core import detection as tdet
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import ServeEngine, audit_decode, token_agreement
from repro_torch.serving.engine import sketches_agree
from torch_threads import one_thread  # noqa: F401 (one thread)

NAME = "mamba2-780m"
B, S, STEPS = 2, 32, 8             # a two-chunk prompt


def _cfg():
    return dataclasses.replace(get_config(NAME).reduced(), dtype="float32")


def _jcfg():
    return dataclasses.replace(jget_config(NAME).reduced(), dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _tol(x) -> float:
    return 1e-4 * (1.0 + float(np.abs(_np(x)).max()))


@functools.lru_cache(maxsize=None)
def _setup():
    jparams = JM.init(_jcfg(), jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(
        _cfg(), jax.tree.map(np.asarray, jparams), device="cpu")
    prompt = np.random.default_rng(7).integers(
        0, _cfg().vocab_size, size=(B, S), dtype=np.int32)
    return jparams, tparams, prompt


@functools.lru_cache(maxsize=None)
def _jax_greedy():
    """The reference's greedy run, step by step as its engine runs it
    (prefill, the prompt replayed through decode from the zero cache,
    then decode): (tokens (B, STEPS), [logits (B, V)] per step)."""
    jparams, _, prompt = _setup()
    cfg = _jcfg()
    dec = jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, cfg))
    cache = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                         JM.abstract_cache(cfg, B, S + STEPS),
                         is_leaf=lambda x: hasattr(x, "logical"))
    for t in range(S):
        logits, cache = dec(jparams, jnp.asarray(prompt[:, t]), jnp.int32(t),
                            cache)
    toks, lgs = [], []
    for i in range(STEPS):
        lgs.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = dec(jparams, tok, jnp.int32(S + i), cache)
    return np.stack(toks, axis=1), lgs


@functools.lru_cache(maxsize=None)
def _jax_engine(q_audit):
    jparams, _, prompt = _setup()
    eng = JServeEngine(_jcfg(), jparams, q_audit=q_audit, seed=0)
    out = eng.generate(jnp.asarray(prompt), STEPS)
    return np.asarray(out), eng.audits, eng.audit_failures


@pytest.mark.parametrize("q_audit", [0.0, 0.5])
def test_generate_matches_reference(q_audit):
    _, tparams, prompt = _setup()
    want, audits, failures = _jax_engine(q_audit)
    ref_tokens, ref_logits = _jax_greedy()
    np.testing.assert_array_equal(ref_tokens, want)
    eng = ServeEngine(_cfg(), tparams, q_audit=q_audit, seed=0,
                      device="cpu", record_logits=True)
    got = eng.generate(prompt, STEPS)
    assert got.shape == (B, STEPS)
    assert (eng.audits, eng.audit_failures) == (audits, failures)
    assert audits == int((np.random.default_rng(0).random(STEPS)
                          < q_audit).sum())
    assert failures == 0 and (audits > 0) == (q_audit > 0)
    assert set(eng.phase_s) == {"prefill", "replay", "decode", "audit"}
    assert all(v >= 0 for v in eng.phase_s.values())
    tol = _tol(np.stack(ref_logits))
    compared, agreed = token_agreement(ref_logits, want, got, tol)
    assert compared >= B and agreed == compared, (compared, agreed)
    for i in range(STEPS):         # logits too, while the tokens agree
        if not np.array_equal(_np(got[:, :i]), want[:, :i]):
            break
        np.testing.assert_allclose(_np(eng.logits[i]), ref_logits[i], rtol=0,
                                   atol=tol)


def test_first_token_is_the_full_forwards_argmax():
    """The replay's last logits against the chunked forward's last
    position (tests/test_serving.py holds the reference to the same)."""
    jparams, tparams, prompt = _setup()
    full, _, _ = JM.forward(jparams, {"tokens": jnp.asarray(prompt)},
                            _jcfg())
    eng = ServeEngine(_cfg(), tparams, device="cpu", record_logits=True)
    out = eng.generate(prompt, 1)
    np.testing.assert_array_equal(_np(out[:, 0]),
                                  np.asarray(jnp.argmax(full[:, -1], -1)))
    np.testing.assert_allclose(_np(eng.logits[0]), _np(full[:, -1]), rtol=0,
                               atol=_tol(full[:, -1]))
    pre, _ = M.prefill(tparams, {"tokens": prompt}, _cfg())
    np.testing.assert_allclose(_np(pre), _np(eng.logits[0]), rtol=0,
                               atol=2e-4)


def test_audit_decode_matches_reference():
    """One audited step after the replay: the flag, the logits, the new
    cache and the sketches; the input cache untouched."""
    jparams, tparams, prompt = _setup()
    jc, tc = _jcfg(), _cfg()
    jcache = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                          JM.abstract_cache(jc, B, 8),
                          is_leaf=lambda x: hasattr(x, "logical"))
    tcache = M.allocate_cache(tc, B, 8, "cpu")
    for t in range(4):
        _, jcache = JM.decode_step(jparams, jnp.asarray(prompt[:, t]),
                                   jnp.int32(t), jcache, jc)
        _, tcache = M.decode_step(tparams, prompt[:, t], t, tcache, tc)
    tok = prompt[:, 4]
    jlog, jnew, jok = jengine.audit_decode(
        jparams, jnp.asarray(tok), jnp.int32(4), jcache, jc,
        key=jax.random.PRNGKey(1003))
    before = {n: t.clone() for n, t in tcache["mamba"].items()}
    tlog, tnew, ok = audit_decode(tparams, tok, 4, tcache, tc, key=1003)
    assert bool(jok) and ok is True
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=_tol(jlog))
    for n in before:
        assert torch.equal(tcache["mamba"][n], before[n])
        np.testing.assert_allclose(_np(tnew["mamba"][n]),
                                   _np(jnew["mamba"][n]), rtol=0,
                                   atol=_tol(jnew["mamba"][n]))
    ks = jdet.key_scalar_for_step(jax.random.PRNGKey(1003))
    js = jdet.hash_sign_sketch(jlog.reshape(-1), ks, 256)
    ts = tdet.hash_sign_sketch(tlog.reshape(-1), int(ks), 256)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=1e-5)


def test_tampered_replica_is_caught():
    """Final-norm scale[0] x 3 (examples/serve_audit.py's replica): both
    packages' sketches of its logits differ from the honest replica's,
    and the port's engine counts one span and one audit a step."""
    jparams, tparams, prompt = _setup()
    jc, tc = _jcfg(), _cfg()
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

    js_ok, js_bad = jsk(jparams), jsk(jbad)
    assert bool((jnp.abs(js_ok - js_bad) > 1e-5 * (1 + jnp.abs(js_ok))).any())
    ts_ok, ts_bad = tsk(tparams), tsk(tbad)
    assert not sketches_agree(ts_ok, ts_bad)
    assert sketches_agree(ts_ok, tsk(tparams))
    np.testing.assert_allclose(_np(ts_bad), _np(js_bad), rtol=0, atol=1e-5)

    ttrace.clear()
    audits0 = tmetrics.counter("serve.audits").value
    eng = ServeEngine(tc, tparams, q_audit=1.0, seed=0, device="cpu")
    eng.generate(prompt[:, :16], 3)
    steps = [e["args"]["step"] for e in ttrace.spans()
             if e["name"] == "serve.audit_decode"]
    assert steps == [0, 1, 2] and (eng.audits, eng.audit_failures) == (3, 0)
    assert tmetrics.counter("serve.audits").value == audits0 + 3
