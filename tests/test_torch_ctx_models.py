"""Models that attend to a context against the JAX package, on the CPU:
the encoder-decoder whisper-tiny and the VLM backbone
llama-3.2-vision-90b with its cross-attention layers.

Each at ``reduced()`` size in f32 (whisper-tiny: 2 encoder and 2
decoder layers, 24 context positions; llama-3.2-vision-90b: 10 layers,
cross-attention at 4 and 9, 17 context positions), the reference's
parameters (``repro.models.model.init(cfg, PRNGKey(0))``) carried over
with ``convert``; every cross-attention layer's ``gate_attn`` set to
0.5 in both trees (the reference initializes it to zero, which makes a
cross-attention layer add nothing); prompts and two contexts from a
numpy seed.  Held:

  * ``forward``'s logits within 1e-4 (1 + max|.|), and moved by the
    second context by more than that;
  * ``prefill``'s last logits and k/v, its zero cross caches in the
    reference's shapes and dtypes, and three decode steps' logits and
    whole cache, within 1e-4 (1 + max|.|); a decode step adds exactly
    nothing through the zero cross caches;
  * ``train_loss`` and its gradients against ``jax.value_and_grad``:
    the loss within 1e-5, the gradients within 1e-4 (1 + max|g|); the
    stacked tree's leaf paths and order equal the reference's,
    ``convert`` carries every leaf, ``stack_layers`` inverts
    ``layer_views``, ``init``'s ``gate_attn`` is zero; one step of
    ``pjit_step.make_train_step`` against the reference's;
  * ``ServeEngine.generate`` at q_audit 0 and 0.5 under both contexts
    against the reference's engine: greedy tokens under the margin rule
    (``serving.token_agreement``), the same audits, no failure; the
    tokens are the same under both contexts in both packages, since
    neither engine's decode writes the cross caches;
  * a model that attends to a context raises ``ValueError`` without one.
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
from repro_torch.configs import get_config, layer_kinds
from repro_torch.core import detection as tdet
from repro_torch.core import tree
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServeEngine, token_agreement
from repro_torch.serving.engine import sketches_agree
from torch_threads import one_thread  # noqa: F401 (one thread)

WHISPER, VISION = "whisper-tiny", "llama-3.2-vision-90b"
ARCHS = [WHISPER, VISION]
B, S, STEPS = 2, 16, 6
GATE = 0.5


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


def _tctx(cfg) -> int:
    return (cfg.num_encoder_positions if cfg.is_encoder_decoder
            else cfg.num_vision_tokens)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(the reference's params, its numpy tree, the port's, a prompt, two
    contexts), every ``gate_attn`` at GATE."""
    jnp_tree = jax.tree.map(np.asarray,
                            JM.init(_jcfg(name), jax.random.PRNGKey(0)))
    for slots in jnp_tree["decoder"]:
        for slot in slots:
            if "gate_attn" in slot["mixer"]:
                slot["mixer"]["gate_attn"] = np.full_like(
                    slot["mixer"]["gate_attn"], GATE)
    jparams = jax.tree.map(jnp.asarray, jnp_tree)
    tparams = convert.from_jax_params(_cfg(name), jnp_tree, device="cpu")
    cfg = _cfg(name)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    ctxs = tuple(rng.standard_normal((B, _tctx(cfg), cfg.d_model))
                 .astype(np.float32) for _ in range(2))
    return jparams, jnp_tree, tparams, prompt, ctxs


def _jbatch(prompt, ctx):
    return {"tokens": jnp.asarray(prompt), "ctx": jnp.asarray(ctx)}


@functools.lru_cache(maxsize=None)
def _jdecode(name):
    jc = _jcfg(name)
    return jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, jc))


def _jzero_cache(name, length):
    return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                        JM.abstract_cache(_jcfg(name), B, length),
                        is_leaf=lambda x: hasattr(x, "logical"))


@functools.lru_cache(maxsize=None)
def _jprefill(name):
    jparams, _, _, prompt, ctxs = _setup(name)
    return jax.jit(lambda p, b: JM.prefill(p, b, _jcfg(name),
                                           cache_len=S + STEPS))(
        jparams, _jbatch(prompt, ctxs[0]))


@pytest.mark.parametrize("name", ARCHS)
def test_layout_convert_and_init_match_reference(name):
    """Leaf paths and order of the stacked tree (``init_train``,
    ``convert.from_jax_train_params``) equal the reference's; convert
    carries every leaf bitwise; ``stack_layers`` of the per-layer tree
    is that tree and ``layer_views`` inverts it; ``init``'s gates are
    zero; the layer kinds and cross caches are the reference's."""
    cfg, jc = _cfg(name), _jcfg(name)
    _, jp, tparams, _, _ = _setup(name)
    want = _paths(jp)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(tp)] == want
    fresh = M.init_train(cfg, 0, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(fresh)] == want
    for t, a in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    stacked = M.stack_layers(tparams, cfg)
    assert [p for p, _ in tree.leaves_with_paths(stacked)] == want
    for a, b in zip(tree.leaves(stacked), tree.leaves(tp)):
        assert torch.equal(a, b)
    back = M.layer_views(stacked, cfg)
    for a, b in zip(tree.leaves(back), tree.leaves(tparams)):
        assert torch.equal(a, b)
    # two gates, 0-d and zero: vision's cross-attention layers', and
    # whisper's cross sub-blocks' (the reference gives them one, unread)
    gates = [t for p, t in tree.leaves_with_paths(M.init(cfg, 3, "cpu"))
             if p.endswith("gate_attn")]
    assert len(gates) == 2 and all(g.shape == () and g == 0 for g in gates)
    assert sum(p.endswith("gate_attn") for p in want) == 1
    kinds = [k.mixer for k in layer_kinds(cfg)]
    if name == VISION:
        assert kinds.count("cross_attn") == 2 and kinds[4] == kinds[9] == \
            "cross_attn" and tfm.attn_layer_indices(cfg) == \
            [0, 1, 2, 3, 5, 6, 7, 8]
    else:
        assert len(M.init(cfg, 3, "cpu")["encoder"]) == 2
        assert {"encoder", "encoder_norm"} <= set(tp)
    abstract = jax.tree_util.tree_flatten_with_path(
        JM.abstract_cache(jc, B, 40),
        is_leaf=lambda x: hasattr(x, "logical"))[0]
    got = tree.leaves_with_paths(M.allocate_cache(cfg, B, 40, "cpu"))
    assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                   for path, _ in abstract]
    for (_, t), (_, a) in zip(got, abstract):
        assert tuple(t.shape) == tuple(a.shape) and bool((t == 0).all())
        assert str(t.dtype).removeprefix("torch.") == np.dtype(a.dtype).name


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference_and_reads_ctx(name):
    jparams, _, tparams, prompt, ctxs = _setup(name)
    outs = []
    for ctx in ctxs:
        want, _, _ = JM.forward(jparams, _jbatch(prompt, ctx), _jcfg(name))
        got, _, _ = M.forward(tparams, {"tokens": prompt, "ctx": ctx},
                              _cfg(name))
        assert got.shape == (B, S, _cfg(name).vocab_size)
        _close(got, want)
        outs.append(got)
    # the context is live: the second one moves the logits
    assert float((outs[0] - outs[1]).abs().max()) > 100 * _tol(outs[0])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """prefill's last logits, k/v and zero cross caches; then three
    decode steps from the engine's cache (zeros, the prefill's k/v):
    logits and the whole cache.  A step's cross-attention over the zero
    caches adds exactly nothing: the step with the gates (vision) or
    the cross sub-blocks' output projections (whisper) zeroed is
    bitwise the same."""
    jparams, _, tparams, prompt, ctxs = _setup(name)
    tc = _cfg(name)
    jl, jpre = _jprefill(name)
    tl, tcache = M.prefill(tparams, {"tokens": prompt, "ctx": ctxs[0]}, tc,
                           cache_len=S + STEPS)
    _close(tl, jl)
    assert set(jpre) == {"k", "v"}
    assert set(tcache) == {"k", "v", "cross_k", "cross_v"}
    for n in ("k", "v"):
        _close(tcache[n], jpre[n])
    jcache = _jzero_cache(name, S + STEPS)
    jcache["k"], jcache["v"] = jpre["k"], jpre["v"]
    for n in ("cross_k", "cross_v"):
        assert tuple(tcache[n].shape) == jcache[n].shape
        assert tcache[n].dtype == torch.float32 and not tcache[n].any()
    if name == VISION:
        off = dict(tparams, layers=[
            dict(p, mixer=dict(p["mixer"], gate_attn=torch.zeros(())))
            if "gate_attn" in p["mixer"] else p for p in tparams["layers"]])
    else:
        off = dict(tparams, layers=[
            dict(p, cross=dict(p["cross"], wo=torch.zeros_like(
                p["cross"]["wo"]))) for p in tparams["layers"]])
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for i in range(3):
        jl, jcache = _jdecode(name)(jparams, jnp.asarray(tok),
                                    jnp.int32(S + i), jcache)
        ref_off, _ = M.decode_step(off, tok, S + i, dict(tcache), tc)
        tl, tcache = M.decode_step(tparams, tok, S + i, tcache, tc)
        assert torch.equal(tl, ref_off)
        _close(tl, jl)
        assert _paths(jcache) == [p for p, _ in
                                  tree.leaves_with_paths(tcache)]
        for a, b in zip(tree.leaves(tcache), jax.tree.leaves(jcache)):
            _close(a, b)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    assert not tcache["cross_k"].any() and not tcache["cross_v"].any()


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_reference(name):
    cfg, jc = _cfg(name), _jcfg(name)
    jparams, jp, _, _, ctxs = _setup(name)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "ctx": ctxs[1]}
    batch["labels"][0, :5] = -100
    (jl, _), jg = jax.value_and_grad(JM.train_loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    req = [p.requires_grad_() for p in tree.leaves(tp)]
    tl, tm = M.train_loss(tp, batch, cfg)
    # whisper's cross sub-blocks' gates are never read: zero, as in JAX
    tg = torch.autograd.grad(tl, req, materialize_grads=True)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(tm["moe_aux"]) == 0.0
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    for path, a, b in zip(paths, tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * (1 + np.abs(b).max()), \
            path
        # every cross-attention and encoder leaf is trained but whisper's
        # unread gates
        if path.endswith("cross/gate_attn"):
            assert not np.abs(b).any() and not a.any(), path
        elif "cross" in path or "encoder" in path or "gate_attn" in path:
            assert np.abs(b).max() > 0, path


@pytest.mark.parametrize("name", ARCHS)
def test_plain_train_step_matches_reference(name):
    """``pjit_step.make_train_step`` on a batch with ``ctx`` against the
    reference's: one momentum step, the loss within 1e-4 relative, every
    parameter within 1e-5; whisper's unread cross gates keep their value
    (a zero gradient, as ``jax.grad`` gives)."""
    from repro.optim import optimizer as jopt
    from repro.train import pjit_step as jpjit
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.train import pjit_step

    cfg, jc = _cfg(name), _jcfg(name)
    jparams, jp, _, prompt, ctxs = _setup(name)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    o = dict(kind="momentum", peak_lr=0.05, warmup_steps=1)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1),
             "ctx": ctxs[0]}
    jnew, _, jm = jpjit.make_train_step(jc, jopt.OptConfig(**o))(
        jparams, jopt.init_opt_state(jopt.OptConfig(**o), jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, 1)
    tnew, _, tm = pjit_step.make_train_step(cfg, opt_mod.OptConfig(**o))(
        tp, opt_mod.init_opt_state(opt_mod.OptConfig(**o), tp), batch, 1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-4 * float(jm["loss"])
    paths = [p for p, _ in tree.leaves_with_paths(tnew)]
    for path, a, b, old in zip(paths, tree.leaves(tnew),
                               jax.tree.leaves(jnew), jax.tree.leaves(jp)):
        assert np.abs(_np(a) - np.asarray(b)).max() <= 1e-5, path
        if path.endswith("cross/gate_attn"):
            assert np.array_equal(_np(a), old)


@functools.lru_cache(maxsize=None)
def _jax_greedy(name):
    """The reference's greedy run, step by step as its engine runs it
    (the prefill, then the prompt replayed through decode over the zero
    cross caches): (tokens (B, STEPS), [logits (B, V)] per step)."""
    jparams, _, _, prompt, _ = _setup(name)
    dec = _jdecode(name)
    _, pre = _jprefill(name)
    cache = _jzero_cache(name, S + STEPS)
    cache["k"], cache["v"] = pre["k"], pre["v"]
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


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    """The reference's engine under each context: at q_audit 0 under the
    first, at 0.5 (re-jitting each audit) under the second; (tokens,
    audits, failures) each."""
    jparams, _, _, prompt, ctxs = _setup(name)
    out = []
    for q, ctx in zip((0.0, 0.5), ctxs):
        eng = JServeEngine(_jcfg(name), jparams, q_audit=q, seed=0)
        toks = eng.generate(jnp.asarray(prompt), STEPS, ctx=jnp.asarray(ctx))
        out.append((np.asarray(toks), eng.audits, eng.audit_failures))
    return out


@pytest.mark.parametrize("q_audit", [0.0, 0.5])
@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name, q_audit, monkeypatch):
    """Under both contexts: the prompt replayed through decode, the
    tokens under the margin rule against the reference's greedy run and
    equal to its engine's, each step's logits while the tokens agree,
    the audits the seeded coins' and no failure; the same tokens under
    both contexts."""
    _, _, tparams, prompt, ctxs = _setup(name)
    ref_tokens, ref_logits = _jax_greedy(name)
    engines = _jax_engine(name)
    want_audits = int((np.random.default_rng(0).random(STEPS)
                       < q_audit).sum())
    for toks, audits, failures in engines:       # ctx-blind, both
        np.testing.assert_array_equal(toks, ref_tokens)
        assert failures == 0
    assert engines[1][1] == int((np.random.default_rng(0).random(STEPS)
                                 < 0.5).sum()) > 0
    tol = _tol(np.stack(ref_logits))
    got = []
    for ctx in ctxs:
        calls = []
        step = M.decode_step
        monkeypatch.setattr(M, "decode_step",
                            lambda *a: calls.append(a[2]) or step(*a))
        eng = ServeEngine(_cfg(name), tparams, q_audit=q_audit, seed=0,
                          device="cpu", record_logits=True)
        out = eng.generate(prompt, STEPS, ctx=ctx)
        monkeypatch.setattr(M, "decode_step", step)
        assert out.shape == (B, STEPS)
        assert (eng.audits, eng.audit_failures) == (want_audits, 0)
        assert calls[:S] == list(range(S))
        assert len(calls) == S + STEPS + want_audits
        compared, agreed = token_agreement(ref_logits, ref_tokens, out, tol)
        assert compared >= B and agreed == compared, (compared, agreed)
        for i in range(STEPS):
            if not np.array_equal(_np(out[:, :i]), ref_tokens[:, :i]):
                break
            np.testing.assert_allclose(_np(eng.logits[i]), ref_logits[i],
                                       rtol=0, atol=tol)
        got.append(out)
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("name", ARCHS)
def test_tampered_replica_is_caught(name):
    """Final-norm scale[0] x 3: the audit sketch of its decode logits
    differs from the honest replica's, which a rerun matches."""
    _, _, tparams, prompt, _ = _setup(name)
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


@pytest.mark.parametrize("name", ARCHS)
def test_missing_ctx_raises(name):
    """The reference fails with an AttributeError deep in its stack; the
    port names the missing input."""
    _, jp, tparams, prompt, _ = _setup(name)
    cfg = _cfg(name)
    with pytest.raises(ValueError, match="ctx"):
        M.forward(tparams, {"tokens": prompt}, cfg)
    with pytest.raises(ValueError, match="ctx"):
        M.prefill(tparams, {"tokens": prompt}, cfg)
    with pytest.raises(ValueError, match="ctx"):
        M.train_loss(convert.from_jax_train_params(cfg, jp, "cpu"),
                     {"tokens": prompt, "labels": prompt}, cfg)
    with pytest.raises(ValueError, match="ctx"):
        ServeEngine(cfg, tparams, device="cpu").generate(prompt, 2)
