"""The trainer's model side against the JAX package, on the CPU.

  * ``model.train_loss`` and its gradients against
    ``jax.value_and_grad(M.train_loss)`` on llama3.2-1b, gemma3-1b and
    qwen3-4b ``reduced()`` in f32: loss within 1e-5, gradients within
    1e-4 * (1 + max|g|);
  * the stacked training layout (the reference's leaves, 11 for
    llama3.2-1b) and its per-layer views;
  * attention's gradient (the plain version's, whatever the forward);
  * ``pjit_step``'s plain train and prefill steps against the
    reference's: loss 1e-4 relative, parameters within 1e-5;
  * an identify step on tampered workers: the tamperer named, the
    update equal (bitwise) to the one from the honest gradients.

Helpers and the shared reference trees come from
``tests/test_torch_train_parts.py``.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import optimizer as jopt
from repro.train import pjit_step as jpjit
from repro_torch.core import prngkey, tree
from repro_torch.core.assignment import check_assignment
from repro_torch.data import pipeline as data
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import optimizer as opt_mod
from repro_torch.train import pjit_step, steps
from test_torch_train_parts import ARCHS, _cfg, _jcfg, _jparams, _same_tree
from torch_threads import one_thread  # noqa: F401 (one thread)


# ---------------------------------------------------------------------------
# model: the training loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_reference(name):
    cfg, jc = _cfg(name), _jcfg(name)
    jp = _jparams(name)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(tp)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    rng = np.random.default_rng(1)
    B, S = 3, 40                                     # past the window of 32
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}
    batch["labels"][0, :5] = -100
    (jl, jaux), jg = jax.value_and_grad(JM.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    req = [p.requires_grad_() for p in tree.leaves(tp)]
    tl, taux = M.train_loss(tp, batch, cfg)
    tg = torch.autograd.grad(tl, req)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * (1 + np.abs(b).max())


def test_llama_train_tree_has_the_references_eleven_leaves():
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(
                  JM.abstract_params(jget_config("llama3.2-1b")),
                  is_leaf=lambda x: hasattr(x, "logical"))[0]]
    assert len(jpaths) == 11
    small = M.init_train(_cfg("llama3.2-1b"), 0, "cpu")
    assert [p for p, _ in tree.leaves_with_paths(small)] == jpaths
    # each layer of the views is a view of the stacked leaf
    views = M.layer_views(small, _cfg("llama3.2-1b"))
    w = small["decoder"][0][0]["ffn"]["down"]
    assert views["layers"][1]["ffn"]["down"].data_ptr() == \
        w[1].data_ptr()


def test_stack_layers_inverts_layer_views():
    for name in ARCHS:
        cfg = _cfg(name)
        per_layer = M.init(cfg, 3, "cpu")
        stacked = M.stack_layers(per_layer, cfg)
        back = M.layer_views(stacked, cfg)
        for a, b in zip(tree.leaves(back), tree.leaves(per_layer)):
            assert torch.equal(a, b)


def test_attention_gradient_is_the_plain_versions():
    """``ops.flash_attention`` under autograd: the forward of its impl,
    the gradient of the plain version (here both plain)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 40, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 40, 2, 16, generator=g, requires_grad=True)
    go = torch.randn(2, 40, 4, 16, generator=g)
    for window in (None, 8):
        out = ops.flash_attention(q, k, v, window=window)
        got = torch.autograd.grad(out, (q, k, v), go)
        ref_out = kref.flash_attention_ref(q, k, v, window=window)
        want = torch.autograd.grad(ref_out, (q, k, v), go)
        assert torch.equal(out, ref_out)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_plain_train_step_matches_reference():
    name = "llama3.2-1b"
    cfg, jc = _cfg(name), _jcfg(name)
    jp = _jparams(name)
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    o = dict(kind="momentum", peak_lr=0.05, warmup_steps=1)
    batch = jdata.global_batch_for_step(jc, global_batch=4, seq_len=16,
                                        step=2)
    jfn = jpjit.make_train_step(jc, jopt.OptConfig(**o))
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.init_opt_state(jopt.OptConfig(**o), jparams)
    tfn = pjit_step.make_train_step(cfg, opt_mod.OptConfig(**o))
    tstate = opt_mod.init_opt_state(opt_mod.OptConfig(**o), tp)
    for step in range(2):
        jparams, jstate, jm = jfn(jparams, jstate,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, step)
        tp, tstate, tm = tfn(tp, tstate, batch, step)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * float(jm["loss"])
    _same_tree(tp, jparams, atol=1e-5)
    logits, _ = pjit_step.make_prefill_step(cfg)(tp, {"tokens":
                                                      batch["tokens"]})
    jlogits, _ = jpjit.make_prefill_step(jc)(jparams, {
        "tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_identify_step_finds_the_tamperers():
    """An identify step on tampered workers: the voted update equals the
    one from an honest replica's gradient, and byz names the tamperers."""
    cfg = _cfg("llama3.2-1b")
    params = M.init_train(cfg, 0, "cpu")
    o = opt_mod.OptConfig(kind="sgd", peak_lr=0.1, warmup_steps=0)
    active = np.ones(8, bool)
    a = check_assignment(active, 2, np.random.default_rng(0))  # r = 3
    members = np.array([np.flatnonzero(a.group_of_worker == g)
                        for g in range(a.num_shards)])
    batch = data.global_batch_for_step(cfg, global_batch=8, seq_len=12,
                                       step=0)
    wb = data.worker_batches(batch, a)
    byz = np.zeros(8, bool)
    bad = members[0][1]
    byz[bad] = True
    attack = steps.AttackConfig("sign_flip", 1.0, 5.0)
    fn = steps.make_identify_step(cfg, o, steps.StepConfig(), attack,
                                  members)
    before = [p.clone() for p in tree.leaves(params)]
    _, _, m = fn(params, {}, wb, a.weight, byz, prngkey.PRNGKey(1), 0)
    assert np.flatnonzero(m["byz"]).tolist() == [bad]
    # the same update from honest gradients, group by group
    gs = []
    for g in range(members.shape[0]):
        w = members[g][0]
        p0 = tree.unflatten(params, [b.clone() for b in before])
        _, gt, did = steps.per_worker_grad(
            p0, torch.as_tensor(wb["tokens"][w]),
            torch.as_tensor(wb["labels"][w]), False, (0, 0), cfg, attack)
        assert not did
        gs.append([x.to(torch.float32) for x in tree.leaves(gt)])
    mean = [torch.stack([g[i] for g in gs]).mean(dim=0)
            for i in range(len(gs[0]))]
    p0 = tree.unflatten(params, [b.clone() for b in before])
    opt_mod.opt_update(o, tree.unflatten(params, mean), {}, p0, 0)
    for x, y in zip(tree.leaves(p0), tree.leaves(params)):
        assert torch.equal(x, y)


def test_launch_train_runs_and_restores_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: a reduced run
    with checkpoints, then a restart that resumes from the last one."""
    from repro_torch.launch import train as launch

    args = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "16", "--f", "2",
            "--byz", "2,5", "--q", "0.5", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    launch.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[launch] done: loss=" in out and "8 workers on cpu" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    launch.main(args + ["--steps", "4", "--restore"])
    out = capsys.readouterr().out
    assert "[launch] restored step 2" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


def test_trainer_refuses_params_on_another_device():
    """Given parameters must lie where the trainer runs; without a card
    the default device raises rather than training on the CPU unasked."""
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _cfg("llama3.2-1b")
    params = M.init_train(cfg, 0, "cpu")
    args = (cfg, OptConfig(), BFTConfig(n=8, f=2),
            TrainerConfig(seq_len=16, global_batch=16))
    with pytest.raises(ValueError, match="params lie on cpu"):
        Trainer(*args, device="meta", params=params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            Trainer(*args, params=params)
