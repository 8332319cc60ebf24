"""Per-layer activation checkpointing under ``cfg.remat``
(``models.transformer.run_stack``), on the CPU.

  * ``model.train_loss`` gradients with remat are bitwise those without,
    and within the trainer tests' tolerance of the reference's
    ``jax.grad`` (1e-4 * (1 + max|g|), loss 1e-5), on llama3.2-1b,
    mamba2-780m and phi3.5-moe ``reduced()`` in f32;
  * a layer is checkpointed only where autograd records through the
    stack: not under ``no_grad``, not on frozen parameters (serving),
    not with ``remat=False``;
  * the dry-run on ``meta`` tensors (``launch.dryrun``): a train step
    with remat launches K6 twice a layer (the forward and its
    recompute), its FLOPs are those without plus the stack's forward
    less the layer tails that the recompute stops before (PyTorch's
    early stop: a layer's last projection, whose output the backward
    does not keep, is not run again), and its peak is lower.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import input_specs
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from torch_threads import one_thread  # noqa: F401 (one thread)

ARCHS = ["llama3.2-1b", "mamba2-780m", "phi3.5-moe-42b-a6.6b"]
B, S = 3, 32


def _cfg(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **kw)


def _grads(cfg, jp, batch):
    tp = convert.from_jax_train_params(cfg, jp, "cpu")
    req = [p.requires_grad_() for p in tree.leaves(tp)]
    loss, _ = M.train_loss(tp, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, req)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gradients_are_bitwise_and_match_reference(name):
    assert get_config(name).remat
    jc = dataclasses.replace(jget_config(name).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray, JM.init(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, jc.vocab_size, (B, S), np.int32)}
    batch["labels"][0, :5] = -100
    l_on, g_on = _grads(_cfg(name, remat=True), jp, batch)
    l_off, g_off = _grads(_cfg(name, remat=False), jp, batch)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    (jl, _), jg = jax.value_and_grad(JM.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    assert abs(float(l_on) - float(jl)) <= 1e-5
    for a, b in zip(g_on, jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * (1 + np.abs(b).max())


def test_checkpoints_only_where_autograd_records(monkeypatch):
    calls = []
    real = tfm.checkpoint

    def counting(fn, *a, **kw):
        calls.append(1)
        return real(fn, *a, **kw)

    monkeypatch.setattr(tfm, "checkpoint", counting)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 16), np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    for remat, grad, frozen, want in [(True, True, False, True),
                                      (True, False, False, False),
                                      (True, True, True, False),
                                      (False, True, False, False)]:
        cfg = _cfg("llama3.2-1b", remat=remat)
        params = M.init_train(cfg, 0, "cpu")
        if not frozen:
            for p in tree.leaves(params):
                p.requires_grad_()
        calls.clear()
        with torch.set_grad_enabled(grad):
            M.train_loss(params, batch, cfg)
        assert len(calls) == (cfg.num_layers if want else 0), \
            (remat, grad, frozen)


def _tail_flops(cfg) -> int:
    """The layer tails a recompute does not run again: the dense MLP's
    down projection (B, S, F) @ (F, D) and the mamba mixer's output
    projection (B, S, d_inner) @ (d_inner, D), per layer; an MoE layer's
    expert outputs are kept (their gating reads them), so nothing."""
    if cfg.moe:
        return 0
    inner = ssm.dims(cfg)[0] if cfg.family == "ssm" else cfg.d_ff
    return 2 * 2 * S * inner * cfg.d_model * cfg.num_layers


@pytest.mark.parametrize("name", ARCHS)
def test_dryrun_counts_the_recompute(name):
    shape = ShapeConfig("train", S, 2, "train")
    with_, without = (D.lower_compile(dataclasses.replace(
        get_config(name).reduced(), remat=r), shape) for r in (True, False))
    cfg = get_config(name).reduced()
    layers = M.layer_views(input_specs(cfg, shape)["params"], cfg)["layers"]
    x = torch.empty((2, S, cfg.d_model), device="meta",
                    dtype=M.dtype_of(cfg))
    positions = torch.arange(S, device="meta")[None]

    def stack_forward(layers, x):
        with torch.no_grad():
            return tfm.run_stack(layers, x, cfg, positions=positions)

    _, fwd = D.count_step(stack_forward, (layers, x), "meta")
    assert with_["flops"] == without["flops"] + fwd["flops"] \
        - _tail_flops(cfg)
    assert with_["peak_bytes"] < without["peak_bytes"]
    k6 = [c["kernels"].get("flash_attention", {}).get("calls", 0)
          for c in (with_, without, fwd)]
    n_attn = len(tfm.attn_layer_indices(cfg))
    assert k6 == [2 * n_attn, n_attn, n_attn]
