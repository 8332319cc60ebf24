"""The plain (non-BFT) steps: one training step on the whole batch,
prefill and single-token decode.

Port of ``repro.train.pjit_step`` (the name is kept so the counterpart
is found); the reference's versions are what its dry-run lowers with
FSDP + TP shardings.  Here they run on one device, on the stacked
training layout of the parameters.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, opt_update


def make_train_step(cfg, opt: OptConfig, *, impl: str | None = None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}); params and state updated in place."""

    def train_step(params, opt_state, batch, step):
        req = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, _ = M.train_loss(tree.unflatten(params, req), batch, cfg,
                               impl=impl)
        # a leaf the loss never reads (whisper's ``cross/gate_attn``) gets
        # a zero gradient, as under ``jax.grad``
        grads = tree.unflatten(params, list(torch.autograd.grad(
            loss, req, materialize_grads=True)))
        params, opt_state, om = opt_update(opt, grads, opt_state, params,
                                           step)
        return params, opt_state, {"loss": loss.detach(), **om}

    return train_step


def make_prefill_step(cfg, *, impl: str | None = None):
    def prefill_step(params, batch):
        return M.prefill(M.layer_views(params, cfg), batch, cfg, impl=impl)

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, pos, cache):
        return M.decode_step(M.layer_views(params, cfg), token, pos, cache,
                             cfg)

    return decode_step
