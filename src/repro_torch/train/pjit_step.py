"""The plain (non-BFT) steps: one training step on the whole batch,
prefill and single-token decode.

Port of ``repro.train.pjit_step`` (the name is kept so the counterpart
is found); the reference's versions are what its dry-run lowers with
FSDP + TP shardings.  Here they run on the stacked training layout of
the parameters, in one process (``mesh=None``) or on one rank of a
(``pod``,) ``data``, ``model`` mesh (``mesh``: a ``train.ranks.StepMesh``
over ``launch.mesh.make_step_mesh``), which the step installs as the
ambient mesh of the model code:

  - the parameters and the AdamW state are this rank's blocks under
    ``sharding.PARAM_RULES`` (``models.convert.shard_params``): d_model
    over ``data`` (FSDP), heads, kv, ffn, vocab and experts over
    ``model`` (TP and EP), replicated over ``pod``;
  - the batch, the decode token and the caches are this rank's rows
    (``StepMesh.local_rows``): the batch split over (``pod``, ``data``),
    or replicated over an axis that does not divide it (the reference's
    divisibility fallback, ``StepMesh.for_batch``: ``long_500k``'s batch
    of 1); the caches' kv and ``ssm_inner`` over ``model``
    (``models.model.local_cache_layout``, the reference's
    ``cache_structs``), under ``long_context`` the KV cache's sequence
    over ``data`` (``decode_seq``), each rank's block combined by the
    decode attention;
  - each layer gathers its d_model dims over ``data`` just before it
    runs (``models.transformer.fsdp_layer``); a leaf's gradient is
    reduce-scattered over ``data`` by the gather's backward, a leaf that
    ``data`` does not split (the norms, the router, a dim the axis does
    not divide) has its gradient summed over ``data`` after the
    backward, and every gradient is summed over ``pod``; all three in
    f32 in rank order, so the replicated leaves stay bitwise equal;
  - the loss is the reference's global mean (``models.model.train_loss``),
    and the clip reads the global norm (``optim.global_norm``).

The steps return this rank's shards: the prefill's and decode's logits
(rows, V / model), which ``StepMesh.full_logits`` gathers.  With a mesh
of world 1 the train step is bitwise the one-process step.
"""
from __future__ import annotations

import torch

from repro_torch import sharding
from repro_torch.core import tree
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, opt_update


def _mesh_of(cfg, mesh, placed: bool = False):
    """``mesh``, or None when it is absent or of world 1 (the one-process
    step); ``placed``: with its placements, resolved here, when the step
    is made, not inside it (``annotated_params`` draws the model's shapes
    on meta, which a dry-run's counter inside the step would count)."""
    if mesh is None or mesh.world == 1:
        return None
    if placed and mesh.placements is None:
        mesh.placements = tree.leaves(convert.placements(
            cfg, mesh.mesh, rules=sharding.PARAM_RULES))
    return mesh


def sync_grads(grads: list, mesh) -> list:
    """The gradients of this rank's leaves after the backward, made the
    whole batch's: a leaf ``data`` does not split summed over ``data``
    (the split ones were reduce-scattered in the backward), then every
    leaf summed over ``pod``; in f32 in rank order."""
    data, pod = sharding.axis_of(mesh, "data"), sharding.axis_of(mesh, "pod")
    out = []
    for g, pl in zip(grads, mesh.placements):
        if data is not None and pl.dim_on("data") is None:
            g = data.all_reduce_ordered(g)
        if pod is not None:
            g = pod.all_reduce_ordered(g)
        out.append(g)
    return out


def make_train_step(cfg, opt: OptConfig, *, impl: str | None = None,
                    mesh=None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}); params and state updated in place.
    Under ``mesh`` they are this rank's blocks and ``batch`` its rows;
    the loss and the norm are the global ones on every rank."""
    m = _mesh_of(cfg, mesh, placed=True)
    if m is not None and not m.batch_whole:
        raise ValueError("a train step splits its batch over every batch "
                         "axis: the gradients are summed over them")

    def train_step(params, opt_state, batch, step):
        req = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with sharding.set_mesh(m):
            loss, _ = M.train_loss(tree.unflatten(params, req), batch, cfg,
                                   impl=impl)
            # a leaf the loss never reads (whisper's ``cross/gate_attn``)
            # gets a zero gradient, as under ``jax.grad``
            grads = list(torch.autograd.grad(loss, req,
                                             materialize_grads=True))
            del req
            if m is not None:
                grads = sync_grads(grads, m)
            params, opt_state, om = opt_update(
                opt, tree.unflatten(params, grads), opt_state, params, step,
                axis=m)
        return params, opt_state, {"loss": loss.detach(), **om}

    return train_step


def make_prefill_step(cfg, *, impl: str | None = None, mesh=None):
    m = _mesh_of(cfg, mesh)

    def prefill_step(params, batch):
        with sharding.set_mesh(m):
            return M.prefill(M.layer_views(params, cfg), batch, cfg,
                             impl=impl)

    return prefill_step


def make_decode_step(cfg, *, mesh=None, long_context: bool = False):
    """decode_step(params, token, pos, cache) -> (logits, cache).  Under
    ``mesh`` ``token`` is this rank's rows of the view's batch (a batch
    that the batch axes do not all divide takes ``mesh.for_batch(B)``:
    ``long_500k``'s batch of 1 is on every rank) and ``cache`` its part
    of the cache; ``long_context``: the cache's sequence split over
    ``data`` (``models.model.allocate_cache(..., long_context=True)``,
    as ``launch.specs.input_specs`` sets it from S >= 262144)."""
    m = _mesh_of(cfg, mesh)

    def decode_step(params, token, pos, cache):
        with sharding.set_mesh(m):
            return M.decode_step(M.layer_views(params, cfg), token, pos,
                                 cache, cfg, long_context=long_context)

    return decode_step
