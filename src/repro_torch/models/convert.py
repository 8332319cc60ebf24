"""Carry the JAX package's parameters over to the port.

``from_jax_params(cfg, tree)`` takes the reference's parameter tree
(``repro.models.model.init``) with numpy arrays for leaves and returns
the port's tree (``repro_torch.models.model``).  The reference stacks
each periodic layer group with a leading ``repeats`` dim
(``transformer.abstract_stack``): layer ``off + r * len(pattern) + pos``
is row ``r`` of group slot ``[g][pos]`` (``model._layer_param``).  The
port keeps one entry per layer, in layer order.  Every leaf comes over
by name with its dtype: a mamba layer's ``ln1`` and 13 mixer leaves
(``A_log``, ``dt_bias`` and ``D`` in f32, the rest in the config's
dtype), an MoE layer's ``ffn`` leaves (``router``, ``gate``, ``up``,
``down`` and the ``shared`` expert's three), a cross-attention layer's
``gate_attn`` (row r of an (R,) leaf: a 0-d tensor) and an
encoder-decoder model's ``ln_cross`` and ``cross`` as the dense layers'
do; its ``encoder`` stack the same way, and ``encoder_norm``.

``shard_params`` keeps one rank's shard of a full tree (each leaf's
``sharding.Placement``, ``placements``): under the trainer's rules a
leaf split over ``model``, under the plain steps' ``PARAM_RULES`` a
(``pod``, ``data``, ``model``) rank's 2-d block (d_model over ``data``
too).  ``gather_params`` joins the shards back over both axes into the
full tree, so a checkpoint has one layout whatever the mesh, and
``from_jax_train_params`` carries the reference's parameters across
before ``shard_params``, unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm


def to_tensor(a) -> torch.Tensor:
    """numpy (or array-like) -> CPU tensor; bfloat16 arrays (ml_dtypes)
    go through their 16-bit pattern."""
    a = np.array(a)                   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_train_params(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree (numpy leaves) in its own stacked
    layout, the trainer's (``model.init_train``), on ``device``."""
    tfm.require_ported(cfg)
    dev = M.resolve_device(device)
    return M.map_params(lambda a: to_tensor(a).to(dev), tree)


def from_jax_params(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (``None``: the card, which must exist)."""
    tfm.require_ported(cfg)
    dev = M.resolve_device(device)
    params = {k: v for k, v in tree.items() if k not in ("decoder",
                                                         "encoder")}
    for flat, stacked, groups in M.layer_stacks(cfg):
        params[flat] = [
            M.map_params(lambda a, r=r: a[r], slots[pos])
            for group, slots in zip(groups, tree[stacked])
            for r in range(group.repeats)
            for pos in range(len(group.pattern))]
    assert len(params["layers"]) == cfg.num_layers
    return M.map_params(lambda a: to_tensor(a).to(dev), params)


def placements(cfg: ModelConfig, mesh, coords=None, rules=None):
    """Each leaf's ``sharding.Placement`` on one rank of ``mesh`` (this
    rank of a ``DeviceMesh`` unless ``coords``) under ``rules``: the
    trainer's ``tp_only_rules`` by default, ``sharding.PARAM_RULES`` for
    the plain steps."""
    from repro_torch.sharding import tp_only_rules, tree_shardings

    return tree_shardings(M.annotated_params(cfg), mesh,
                          tp_only_rules() if rules is None else rules,
                          coords)


def shard_params(tree, shardings):
    """Full tree -> this rank's shards (``shardings``: ``placements``),
    each a tensor of its own; a replicated leaf is the same tensor."""
    from repro_torch.core import tree as tree_mod

    return tree_mod.tree_map(
        lambda leaf, pl: pl.take(leaf).clone() if pl.sharded else leaf,
        tree, shardings)


def gather_params(tree, shardings, axis):
    """This rank's shards -> the full tree, each leaf gathered along each
    split dim over that dim's axis: ``axis`` is the ``model`` axis
    (``train.ranks.ModelAxis``) or a plain steps' mesh
    (``train.ranks.StepMesh``: ``model``, then ``data``); every rank of
    the axes calls it, in the same leaf order.  The same function takes
    a tree of AdamW state, placed as the parameters are."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.sharding import axis_of

    def full(leaf, pl):
        for name in ("model", "data"):
            dim = pl.dim_on(name)
            if dim is not None:
                leaf = axis_of(axis, name).gather_dim(leaf, dim)
        return leaf

    return tree_mod.tree_map(full, tree, shardings)
