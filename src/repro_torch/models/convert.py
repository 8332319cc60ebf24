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
dtype) and an MoE layer's ``ffn`` leaves (``router``, ``gate``, ``up``,
``down`` and the ``shared`` expert's three) as the dense layers' do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, layer_groups
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
    layers = []
    for group, slots in zip(layer_groups(cfg), tree["decoder"]):
        for r in range(group.repeats):
            for pos in range(len(group.pattern)):
                layers.append(M.map_params(lambda a: a[r], slots[pos]))
    assert len(layers) == cfg.num_layers
    params = {"embed": dict(tree["embed"]), "layers": layers,
              "final_norm": dict(tree["final_norm"])}
    return M.map_params(lambda a: to_tensor(a).to(dev), params)
