"""Stand-ins for every input of a step: ``meta`` tensors, no memory.

Port of ``repro.launch.specs``.  ``input_specs(cfg, shape)`` returns the
keyword arguments of the step that ``launch.dryrun`` traces for that
(arch x shape) cell, under the reference's keys:

  train_*    -> {params, opt_state, batch{tokens, labels[, ctx]}, step}
  prefill_*  -> {params, batch{tokens[, ctx]}}
  decode_*   -> {params, token, pos, cache}

``params`` is ``model.abstract_params`` (the stacked training layout),
``opt_state`` ``optim.abstract_opt_state``, ``cache``
``model.abstract_cache``; tokens and labels are int32, as the
reference's.  Without a mesh one device holds everything.  With one
(``input_specs(cfg, shape, opt, mesh=...)``, a ``sharding.MeshShape``
such as ``launch.mesh.make_production_mesh``'s, and a rank's
``coords``, rank 0 by default) every tensor is that rank's block, the
reference's ``NamedSharding(mesh, spec).shard_shape``: the parameters
and the AdamW state under ``sharding.PARAM_RULES``,
the batch and the token over (``pod``, ``data``) and the cache under
``ACT_RULES`` (``model.local_cache_layout``).  ``step`` and ``pos`` are
host values in the port's steps (a 0-d int32 CPU tensor here): step 0,
and the decode token at the last position of a full ``seq_len`` cache,
so decode attends to every cached key.
"""
from __future__ import annotations

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of
from repro_torch.optim import OptConfig, abstract_opt_state

META = torch.device("meta")


def _local(shape: tuple, logical: tuple, mesh, coords) -> tuple:
    """``shape`` as a rank of ``mesh`` holds it under ``ACT_RULES``."""
    if mesh is None:
        return tuple(shape)
    a = sharding.Annotated(tuple(shape), logical, None)
    return sharding.placement_of(a, mesh, sharding.ACT_RULES,
                                 coords).local_shape


def batch_specs(cfg: ModelConfig, *, global_batch: int, seq_len: int,
                labels: bool = True, mesh=None, coords=None) -> dict:
    shape = _local((global_batch, seq_len), ("batch", "seq"), mesh, coords)
    out = {"tokens": torch.empty(shape, dtype=torch.int32, device=META)}
    if labels:
        out["labels"] = torch.empty(shape, dtype=torch.int32, device=META)
    if cfg.family in ("vlm", "audio"):
        tctx = (cfg.num_encoder_positions if cfg.is_encoder_decoder
                else cfg.num_vision_tokens)
        out["ctx"] = torch.empty(
            _local((global_batch, tctx, cfg.d_model),
                   ("batch", "seq", "embed"), mesh, coords),
            dtype=dtype_of(cfg), device=META)
    return out


def param_structs(cfg: ModelConfig, mesh=None, coords=None):
    """The parameters as ``meta`` tensors, a rank's blocks under
    ``PARAM_RULES`` when ``mesh`` is given."""
    if mesh is None:
        return M.abstract_params(cfg)
    return sharding.tree_structs(M.annotated_params(cfg), mesh,
                                 sharding.PARAM_RULES, coords)


def cache_structs(cfg: ModelConfig, *, batch: int, seq_len: int,
                  long_context: bool = False, mesh=None, coords=None):
    """The decode cache as ``meta`` tensors: activation state, placed by
    ``ACT_RULES`` (not the parameters' rules), a rank's part of it when
    ``mesh`` is given."""
    if mesh is None:
        return M.abstract_cache(cfg, batch, seq_len, long_context)
    return M.map_params(
        lambda leaf: torch.empty(leaf[0], dtype=leaf[1], device=META),
        M.local_cache_layout(cfg, batch, seq_len, mesh, coords,
                             long_context))


def long_context(shape: ShapeConfig) -> bool:
    """Whether a decode cell's cache splits its sequence over ``data``
    (the reference's ``decode_seq``): from 262144 positions on, as the
    reference's dry-run decides (``long_500k``)."""
    return shape.kind == "decode" and shape.seq_len >= 262144


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt: OptConfig | None = None, *, mesh=None,
                coords=None, pos: int | None = None) -> dict:
    """Full kwargs of the step traced for this cell, as one device holds
    them or, given ``mesh``, as the rank at ``coords`` (rank 0 by
    default) does; a decode step at position ``pos`` (the cache's last,
    S - 1, by default: what the step reads depends on it)."""
    params = param_structs(cfg, mesh, coords)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = opt or OptConfig()
        return {
            "params": params,
            "opt_state": abstract_opt_state(opt, params),
            "batch": batch_specs(cfg, global_batch=B, seq_len=S, mesh=mesh,
                                 coords=coords),
            "step": torch.zeros((), dtype=torch.int32),
        }
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_specs(cfg, global_batch=B, seq_len=S,
                                     labels=False, mesh=mesh,
                                     coords=coords)}
    # decode: one new token against a seq_len cache
    return {
        "params": params,
        "token": torch.empty(_local((B,), ("batch",), mesh, coords),
                             dtype=torch.int32, device=META),
        "pos": torch.tensor(S - 1 if pos is None else pos,
                            dtype=torch.int32),
        "cache": cache_structs(cfg, batch=B, seq_len=S,
                               long_context=long_context(shape),
                               mesh=mesh, coords=coords),
    }
