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
reference's.  One device holds everything, so there is no sharding.
``step`` and ``pos`` are host values in the port's steps (a 0-d int32
CPU tensor here): step 0, and the decode token at the last position of
a full ``seq_len`` cache, so decode attends to every cached key.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of
from repro_torch.optim import OptConfig, abstract_opt_state

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, *, global_batch: int, seq_len: int,
                labels: bool = True) -> dict:
    out = {"tokens": torch.empty((global_batch, seq_len), dtype=torch.int32,
                                 device=META)}
    if labels:
        out["labels"] = torch.empty((global_batch, seq_len),
                                    dtype=torch.int32, device=META)
    if cfg.family in ("vlm", "audio"):
        tctx = (cfg.num_encoder_positions if cfg.is_encoder_decoder
                else cfg.num_vision_tokens)
        out["ctx"] = torch.empty((global_batch, tctx, cfg.d_model),
                                 dtype=dtype_of(cfg), device=META)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt: OptConfig | None = None) -> dict:
    """Full kwargs of the step traced for this cell."""
    params = M.abstract_params(cfg)
    if shape.kind == "train":
        opt = opt or OptConfig()
        return {
            "params": params,
            "opt_state": abstract_opt_state(opt, params),
            "batch": batch_specs(cfg, global_batch=shape.global_batch,
                                 seq_len=shape.seq_len),
            "step": torch.zeros((), dtype=torch.int32),
        }
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_specs(cfg, global_batch=shape.global_batch,
                                     seq_len=shape.seq_len, labels=False)}
    # decode: one new token against a seq_len cache
    return {
        "params": params,
        "token": torch.empty((shape.global_batch,), dtype=torch.int32,
                             device=META),
        "pos": torch.tensor(shape.seq_len - 1, dtype=torch.int32),
        "cache": M.abstract_cache(cfg, shape.global_batch, shape.seq_len,
                                  long_context=shape.seq_len >= 262144),
    }
