"""The decoder layer stack: attention (global and sliding-window local),
Mamba2 mixers, the SwiGLU MLP or no ffn.

Port of ``repro.models.transformer`` for these layer kinds.  The
reference scans periodic layer groups with ``lax.scan`` (and remat);
here the layers are a Python list run in order.  Encoder-decoder
models, cross-attention and MoE layers raise ``NotImplementedError``
(ROADMAP M11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind, ModelConfig, layer_kinds
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, rmsnorm

ATTN_MIXERS = ("attn", "attn_local")
PORTED_MIXERS = ATTN_MIXERS + ("mamba",)
PORTED_FFNS = ("mlp", "none")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a config with layers the port does not run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP M11)")
    for kind in layer_kinds(cfg):
        if kind.mixer not in PORTED_MIXERS or kind.ffn not in PORTED_FFNS:
            raise NotImplementedError(
                f"{cfg.name}: {kind.tag} layers (cross-attention and MoE) "
                f"are not ported yet (ROADMAP M11)")


def attn_layer_indices(cfg: ModelConfig) -> list[int]:
    """Indices of layers that own a self-attention KV cache."""
    return [i for i, k in enumerate(layer_kinds(cfg))
            if k.mixer in ATTN_MIXERS]


def mamba_layer_indices(cfg: ModelConfig) -> list[int]:
    return [i for i, k in enumerate(layer_kinds(cfg)) if k.mixer == "mamba"]


def window_of(kind: LayerKind, cfg: ModelConfig) -> int | None:
    return cfg.sliding_window if kind.mixer == "attn_local" else None


def apply_layer(kind: LayerKind, p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, collect_kv: bool = False,
                impl: str | None = None):
    """One layer (full-sequence path).  Returns (x, (k, v) | None): k and
    v as (B, S, K*hd) for an attention layer when ``collect_kv``."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    kv = None
    if kind.mixer == "mamba":
        x = x + ssm_mod.mamba(p["mixer"], h, cfg)
    else:
        q = attn.project_q(p["mixer"], h, cfg, positions)
        k, v = attn.project_kv(p["mixer"], h, cfg, positions)
        o = attn.blockwise_attention(q, k, v, causal=True,
                                     window=window_of(kind, cfg), impl=impl)
        x = x + attn.output_proj(p["mixer"], o)
        if collect_kv:
            B, S = k.shape[:2]
            kv = (k.reshape(B, S, -1), v.reshape(B, S, -1))
    if kind.ffn == "none":
        return x, kv
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h), kv


def run_stack(layers, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, collect_kv: bool = False,
              impl: str | None = None):
    """All layers in order; returns (x, [(k, v) per attention layer])."""
    kv_all = []
    for kind, p in zip(layer_kinds(cfg), layers):
        x, kv = apply_layer(kind, p, x, cfg, positions=positions,
                            collect_kv=collect_kv, impl=impl)
        if kv is not None:
            kv_all.append(kv)
    return x, kv_all
