"""The decoder layer stack: attention (global and sliding-window local),
Mamba2 mixers; the SwiGLU MLP, the MoE layer or no ffn.

Port of ``repro.models.transformer`` for these layer kinds.  The
reference scans periodic layer groups with ``lax.scan`` (and remat);
here the layers are a Python list run in order.  Encoder-decoder
models and cross-attention layers raise ``NotImplementedError``
(ROADMAP M11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind, ModelConfig, layer_kinds
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, rmsnorm

ATTN_MIXERS = ("attn", "attn_local")
PORTED_MIXERS = ATTN_MIXERS + ("mamba",)
PORTED_FFNS = ("mlp", "moe", "none")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a config with layers the port does not run yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP M11)")
    for kind in layer_kinds(cfg):
        if kind.mixer not in PORTED_MIXERS or kind.ffn not in PORTED_FFNS:
            raise NotImplementedError(
                f"{cfg.name}: {kind.tag} layers (cross-attention) are not "
                f"ported yet (ROADMAP M11)")


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
    """One layer (full-sequence path).  Returns (x, (k, v) | None, aux):
    k and v as (B, S, K*hd) for an attention layer when ``collect_kv``;
    aux the MoE load-balance loss (f32) of an MoE layer, else None."""
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
    x, aux = apply_ffn(kind, p, x, cfg)
    return x, kv, aux


def apply_ffn(kind: LayerKind, p, x: torch.Tensor, cfg: ModelConfig):
    """The layer's ffn sub-block, (B, S, D) -> (x, aux): aux the MoE
    load-balance loss (f32) of an MoE layer, else None."""
    if kind.ffn == "none":
        return x, None
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind.ffn == "mlp":
        return x + mlp(p["ffn"], h), None
    f, aux = moe_mod.moe(p["ffn"], h, cfg)
    return x + f, aux


def run_stack(layers, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, collect_kv: bool = False,
              impl: str | None = None):
    """All layers in order; returns (x, [(k, v) per attention layer],
    aux): aux () f32 the MoE layers' aux losses summed in layer order
    from 0, as the reference's scan carries it."""
    kv_all = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(layer_kinds(cfg), layers):
        x, kv, aux = apply_layer(kind, p, x, cfg, positions=positions,
                                 collect_kv=collect_kv, impl=impl)
        if kv is not None:
            kv_all.append(kv)
        if aux is not None:
            aux_total = aux_total + aux
    return x, kv_all, aux_total
