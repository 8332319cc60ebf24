"""The layer stacks: the decoder (and an encoder-decoder model's
encoder) of attention (global and sliding-window local), cross-attention
and Mamba2 mixers; the SwiGLU MLP, the MoE layer or no ffn.

Port of ``repro.models.transformer``.  The reference scans periodic
layer groups with ``lax.scan`` (and remat); here the layers are a
Python list run in order; under FSDP (an ambient ``data`` axis, the
plain steps of ``train.pjit_step``) each layer gathers its leaves'
d_model dims just before it runs (``fsdp_layer``).  A ``cross_attn``
layer (llama-3.2-vision) attends from the sequence to the context
without rope and gates its output by tanh(gate_attn); every decoder
layer of an encoder-decoder model (whisper) has a ``cross`` sub-block
after its mixer, ungated.

Under ``cfg.remat``, when autograd records, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
after the forward and the backward runs the layer's forward again, as
far as the tensors the backward needs (PyTorch's early stop: a layer's
last projection is not run again), so a stack keeps one layer's
activations at a time beside the layer inputs.  The reference's unit is
one repeat of a group's pattern, which is one layer for the
decoder-only families the port trains; the recompute is the same
computation on the same inputs, so the gradients are bitwise those
without remat.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerKind, ModelConfig, layer_kinds
from repro_torch.core import tree as _tree
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, rmsnorm

ATTN_MIXERS = ("attn", "attn_local")
MIXERS = ATTN_MIXERS + ("mamba", "cross_attn")
FFNS = ("mlp", "moe", "none")
ENCODER_KIND = LayerKind("attn", "mlp")


def require_splittable(cfg: ModelConfig, model: int) -> None:
    """Raise unless the stack runs split over a model axis of ``model``
    ranks: the dense, MoE, mamba and hybrid decoders.  Attention splits
    its heads, padded to the reference's head groups where ``model``
    cuts a head (``attention.head_group``); a mamba mixer its heads and
    d_inner together, of one group (``ssm.split_error``).  Cross-attention
    and encoder-decoder models (whisper, the VLM) raise: the BFT steps
    never pass a context, so they wait for ROADMAP item 7b."""
    if model <= 1:
        return
    kinds = layer_kinds(cfg)
    if cfg.is_encoder_decoder or any(k.mixer == "cross_attn"
                                     for k in kinds):
        raise ValueError(
            f"{cfg.name}: a model axis above 1 splits the decoder-only "
            f"stacks; cross-attention and encoder-decoder models wait for "
            f"ROADMAP item 7b")
    if any(k.mixer == "mamba" for k in kinds):
        err = ssm_mod.split_error(cfg, model)
        if err:
            raise ValueError(err)


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a config with a layer kind the stack does not run (its
    branches take any mixer but mamba and cross_attn for attention)."""
    for kind in layer_kinds(cfg):
        if kind.mixer not in MIXERS or kind.ffn not in FFNS:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind.tag}")


def encoder_kinds(cfg: ModelConfig) -> list[LayerKind]:
    """An encoder-decoder model's encoder: ``encoder_layers`` attn+mlp
    layers (none for a decoder-only model)."""
    return [ENCODER_KIND] * cfg.encoder_layers


def num_cross(cfg: ModelConfig) -> int:
    """Cross-attentions (and cross caches): one per ``cross_attn`` layer
    and, for an encoder-decoder model, one per decoder layer."""
    return sum(k.mixer == "cross_attn" for k in layer_kinds(cfg)) + (
        cfg.num_layers if cfg.is_encoder_decoder else 0)


def uses_context(cfg: ModelConfig) -> bool:
    """Whether the model reads ``ctx``: it has a cross-attention."""
    return num_cross(cfg) > 0


def attn_layer_indices(cfg: ModelConfig) -> list[int]:
    """Indices of layers that own a self-attention KV cache."""
    return [i for i, k in enumerate(layer_kinds(cfg))
            if k.mixer in ATTN_MIXERS]


def mamba_layer_indices(cfg: ModelConfig) -> list[int]:
    return [i for i, k in enumerate(layer_kinds(cfg)) if k.mixer == "mamba"]


def window_of(kind: LayerKind, cfg: ModelConfig) -> int | None:
    return cfg.sliding_window if kind.mixer == "attn_local" else None


def cross_attention(p, h: torch.Tensor, ctx: torch.Tensor,
                    cfg: ModelConfig, impl: str | None = None):
    """Attention from h (B, S, D) to ctx (B, T, D), no rope on either
    side and no mask (K6 non-causal), through ``p``'s projections."""
    q = attn.project_q(p, h, cfg, None, rope=False)
    k, v = attn.project_kv(p, ctx, cfg, None, rope=False)
    o = attn.blockwise_attention(q, k, v, causal=False, impl=impl)
    return attn.output_proj(p, o)


def apply_layer(kind: LayerKind, p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, ctx: torch.Tensor | None = None,
                causal: bool = True, collect_kv: bool = False,
                impl: str | None = None):
    """One layer (full-sequence path).  Returns (x, (k, v) | None, aux):
    k and v as (B, S, K*hd) for an attention layer when ``collect_kv``;
    aux the MoE load-balance loss (f32) of an MoE layer, else None.
    ``ctx`` (B, T, D) is what cross-attention reads; ``causal=False``
    is the encoder's self-attention."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    kv = None
    if kind.mixer == "mamba":
        x = x + ssm_mod.mamba(p["mixer"], h, cfg)
    elif kind.mixer == "cross_attn":
        mix = cross_attention(p["mixer"], h, ctx, cfg, impl)
        x = x + mix * torch.tanh(p["mixer"]["gate_attn"].to(mix.dtype))
    else:
        mix, (k, v) = attn.self_attention(
            p["mixer"], h, cfg, positions, causal=causal,
            window=window_of(kind, cfg), impl=impl)
        x = x + mix
        if collect_kv:
            B, S = k.shape[:2]
            kv = (k.reshape(B, S, -1), v.reshape(B, S, -1))
    if "cross" in p:             # an encoder-decoder model's decoder layer
        h = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + cross_attention(p["cross"], h, ctx, cfg, impl)
    x, aux = apply_ffn(kind, p, x, cfg)
    return x, kv, aux


def apply_ffn(kind: LayerKind, p, x: torch.Tensor, cfg: ModelConfig):
    """The layer's ffn sub-block, (B, S, D) -> (x, aux): aux the MoE
    load-balance loss (f32) of an MoE layer, else None."""
    if kind.ffn == "none":
        return x, None
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind.ffn == "mlp":
        return x + mlp(p["ffn"], h, cfg.d_ff), None
    f, aux = moe_mod.moe(p["ffn"], h, cfg)
    return x + f, aux


def fsdp_layer(kind: LayerKind, p, x: torch.Tensor, cfg: ModelConfig,
               **kw):
    """``apply_layer`` on a layer whose leaves are FSDP shards over the
    ambient ``data`` axis: each leaf's d_model dim gathered just before
    the layer (``model.fsdp_view``), the gathered weights dropped when
    it returns.

    Under autograd a product saves its weight operand, which would keep
    every layer's gathered weights alive until the backward and undo
    FSDP's memory.  So ``run_stack`` checkpoints this function, gather
    included, whenever autograd records under FSDP, ``cfg.remat`` or
    not: the forward keeps only the shards and the layer's input, and
    the backward gathers the layer's weights again in the recompute,
    then reduce-scatters their gradients (``parallel.fsdp_gather``).
    That reuses the checkpoint the stack already has and needs no hooks
    on saved tensors; its cost is the recompute, which remat pays
    anyway."""
    from repro_torch.models.model import fsdp_view

    return apply_layer(kind, fsdp_view(p, cfg), x, cfg, **kw)


def remat_active(cfg: ModelConfig, layers, x: torch.Tensor,
                 ctx: torch.Tensor | None = None) -> bool:
    """Whether ``run_stack`` checkpoints its layers: ``cfg.remat`` (or
    FSDP, below) and autograd recording through the stack (grad enabled
    and the input, the context or a layer's parameter requiring grad),
    so serving and a forward under ``no_grad`` run as before."""
    fsdp = parallel.data_axis() is not None
    if not ((cfg.remat or fsdp) and torch.is_grad_enabled()):
        return False
    if x.requires_grad or (ctx is not None and ctx.requires_grad):
        return True
    return any(t.requires_grad for t in _tree.leaves(layers))


def run_stack(layers, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, kinds: list[LayerKind] | None = None,
              ctx: torch.Tensor | None = None, causal: bool = True,
              collect_kv: bool = False, impl: str | None = None):
    """All layers in order (``kinds``: theirs, the decoder's by default);
    returns (x, [(k, v) per attention layer], aux): aux () f32 the MoE
    layers' aux losses summed in layer order from 0, as the reference's
    scan carries it.  Each layer is checkpointed when ``remat_active``."""
    kv_all = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat_active(cfg, layers, x, ctx)
    layer = fsdp_layer if parallel.data_axis() is not None else apply_layer
    for kind, p in zip(layer_kinds(cfg) if kinds is None else kinds, layers):
        kw = dict(positions=positions, ctx=ctx, causal=causal,
                  collect_kv=collect_kv, impl=impl)
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            x, kv, aux = checkpoint(layer, kind, p, x, cfg,
                                    use_reentrant=False,
                                    preserve_rng_state=False, **kw)
        else:
            x, kv, aux = layer(kind, p, x, cfg, **kw)
        if kv is not None:
            kv_all.append(kv)
        if aux is not None:
            aux_total = aux_total + aux
    return x, kv_all, aux_total
