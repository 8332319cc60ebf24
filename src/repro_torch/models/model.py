"""Model facade: init, forward, prefill, decode with a KV cache.

Port of ``repro.models.model`` for the dense decoders (llama3.2-1b,
gemma3-1b, qwen3-4b, ...).  Parameters are a plain tree of tensors on
one device:

    {"embed": {"tokens": (V, D)[, "head": (D, V)]},
     "layers": [{"ln1": {"scale"}, "mixer": {"wq", "wk", "wv", "wo"
                 [, "q_norm", "k_norm"]}, "ln2": {"scale"},
                 "ffn": {"gate", "up", "down"}}, ...],   # one per layer
     "final_norm": {"scale"}}

with the reference's (in, out) matrix layout; ``convert.from_jax_params``
builds it from the reference's stacked tree.  Every entry point runs on
the card unless ``device="cpu"`` is asked for, and raises without one.
The KV cache is ``{"k", "v"}``, each (L_attn, B, cache_len, K*hd) in
the config's dtype, written in place by ``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dtype_of, embed, init_weight, mlp,
                                       rmsnorm, unembed)


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one this raises rather than
    running on the CPU unasked."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch models run on a CUDA device by default and "
                "none is available; pass device=\"cpu\" to run the plain "
                "PyTorch versions of the kernels on the CPU")
        return torch.device("cuda" if device is None else device)
    return torch.device(device)


def map_params(fn, tree):
    """``fn`` applied to every tensor of a parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def to_device(params, device):
    dev = torch.device(device)
    return map_params(lambda t: t.to(dev), params)


def params_device(params) -> torch.device:
    return params["final_norm"]["scale"].device


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random-init parameters with the reference's distributions
    (``layers.materialize``): matrices truncated normal on [-2, 2] times
    1/sqrt(fan_in), norm scales one; drawn from a ``torch.Generator`` on
    the target device seeded with ``seed`` (other numbers than JAX's)."""
    tfm.require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    D, F = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape):
        return init_weight(shape, dt, gen, dev)

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}

    emb = {"tokens": w(cfg.vocab_size, D)}
    if not cfg.tie_embeddings:
        emb["head"] = w(D, cfg.vocab_size)
    layers = []
    for _ in layer_kinds(cfg):
        mixer = {"wq": w(D, H * hd), "wk": w(D, K * hd), "wv": w(D, K * hd),
                 "wo": w(H * hd, D)}
        if cfg.qk_norm:
            mixer["q_norm"] = ones(hd)["scale"]
            mixer["k_norm"] = ones(hd)["scale"]
        layers.append({"ln1": ones(D), "mixer": mixer, "ln2": ones(D),
                       "ffn": {"gate": w(D, F), "up": w(D, F),
                               "down": w(F, D)}})
    return {"embed": emb, "layers": layers, "final_norm": ones(D)}


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).to(torch.int64)


def forward(params, batch, cfg: ModelConfig, collect_kv: bool = False, *,
            last_only: bool = False, impl: str | None = None):
    """(logits (B, S, V) f32, [(k, v) (B, S, K*hd) per attention layer]).
    ``last_only`` unembeds the last position only (logits (B, 1, V)):
    the same numbers without the (B, S, V) array."""
    tfm.require_dense(cfg)
    if batch.get("ctx") is not None:
        raise NotImplementedError("context inputs (vlm / audio) are not "
                                  "ported yet (ROADMAP M11)")
    dev = params_device(params)
    tokens = _tokens(batch["tokens"], dev)
    S = tokens.shape[1]
    x = embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, device=dev)[None]
    x, kv_all = tfm.run_stack(params["layers"], x, cfg, positions=positions,
                              collect_kv=collect_kv, impl=impl)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), kv_all


def allocate_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    """Zero KV cache: {"k", "v"} (L_attn, B, seq_len, K*hd), the config's
    dtype (the reference's ``abstract_cache``); mamba and cross-attention
    caches are not ported (ROADMAP M11)."""
    tfm.require_dense(cfg)
    shape = (len(tfm.attn_layer_indices(cfg)), batch, seq_len,
             cfg.num_kv_heads * cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype_of(cfg), device=device)
            for n in ("k", "v")}


def prefill(params, batch, cfg: ModelConfig, cache_len: int | None = None, *,
            impl: str | None = None):
    """Run the full prompt, returning (last-token logits (B, V), cache)."""
    logits, kv_all = forward(params, batch, cfg, collect_kv=True,
                             last_only=True, impl=impl)
    B, S = kv_all[0][0].shape[:2]
    cache = allocate_cache(cfg, B, S if cache_len is None else cache_len,
                           params_device(params))
    for i, (k, v) in enumerate(kv_all):
        attn.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
    return logits[:, -1], cache


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """One decode step.  token: (B,) int; pos: the position the new token
    occupies (the cache holds pos valid entries before the call).

    Returns (logits (B, V) f32, cache): the new token's k/v are written
    into ``cache`` in place at ``pos``.  Run twice on the same inputs it
    writes the same values, so a replay sees what the first run saw (the
    reference's cache is functional).
    """
    tfm.require_dense(cfg)
    dev = params_device(params)
    token = _tokens(token, dev)
    B = token.shape[0]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    x = embed(params["embed"], token[:, None], cfg)            # (B, 1, D)
    positions = torch.full((1, 1), int(pos), device=dev)
    for attn_i, (kind, p) in enumerate(zip(layer_kinds(cfg),
                                           params["layers"])):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q = attn.project_q(p["mixer"], h, cfg, positions)
        k_new, v_new = attn.project_kv(p["mixer"], h, cfg, positions)
        ck, cv = cache["k"][attn_i], cache["v"][attn_i]
        attn.update_cache(ck, cv, k_new.reshape(B, 1, K * hd),
                          v_new.reshape(B, 1, K * hd), int(pos))
        S = ck.shape[1]
        o = attn.decode_attention(
            q, ck.reshape(B, S, K, hd), cv.reshape(B, S, K, hd),
            valid_len=int(pos) + 1, window=tfm.window_of(kind, cfg))
        x = x + attn.output_proj(p["mixer"], o)
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["ffn"], h)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x[:, 0], cfg), cache
