"""Model facade: init, forward, prefill, decode with a KV cache.

Port of ``repro.models.model`` for every model of the configs: the
dense decoders (llama3.2-1b, gemma3-1b, qwen3-4b, ...), the MoE
decoders (phi3.5-moe, llama4-maverick), the attention-free Mamba2
(mamba2-780m), the hybrid (jamba), the VLM backbone with
cross-attention layers (llama-3.2-vision-90b) and the encoder-decoder
(whisper-tiny).  Parameters are a plain tree of tensors on one device:

    {"embed": {"tokens": (V, D)[, "head": (D, V)]},
     "layers": [{"ln1": {"scale"}, "mixer": {"wq", "wk", "wv", "wo"
                 [, "q_norm", "k_norm"][, "gate_attn"]}, "ln2": {"scale"},
                 "ffn": {"gate", "up", "down"}}, ...],   # one per layer
     "final_norm": {"scale"}}

with the reference's (in, out) matrix layout; an MoE layer's ``ffn``
is ``{"router", "gate", "up", "down"[, "shared"]}`` (``moe.init_moe``);
a mamba layer's mixer is the 13 leaves of ``ssm.init_mamba``, and
without an ffn (mamba2-780m) it has no ``ln2`` and no ``ffn``.  A
``cross_attn`` layer's mixer has ``gate_attn``, a 0-d leaf.  An
encoder-decoder model adds ``"encoder"`` (its attn+mlp layers) and
``"encoder_norm"``, and each decoder layer ``"ln_cross"`` and
``"cross"`` (a cross-attention sub-block).  A model that reads a
context takes ``batch["ctx"]`` (B, T, D): whisper's frame embeddings,
run through the encoder, or the VLM's patch embeddings, used directly.
``convert.from_jax_params`` builds the tree from the reference's
stacked one.  Every entry point runs on the card unless
``device="cpu"`` is asked for, and raises without one.  The cache has
``{"k", "v"}``, each (L_attn, B, cache_len, K*hd) in the config's
dtype, written in place by ``decode_step``, when the model has
attention layers; ``{"mamba": {"state", "conv_x", "conv_B",
"conv_C"}}`` when it has mamba layers, which ``decode_step`` replaces
with new tensors (the reference's functional cache); and ``{"cross_k",
"cross_v"}`` when it reads a context, which nothing writes: they stay
zero, as the reference's do.

Training keeps the reference's own layout instead (``stack_layers``,
``init_train``): ``{"decoder": [[slot per pattern position] per layer
group], "embed", "final_norm"}`` (and ``"encoder"``, ``[[slot]]`` over
one group, and ``"encoder_norm"``), each slot's leaves stacked over
the group's repeats, so the tree flattens to the reference's leaves
(11 for llama3.2-1b, 16 for mamba2-780m, 13 for phi3.5-moe).
``train_loss`` runs ``forward`` on per-layer views of those leaves
(``layer_views``, one ``unbind`` a leaf, whose backward is one
``stack``).

Under the plain steps' mesh (``train.pjit_step``: FSDP over ``data``,
TP over ``model``, the batch over ``pod`` and ``data``) the leaves are a
rank's blocks: ``fsdp_view`` gathers a tree's d_model dims over
``data`` just before use (each layer in ``transformer.fsdp_layer``, the
tables once for the lookup and the unembed), the activations
are the rank's rows, ``train_loss`` is the reference's global mean (this
rank's rows over the global token count, summed over the batch axes),
and the caches are the rank's part (``local_cache_layout``: batch over
``pod`` and ``data``, kv over ``model``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (LayerGroup, ModelConfig, layer_groups,
                                      layer_kinds)
from repro_torch.core import tree as tree_mod
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dtype_of, embed, init_weight,
                                       rmsnorm, unembed)
from repro_torch import sharding
from repro_torch.sharding import batch_rows, constrain_here

MOE_AUX_COEF = 0.01


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
    1/sqrt(fan_in), norm scales one, ``gate_attn`` zero; drawn from a
    ``torch.Generator`` on the target device seeded with ``seed`` (other
    numbers than JAX's); mamba mixers as ``ssm.init_mamba``, MoE ffns as
    ``moe.init_moe``.  On the ``meta`` device nothing is drawn
    (``abstract_params``)."""
    tfm.require_ported(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    D, F = cfg.d_model, cfg.d_ff

    def w(*shape):
        return init_weight(shape, dt, gen, dev)

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}

    def layer(kind, cross_block):
        if kind.mixer == "mamba":
            mixer = ssm_mod.init_mamba(cfg, gen, dev)
        else:
            mixer = attn.init_attention(cfg, gen, dev,
                                        cross=kind.mixer == "cross_attn")
        p = {"ln1": ones(D), "mixer": mixer}
        if cross_block:
            p["ln_cross"] = ones(D)
            p["cross"] = attn.init_attention(cfg, gen, dev, cross=True)
        if kind.ffn != "none":
            p["ln2"] = ones(D)
            p["ffn"] = ({"gate": w(D, F), "up": w(D, F), "down": w(F, D)}
                        if kind.ffn == "mlp"
                        else moe_mod.init_moe(cfg, gen, dev))
        return p

    emb = {"tokens": w(cfg.vocab_size, D)}
    if not cfg.tie_embeddings:
        emb["head"] = w(D, cfg.vocab_size)
    params = {"embed": emb,
              "layers": [layer(k, cfg.is_encoder_decoder)
                         for k in layer_kinds(cfg)],
              "final_norm": ones(D)}
    if cfg.is_encoder_decoder:
        params["encoder"] = [layer(k, False) for k in tfm.encoder_kinds(cfg)]
        params["encoder_norm"] = ones(D)
    return params


def _encoder_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """The reference's grouping of the encoder: one group of
    ``encoder_layers`` repeats of attn+mlp."""
    return [LayerGroup((tfm.ENCODER_KIND,), cfg.encoder_layers)]


def layer_stacks(cfg: ModelConfig):
    """(per-layer key, stacked key, the reference's layer groups) of each
    layer stack of the model."""
    out = [("layers", "decoder", layer_groups(cfg))]
    if cfg.is_encoder_decoder:
        out.append(("encoder", "encoder", _encoder_groups(cfg)))
    return out


def _slot_layers(groups: list[LayerGroup]):
    """(group, position in the pattern, [layer index per repeat])."""
    off = 0
    for g, group in enumerate(groups):
        P = len(group.pattern)
        for pos in range(P):
            yield g, pos, [off + r * P + pos for r in range(group.repeats)]
        off += group.num_layers


def _unstacked(tree) -> dict:
    """The leaves outside the layer stacks."""
    return {k: v for k, v in tree.items()
            if k not in ("layers", "decoder", "encoder")}


def stack_layers(params, cfg: ModelConfig):
    """Per-layer parameters -> the reference's stacked training layout
    (layer ``off + r * len(pattern) + pos`` is row r of slot [g][pos])."""
    out = _unstacked(params)
    for flat, stacked, groups in layer_stacks(cfg):
        out[stacked] = [[None] * len(group.pattern) for group in groups]
        for g, pos, idx in _slot_layers(groups):
            out[stacked][g][pos] = tree_mod.tree_map(
                lambda *xs: torch.stack(xs), *[params[flat][i] for i in idx])
    return out


def layer_views(tree, cfg: ModelConfig):
    """The stacked training layout -> the per-layer layout ``forward``
    takes, each layer's tensors views of the stacked leaves."""
    out = _unstacked(tree)
    for flat, stacked, groups in layer_stacks(cfg):
        out[flat] = [None] * sum(g.num_layers for g in groups)
        for g, pos, idx in _slot_layers(groups):
            slot = tree[stacked][g][pos]
            rows = [leaf.unbind(0) for leaf in tree_mod.leaves(slot)]
            for r, i in enumerate(idx):
                out[flat][i] = tree_mod.unflatten(slot, [u[r] for u in rows])
    return out


def init_train(cfg: ModelConfig, seed: int = 0, device=None):
    """``init`` in the stacked training layout."""
    params = init(cfg, seed, device)
    out = stack_layers(params, cfg)
    del params
    return out


def abstract_params(cfg: ModelConfig):
    """``init_train``'s tree as ``meta`` tensors: every leaf's shape and
    dtype (the reference's ``abstract_params``) without memory or random
    draws, so a 400 B-parameter model costs nothing."""
    return init_train(cfg, device="meta")


# logical axes of each leaf by its key (the reference's ``abstract_*``):
# the dense and cross-attention projections, the MLP, the MoE layer and
# the mamba mixer; the stacked layers add "layers" in front
_LOGICAL = {
    "wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
    "wo": ("heads", "embed"), "q_norm": ("norm",), "k_norm": ("norm",),
    "gate_attn": (), "scale": ("norm",),
    "router": ("embed_no_fsdp", "experts"),
    "in_z": ("embed", "ssm_inner"), "in_x": ("embed", "ssm_inner"),
    "in_B": ("embed", "ssm_state"), "in_C": ("embed", "ssm_state"),
    "in_dt": ("embed", "ssm_heads"), "conv_x": ("conv", "ssm_inner"),
    "conv_B": ("conv", "ssm_state"), "conv_C": ("conv", "ssm_state"),
    "A_log": ("ssm_heads",), "dt_bias": ("ssm_heads",), "D": ("ssm_heads",),
    "norm": ("norm",), "out": ("ssm_inner", "embed"),
}
# the ffn's gate / up / down: a dense MLP's (2-d) or the experts' (3-d)
_FFN_LOGICAL = {
    2: {"gate": ("embed", "ffn"), "up": ("embed", "ffn"),
        "down": ("ffn", "embed")},
    3: {"gate": ("experts", "embed", "expert_ffn"),
        "up": ("experts", "embed", "expert_ffn"),
        "down": ("experts", "expert_ffn", "embed")},
}
_INIT = {"scale": "ones", "q_norm": "ones", "k_norm": "ones",
         "norm": "ones", "D": "ones", "gate_attn": "zeros",
         "A_log": "ssm_a", "dt_bias": "ssm_dt"}


def _logical_of(path: str, shape: tuple) -> tuple:
    """The reference's logical axes of the leaf at ``path`` (a
    ``core.tree`` path of the stacked training layout)."""
    parts = path.split("/")
    key = parts[-1]
    stacked = parts[0] in ("decoder", "encoder")
    if parts[0] == "embed":
        return ("vocab", "embed") if key == "tokens" else ("embed", "vocab")
    rank = len(shape) - stacked
    if key in ("gate", "up", "down"):
        names = _FFN_LOGICAL[rank][key]
    else:
        names = _LOGICAL[key]
    return (("layers",) if stacked else ()) + names


def leaf_logical(path: str, ndim: int) -> tuple:
    """The logical axes of a leaf of the per-layer layout (or of the
    ``embed`` dict) by its path's last key and its rank."""
    key = path.split("/")[-1]
    if key == "tokens":
        return ("vocab", "embed")
    if key == "head":
        return ("embed", "vocab")
    if key in ("gate", "up", "down"):
        return _FFN_LOGICAL[ndim][key]
    return _LOGICAL[key]


def fsdp_view(tree, cfg: ModelConfig):
    """``tree`` (a layer's leaves or the ``embed`` dict) as the TP code
    reads it: each leaf whose d_model (``embed``) dim is split over the
    ambient ``data`` axis gathered along it (``parallel.fsdp_gather``;
    a dim the axis does not divide stays whole, as ``spec_for`` left
    it); ``tree`` itself without a data axis."""
    ax = parallel.data_axis()
    if ax is None:
        return tree

    def view(path, t):
        for j, name in enumerate(leaf_logical(path, t.dim())):
            if name == "embed" and t.shape[j] != cfg.d_model:
                return parallel.fsdp_gather(t, j, ax)
        return t

    return tree_mod.unflatten(tree, [
        view(path, t) for path, t in tree_mod.leaves_with_paths(tree)])


def annotated_params(cfg: ModelConfig):
    """``abstract_params``'s tree with each leaf an ``Annotated``: its
    shape, the reference's logical axes (``layers`` first on a stacked
    leaf), dtype and initializer; ``sharding.tree_specs`` /
    ``tree_shardings`` place it on a mesh."""
    from repro_torch.sharding import Annotated

    meta = abstract_params(cfg)
    return tree_mod.unflatten(meta, [
        Annotated(tuple(t.shape), _logical_of(path, tuple(t.shape)),
                  t.dtype, _INIT.get(path.split("/")[-1], "normal"))
        for path, t in tree_mod.leaves_with_paths(meta)])


def token_nll(logits: torch.Tensor, labels, cfg: ModelConfig):
    """(nll, valid): each token's next-token cross-entropy over the f32
    ``logits`` (0 where its label is < 0) and the valid labels' mask.
    CE = logsumexp - label logit: the gather equals the reference's
    one-hot contraction, whose other terms are exact zeros; from this
    rank's columns under a vocab split (``_split_ce_terms``)."""
    labels = _tokens(labels, logits.device)
    valid = labels >= 0
    if logits.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels.clamp(min=0)[..., None])[
            ..., 0]
    else:
        lse, label_logit = _split_ce_terms(logits, labels)
    return torch.where(valid, lse - label_logit, 0.0), valid


def train_loss(params, batch, cfg: ModelConfig, *, impl: str | None = None):
    """Mean next-token cross-entropy (``token_nll``) of the
    stacked-layout ``params`` on {tokens, labels (B, S)[, ctx]} (labels <
    0 ignored) plus ``MOE_AUX_COEF`` times the MoE layers' summed aux
    loss; returns (loss, {"ce", "moe_aux"}).  Differentiable: attention
    goes through ``ops.flash_attention``'s autograd form."""
    logits, _, aux = forward(layer_views(params, cfg), batch, cfg,
                             impl=impl)
    nll, valid = token_nll(logits, batch["labels"], cfg)
    count = valid.sum()
    if sharding.batch_mesh() is not None:
        # the reference's global mean: this rank's rows over the global
        # token count, the shares summed over the batch axes
        count = parallel.batch_sum(count)
        aux = parallel.batch_sum(aux)
    denom = torch.clamp(count, min=1)
    ce = parallel.batch_sum(nll.sum() / denom)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "moe_aux": aux}



def _split_ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, label logit) of vocab-split f32 logits (..., V / model):
    the row max and the sum of exponentials reduced over ``model``, the
    label's logit from the rank that holds it; no rank holds (..., V)."""
    ax = parallel.require_axis()
    n = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    ax.all_reduce_max(top)
    sumexp = parallel.reduce(torch.exp(logits - top[..., None]).sum(dim=-1),
                             ax)
    local = labels.clamp(min=0) - ax.rank * n
    inside = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    label_logit = parallel.reduce(torch.where(inside, picked, 0.0), ax)
    return torch.log(sumexp) + top, label_logit


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).to(torch.int64)


def _context(params, batch, cfg: ModelConfig, impl: str | None):
    """What cross-attention reads: ``batch["ctx"]`` (B, T, D) cast to the
    config's dtype; for an encoder-decoder model run through the encoder
    (positions 0..T-1 with rope, no causal mask) and ``encoder_norm``,
    for a VLM used as it is.  None for a model without cross-attention,
    which ignores a ctx as the reference does."""
    if not tfm.uses_context(cfg):
        return None
    if batch.get("ctx") is None:
        raise ValueError(f"{cfg.name} attends to a context: pass "
                         f"batch['ctx'], (B, T, d_model) embeddings")
    dev = params_device(params)
    ctx = torch.as_tensor(batch["ctx"], device=dev).to(dtype_of(cfg))
    if not cfg.is_encoder_decoder:
        return ctx
    positions = torch.arange(ctx.shape[1], device=dev)[None]
    x, _, _ = tfm.run_stack(params["encoder"], ctx, cfg, positions=positions,
                            kinds=tfm.encoder_kinds(cfg), causal=False,
                            impl=impl)
    return rmsnorm(params["encoder_norm"], x, cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig, collect_kv: bool = False, *,
            last_only: bool = False, impl: str | None = None):
    """(logits (B, S, V) f32, [(k, v) (B, S, K*hd) per attention layer],
    aux () f32: the MoE layers' aux losses summed) of {tokens (B, S)[,
    ctx (B, T, D)]}; a model that attends to a context raises
    ``ValueError`` without ``ctx``.  ``last_only`` unembeds the last
    position only (logits (B, 1, V)): the same numbers without the (B,
    S, V) array."""
    tfm.require_ported(cfg)
    ctx = _context(params, batch, cfg, impl)
    dev = params_device(params)
    tokens = _tokens(batch["tokens"], dev)
    B, S = tokens.shape
    # under FSDP the tables are gathered once for the lookup and the
    # unembed, so their gradients meet before one reduce-scatter, as one
    # process adds them
    emb = fsdp_view(params["embed"], cfg)
    x = constrain_here(embed(emb, tokens, cfg), ("batch", "seq", "embed"),
                       (batch_rows(B), S, cfg.d_model))
    positions = torch.arange(S, device=dev)[None]
    x, kv_all, aux = tfm.run_stack(params["layers"], x, cfg,
                                   positions=positions, ctx=ctx,
                                   collect_kv=collect_kv, impl=impl)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(emb, x, cfg)
    logits = constrain_here(logits, ("batch", "seq", "vocab"),
                            (batch_rows(B),) + tuple(logits.shape[1:-1])
                            + (cfg.vocab_size,))
    return logits, kv_all, aux


def cache_layout(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode cache's tree with a (shape, dtype) for each tensor (the
    reference's ``abstract_cache``): {"k", "v"} (L_attn, B, seq_len,
    K*hd) in the config's dtype when the model has attention layers;
    {"mamba": ``ssm.mamba_cache_layout``} when it has mamba layers;
    {"cross_k", "cross_v"} (n_cross, B, Tctx, K*hd) in the config's
    dtype when it attends to a context: n_cross its ``cross_attn`` layers
    plus, for an encoder-decoder model, every decoder layer; Tctx
    ``num_encoder_positions`` (encoder-decoder) or
    ``num_vision_tokens``."""
    tfm.require_ported(cfg)
    cache = {}
    dt, KH = dtype_of(cfg), cfg.num_kv_heads * cfg.head_dim
    n_attn = len(tfm.attn_layer_indices(cfg))
    if n_attn:
        for n in ("k", "v"):
            cache[n] = ((n_attn, batch, seq_len, KH), dt)
    n_mamba = len(tfm.mamba_layer_indices(cfg))
    if n_mamba:
        cache["mamba"] = ssm_mod.mamba_cache_layout(cfg, batch, n_mamba)
    n_cross = tfm.num_cross(cfg)
    if n_cross:
        T = (cfg.num_encoder_positions if cfg.is_encoder_decoder
             else cfg.num_vision_tokens)
        for n in ("cross_k", "cross_v"):
            cache[n] = ((n_cross, batch, T, KH), dt)
    return cache


def cache_logical(cfg: ModelConfig, long_context: bool = False):
    """The logical axes of each cache tensor (the reference's
    ``abstract_cache``), which ``ACT_RULES`` place: batch over (``pod``,
    ``data``), kv and ``ssm_inner`` over ``model``, the SSM state's
    heads whole (``ACT_RULES`` has no ``ssm_heads``); ``long_context``
    puts the sequence on ``data`` (``decode_seq``)."""
    seq = "decode_seq" if long_context else None
    names = {"k": ("layers", "batch", seq, "kv"),
             "v": ("layers", "batch", seq, "kv"),
             "cross_k": ("layers", "batch", None, "kv"),
             "cross_v": ("layers", "batch", None, "kv"),
             "state": ("layers", "batch", "ssm_heads", None, None),
             "conv_x": ("layers", "batch", None, "ssm_inner"),
             "conv_B": ("layers", "batch", None, "ssm_state"),
             "conv_C": ("layers", "batch", None, "ssm_state")}
    layout = cache_layout(cfg, 1, 1)
    return {k: ({n: names[n] for n in v} if k == "mamba" else names[k])
            for k, v in layout.items()}


def cache_placements(cfg: ModelConfig, batch: int, seq_len: int,
                     mesh=None, coords=None, long_context: bool = False):
    """Each cache tensor's ``sharding.Placement`` on one rank of ``mesh``
    (default: the ambient mesh, ``batch`` then this rank's rows, the
    global batch ``batch_rows(batch)``) under ``ACT_RULES``; None
    without a mesh.  ``long_context``: the sequence split over ``data``
    (``decode_seq``), rank d holding positions [d S / data, (d + 1) S /
    data); a ``data`` axis that does not divide ``seq_len`` raises (the
    reference would replicate the sequence, which a step told it is
    split would misplace)."""
    ambient = mesh is None
    mesh = sharding.ambient_mesh() if ambient else mesh
    if mesh is None:
        return None
    full = cache_layout(cfg, batch_rows(batch, mesh) if ambient else batch,
                        seq_len)
    data = sharding.mesh_axis_sizes(mesh).get("data", 1)
    if long_context and "k" in full and seq_len % data:
        raise ValueError(f"a sequence of {seq_len} does not split over "
                         f"data {data}")
    names = cache_logical(cfg, long_context)

    def place(leaf, logical):
        return sharding.placement_of(sharding.Annotated(leaf[0], logical,
                                                        leaf[1]),
                                     mesh, sharding.ACT_RULES, coords)

    return {k: ({n: place(full[k][n], names[k][n]) for n in full[k]}
                if k == "mamba" else place(full[k], names[k]))
            for k in full}


def local_cache_layout(cfg: ModelConfig, batch: int, seq_len: int,
                       mesh=None, coords=None, long_context: bool = False):
    """``cache_layout`` of a global ``batch`` as one rank of ``mesh``
    holds it (``cache_placements``); ``cache_layout`` itself without a
    mesh."""
    pls = cache_placements(cfg, batch, seq_len, mesh, coords, long_context)
    if pls is None:
        return cache_layout(cfg, batch, seq_len)
    dtypes = cache_layout(cfg, 1, 1)

    def local(pl, leaf):
        return (pl.local_shape, leaf[1])

    return {k: ({n: local(pl, dtypes[k][n]) for n, pl in v.items()}
                if k == "mamba" else local(v, dtypes[k]))
            for k, v in pls.items()}


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   long_context: bool = False):
    """``cache_layout`` as ``meta`` tensors.  ``long_context`` changes
    only the reference's sharding of the sequence axis; one device holds
    the same tree."""
    del long_context
    return map_params(lambda leaf: torch.empty(leaf[0], dtype=leaf[1],
                                               device="meta"),
                      cache_layout(cfg, batch, seq_len))


def allocate_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
                   long_context: bool = False):
    """``cache_layout`` filled with zeros on ``device``; under an ambient
    mesh this rank's part of it, ``batch`` its rows, its block of the
    sequence under ``long_context`` (``local_cache_layout``)."""
    return map_params(lambda leaf: torch.zeros(leaf[0], dtype=leaf[1],
                                               device=device),
                      local_cache_layout(cfg, batch, seq_len,
                                         long_context=long_context))


def prefill(params, batch, cfg: ModelConfig, cache_len: int | None = None, *,
            impl: str | None = None):
    """Run the full prompt (and its ``ctx``), returning (last-token logits
    (B, V), cache).  The cache's k/v hold the prompt's; its mamba and
    cross parts are zero, as the reference's prefill leaves them:
    ``ServeEngine.generate`` replays the prompt through ``decode_step``,
    which fills the mamba part and never writes the cross part."""
    logits, kv_all, _ = forward(params, batch, cfg, collect_kv=True,
                                last_only=True, impl=impl)
    B, S = batch["tokens"].shape
    cache = allocate_cache(cfg, B, S if cache_len is None else cache_len,
                           params_device(params))
    for i, (k, v) in enumerate(kv_all):
        attn.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
    return logits[:, -1], cache


def _decode_cross(p, h: torch.Tensor, cache, i: int, cfg: ModelConfig):
    """One token's cross-attention (``p``'s projections, no rope) over
    the i-th cross cache, every position visible."""
    q = attn.project_q(p, h, cfg, None, rope=False)
    ck, cv = cache["cross_k"][i], cache["cross_v"][i]
    B, T = ck.shape[:2]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    o = attn.decode_attention(q, ck.reshape(B, T, K, hd),
                              cv.reshape(B, T, K, hd), valid_len=T)
    return attn.output_proj(p, o)


def decode_step(params, token, pos: int, cache, cfg: ModelConfig,
                long_context: bool = False):
    """One decode step.  token: (B,) int; pos: the position the new token
    occupies (the cache holds pos valid entries before the call).
    ``long_context``: under an ambient mesh with a ``data`` axis the KV
    cache is this rank's block of the sequence (``local_cache_layout``):
    the token's k/v are written by the rank whose block holds ``pos``
    and attention combines the ranks' blocks
    (``attention.decode_attention``'s ``seq``).

    Returns (logits (B, V) f32, new cache).  The new token's k/v are
    written into ``cache``'s k/v in place at ``pos``: run twice on the
    same inputs it writes the same values, so a replay sees what the
    first run saw.  The mamba state and conv buffers are not idempotent
    that way, so they are functional, as the reference's whole cache is:
    the new cache holds new mamba tensors and ``cache``'s stay as they
    were.  An MoE layer routes the step's B tokens as one group, as the
    reference does.  Cross-attention reads the cross caches and never
    writes them; over the zero caches a step leaves them (attention over
    zero keys and values gives exactly 0) it adds nothing, as in the
    reference.
    """
    tfm.require_ported(cfg)
    dev = params_device(params)
    token = _tokens(token, dev)
    emb = fsdp_view(params["embed"], cfg)
    x = embed(emb, token[:, None], cfg)
    positions = torch.full((1, 1), int(pos), device=dev)
    new_mamba = {n: [] for n in cache.get("mamba", {})}
    attn_i = cross_i = 0
    seq = None
    if long_context and "k" in cache:
        mesh = sharding.ambient_mesh()
        ax = sharding.axis_of(mesh, "data")
        if ax is not None:
            seq = (ax, mesh.coords["data"] * cache["k"].shape[2])
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        p = fsdp_view(p, cfg)          # dropped when the next layer runs
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if kind.mixer == "mamba":
            i = len(new_mamba["state"])
            out, mnew = ssm_mod.mamba_decode_step(
                p["mixer"], h[:, 0],
                {n: t[i] for n, t in cache["mamba"].items()}, cfg)
            for n, t in mnew.items():
                new_mamba[n].append(t)
            x = x + out[:, None]
        elif kind.mixer == "cross_attn":
            mix = _decode_cross(p["mixer"], h, cache, cross_i, cfg)
            x = x + mix * torch.tanh(p["mixer"]["gate_attn"].to(mix.dtype))
            cross_i += 1
        else:
            x = x + attn.decode_self_attention(
                p["mixer"], h, cfg, positions, cache["k"][attn_i],
                cache["v"][attn_i], int(pos), tfm.window_of(kind, cfg),
                seq)
            attn_i += 1
        if "cross" in p:
            h = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
            x = x + _decode_cross(p["cross"], h, cache, cross_i, cfg)
            cross_i += 1
        x, _ = tfm.apply_ffn(kind, p, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = dict(cache)
    if new_mamba:
        new_cache["mamba"] = {n: torch.stack(ts) for n, ts in
                              new_mamba.items()}
    return unembed(emb, x[:, 0], cfg), new_cache
