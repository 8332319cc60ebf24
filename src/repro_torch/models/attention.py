"""Attention: GQA with optional qk-norm, sliding-window (local) masks
and cross-attention; full-sequence (prefill) attention through K6 and
single-token decode against a KV cache.

Port of ``repro.models.attention``.  ``blockwise_attention`` is the
reference's flash-style prefill attention; here it is
``ops.flash_attention``: on a CUDA tensor the hand-written kernel K6,
on a CPU tensor (or with ``impl="torch"``) its plain version, the port
of the reference's blockwise loop.  ``decode_attention`` stays plain
PyTorch, as the reference computes it outside any kernel; with the KV
cache's sequence split over ``data`` (``long_500k``, the reference's
``decode_seq``) each rank holds a block of positions and the softmax is
combined over the ranks, as XLA partitions the reference's.

``self_attention`` is a layer's projections, K6 and output projection.
When wq's columns are split over the ambient ``model`` axis (the
reference's ``heads`` on ``model``; ``shard_heads_for_tp``), each rank
computes its query heads with their kv heads, K6 runs on them and the
row-parallel wo's outputs are summed over ``model``.  When ``model``
divides H a rank's heads are its H / model columns of wq.  When it
divides H * hd only, wq's columns and wo's rows stay split evenly
(``spec_for``'s placement, which cuts a head) and each rank computes
the reference's padded head group (``heads_forced``, ``head_group``):
q's columns are all-gathered and the rank keeps its heads, K6 runs on
its real heads only (none on a rank past the last head), and the heads'
outputs are all-gathered back to wo's row split.  The kv heads: split
with the query heads when ``model`` divides K; when it divides K * hd
only (wk's columns cut a head) the rank's columns are all-gathered and
the rank keeps its query heads' kv heads; when wk and wv are
replicated (``spec_for``'s fallback) every rank projects all K heads
and keeps its own.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import parallel
from repro_torch.models.layers import (apply_rope, dtype_of, init_weight,
                                       l2norm)
from repro_torch.sharding import batch_rows, constrain_here


def init_attention(cfg, gen: torch.Generator, device,
                   cross: bool = False) -> dict:
    """The reference's ``abstract_attention`` materialized: wq, wk, wv, wo
    (D, H*hd) / (D, K*hd) / (H*hd, D), qk-norm scales one; a
    cross-attention layer's ``gate_attn`` a 0-d leaf in the config's
    dtype, zero as the reference initializes it (tanh(0) = 0: a fresh
    cross-attention layer adds nothing)."""
    dt = dtype_of(cfg)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {n: init_weight(shape, dt, gen, device) for n, shape in (
        ("wq", (D, H * hd)), ("wk", (D, K * hd)), ("wv", (D, K * hd)),
        ("wo", (H * hd, D)))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
    if cross:
        p["gate_attn"] = torch.zeros((), dtype=dt, device=device)
    return p


def project_q(params, x: torch.Tensor, cfg, positions=None,
              rope: bool = True) -> torch.Tensor:
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, -1, cfg.head_dim)
    return _finish_q(params, q, cfg, positions, rope)


def _finish_q(params, q: torch.Tensor, cfg, positions, rope: bool = True):
    if cfg.qk_norm:
        q = l2norm(q) * params["q_norm"].to(q.dtype)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(params, x: torch.Tensor, cfg, positions=None,
               rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.head_dim
    k = (x @ params["wk"]).reshape(B, S, -1, hd)
    v = (x @ params["wv"]).reshape(B, S, -1, hd)
    return _finish_k(params, k, cfg, positions, rope), v


def _finish_k(params, k: torch.Tensor, cfg, positions, rope: bool):
    if cfg.qk_norm:
        k = l2norm(k) * params["k_norm"].to(k.dtype)
    if rope and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k


def output_proj(params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"]


def heads_split(params, cfg) -> bool:
    """Whether wq's columns are split over the model axis."""
    return params["wq"].shape[-1] != cfg.num_heads * cfg.head_dim


def head_group(H: int, tp: int, rank: int) -> tuple[int, int]:
    """(first, count) of the query heads that rank ``rank`` of ``tp``
    computes: [r c, min(H, (r + 1) c)) with c = ceil(H / tp), the
    reference's padded head group; H / tp each when tp divides H, and
    none on a rank whose group starts past the last head."""
    per = -(-H // tp)
    first = min(H, rank * per)
    return first, min(H, first + per) - first


def _local_kv_heads(k, v, first: int, Hl: int, G: int):
    """Of all K kv heads, those of query heads [first, first + Hl) (query
    head h reads kv head h // G): a contiguous run when the heads read
    one kv head or whole groups of G (GQA on the run), else one kv head
    per query head."""
    lo, hi = first // G, (first + Hl - 1) // G + 1
    if hi - lo == 1 or (first % G == 0 and Hl % G == 0):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.arange(first, first + Hl, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _split_qkv(p, h, cfg, positions, ax):
    """This rank's q (B, S, Hl, hd), its heads [first, first + Hl)
    (``head_group``), the k, v they read, and this rank's columns of the
    KV cache (B, S, cols): the cache's ``kv`` dim placed as wk's columns
    are (``ACT_RULES`` and ``PARAM_RULES`` both put ``kv`` on
    ``model``), all K heads where they are replicated, the rank's slice
    of the whole k, v (after qk-norm and rope, which read whole heads)
    where wk's columns cut a head, under the model axis ``ax``."""
    tp = ax.world
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, _ = h.shape
    G = H // K
    first, Hl = head_group(H, tp, ax.rank)
    # replicated leaves read by this rank's heads only: partial gradients
    pp = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            pp[name] = parallel.copy(p[name], ax)
    hf = parallel.copy(h, ax)
    if H % tp == 0:
        q = constrain_here(project_q(pp, hf, cfg, positions),
                           ("batch", None, "heads", None),
                           (batch_rows(B), S, H, hd))
    else:                                      # wq's columns cut a head
        q = parallel.gather_scatter(hf @ p["wq"], -1, ax)
        q = q[..., first * hd:(first + Hl) * hd].reshape(B, S, Hl, hd)
        q = _finish_q(pp, q, cfg, positions)
    kcols = p["wk"].shape[-1]
    if kcols == K * hd:                        # wk, wv replicated
        pp["wk"] = parallel.copy(p["wk"], ax)
        pp["wv"] = parallel.copy(p["wv"], ax)
        k, v = project_kv(pp, hf, cfg, positions)
        cache = (k.reshape(B, S, -1), v.reshape(B, S, -1))
    elif K % tp == 0:                          # kv heads split with q's
        k, v = project_kv(pp, hf, cfg, positions)
        k = constrain_here(k, ("batch", None, "kv", None),
                           (batch_rows(B), S, K, hd))
        return q, k, v, (k.reshape(B, S, -1), v.reshape(B, S, -1))
    else:                                      # wk's columns cut a head
        k = parallel.gather_scatter(hf @ p["wk"], -1, ax).reshape(
            B, S, K, hd)
        v = parallel.gather_scatter(hf @ p["wv"], -1, ax).reshape(
            B, S, K, hd)
        k = _finish_k(pp, k, cfg, positions, True)
        cache = tuple(t.reshape(B, S, -1).narrow(-1, ax.rank * kcols, kcols)
                      for t in (k, v))
    if Hl == 0:
        # no head here: empty k, v that keep the gathers' backward (a
        # collective every rank joins) on this rank's graph
        return q, k[:, :, :0], v[:, :, :0], cache
    k, v = _local_kv_heads(k, v, first, Hl, G)
    return q, k, v, cache


def _to_wo_rows(o: torch.Tensor, p, cfg, ax) -> torch.Tensor:
    """A rank's heads' outputs (B, S, Hl * hd) -> its rows of wo's even
    split: each rank's head group padded to ceil(H / tp) heads with
    zeros, all-gathered (the heads then lie in order), and the rank's
    rows taken; the gradient is summed over ``model`` back to each
    rank's heads."""
    hd, per = cfg.head_dim, -(-cfg.num_heads // ax.world)
    o = torch.nn.functional.pad(o, (0, per * hd - o.shape[-1]))
    rows = p["wo"].shape[0]
    return parallel.gather_scatter(o, -1, ax).narrow(-1, ax.rank * rows,
                                                     rows)


def self_attention(p, h: torch.Tensor, cfg, positions, *, causal: bool,
                   window: int | None, impl: str | None = None):
    """A self-attention sub-block on h (B, S, D): (output (B, S, D),
    (k, v)): as K6 read them, (B, S, K, hd); split over the model axis
    when wq's columns are (``heads_split``), this rank's columns of the
    KV cache, (B, S, cols) (``_split_qkv``).  A rank with no head
    (``head_group``) launches no K6.  Under a batch split the rank's
    heads see the rank's rows only: B is its rows."""
    if not heads_split(p, cfg):
        q = project_q(p, h, cfg, positions)
        k, v = project_kv(p, h, cfg, positions)
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                impl=impl)
        return output_proj(p, o), (k, v)
    ax = parallel.require_axis()
    q, k, v, cache = _split_qkv(p, h, cfg, positions, ax)
    B, S = q.shape[:2]
    if q.shape[2]:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                impl=impl).reshape(B, S, -1)
    else:                                      # in the graph, as k and v
        o = (q + k + v).reshape(B, S, 0)
    return _split_out(o, p, cfg, ax), cache


def _split_out(o: torch.Tensor, p, cfg, ax) -> torch.Tensor:
    """The rank's heads' outputs (B, S, Hl * hd) through its rows of wo,
    summed over ``model``."""
    B, S = o.shape[:2]
    if cfg.num_heads % ax.world:
        o = _to_wo_rows(o, p, cfg, ax)
    else:
        o = constrain_here(o, ("batch", None, "heads"),
                           (batch_rows(B), S, cfg.num_heads * cfg.head_dim))
    return parallel.reduce(output_proj(p, o), ax)


def decode_self_attention(p, h: torch.Tensor, cfg, positions,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, window: int | None,
                          seq=None) -> torch.Tensor:
    """One token's self-attention sub-block on h (B, 1, D) against a
    layer's cache (B, S, cols): the token's k, v written in place at
    ``pos``, then ``decode_attention`` over the visible keys; returns
    (B, 1, D).  Split over the model axis as ``self_attention``: the
    cache holds this rank's columns (``_split_qkv``); its query heads
    read their own kv heads from it when ``model`` divides K, else from
    the visible part of the cache gathered over ``model`` (where wk's
    columns cut a head) or from the whole one (where they are
    replicated).  ``seq`` (data axis, first position): the cache is this
    rank's block [first, first + S) of a sequence split over ``data``
    (``long_500k``); the token is written by the rank whose block holds
    ``pos``, the visible part is the block's, in block-local rows, and
    ``decode_attention`` combines the ranks."""
    B = h.shape[0]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    first = None if seq is None else seq[1]
    if not heads_split(p, cfg):
        q = project_q(p, h, cfg, positions)
        k_new, v_new = project_kv(p, h, cfg, positions)
        update_cache(cache_k, cache_v, k_new.reshape(B, 1, K * hd),
                     v_new.reshape(B, 1, K * hd), pos, first)
        S = cache_k.shape[1]
        o = decode_attention(
            q, cache_k.reshape(B, S, K, hd), cache_v.reshape(B, S, K, hd),
            valid_len=pos + 1, window=window, seq=seq)
        return output_proj(p, o)
    ax = parallel.require_axis()
    q, _, _, (kc, vc) = _split_qkv(p, h, cfg, positions, ax)
    update_cache(cache_k, cache_v, kc, vc, pos, first)
    lead, Hl = head_group(cfg.num_heads, ax.world, ax.rank)
    cols = cache_k.shape[-1]
    if K % ax.world == 0 and cols != K * hd:   # the rank's own kv heads
        S = cache_k.shape[1]
        o = decode_attention(q, cache_k.reshape(B, S, cols // hd, hd),
                             cache_v.reshape(B, S, cols // hd, hd),
                             valid_len=pos + 1, window=window, seq=seq)
        return _split_out(o.reshape(B, 1, -1), p, cfg, ax)
    # the rows up to ``pos`` (under ``seq`` the block's visible rows),
    # gathered over ``model`` where wk's columns cut a head: every model
    # rank joins the gather, a rank with no head too; the ranks of one
    # block skip it together where the block holds no visible row
    lo = 0 if window is None or seq is None else max(0, pos + 1 - window)
    a, b = _visible(lo, pos + 1, first or 0, cache_k.shape[1])
    ks, vs = cache_k[:, a:b], cache_v[:, a:b]
    if cols != K * hd and b > a:               # columns that cut a head
        ks, vs = ax.gather_dim(ks, -1), ax.gather_dim(vs, -1)
    elif cols != K * hd:
        ks = vs = ks.new_empty((B, 0, K * hd))
    if Hl == 0:
        return _split_out(q.reshape(B, 1, 0), p, cfg, ax)
    S = ks.shape[1]
    ks, vs = _local_kv_heads(ks.reshape(B, S, K, hd),
                             vs.reshape(B, S, K, hd), lead, Hl,
                             cfg.num_heads // K)
    if seq is not None:
        seq = (seq[0], first + a)
    o = decode_attention(q, ks, vs, valid_len=pos + 1, window=window,
                         seq=seq)
    return _split_out(o.reshape(B, 1, -1), p, cfg, ax)


def _visible(lo: int, hi: int, first: int, S: int) -> tuple[int, int]:
    """The rows [a, b) of a block of positions [first, first + S) that
    lie in [lo, hi), in block-local rows (a == b where none does)."""
    a = min(max(lo - first, 0), S)
    return a, max(a, min(hi - first, S))


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        impl: str | None = None) -> torch.Tensor:
    """Flash-style attention.  q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with K|H."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, impl=impl)


def decode_attention(q1: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, *, valid_len: int,
                     window: int | None = None,
                     scale: float | None = None, seq=None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q1: (B,1,H,hd); cache_k/v: (B,S,K,hd) with the new token's k/v already
    written at position ``valid_len - 1``.  Only the visible keys are read
    (positions < valid_len and, with a window, > valid_len - 1 - window):
    the reference masks the rest to -1e30, whose softmax weight is exactly
    0.  The reference's rounding is kept: logits in f32 from the operands
    (an f32 copy of the visible cache, exact for bf16), p cast to the
    cache's dtype before P.V with f32 sums.

    ``seq`` (a ``train.ranks.DataAxis``, first): the cache holds global
    positions [first, first + S) of a sequence split over that axis,
    every rank its block, each with the same q1.  The softmax is the
    one a single device would take, combined as XLA partitions the
    reference's: the logits' max all-reduced over the axis, each rank's
    exp(l - max) over its visible keys (none on a rank whose block the
    window or ``valid_len`` leaves out: zero weight, no NaN), their f32
    sum all-reduced in rank order, p = e / sum cast to the cache's dtype,
    the f32 P.V partials summed in rank order.  Every rank returns the
    same bits.
    """
    B, _, H, hd = q1.shape
    K = cache_k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    lo = max(0, valid_len - window) if window is not None else 0
    first = 0 if seq is None else seq[1]
    a, b = _visible(lo, valid_len, first, cache_k.shape[1])
    ck = cache_k[:, a:b].to(torch.float32)
    cv = cache_v[:, a:b]
    qg = q1.reshape(B, K, G, hd).to(torch.float32)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, ck) * scale
    if seq is None:
        p = torch.softmax(logits, dim=-1).to(cv.dtype)
    else:
        ax = seq[0]
        top = logits.amax(dim=-1) if b > a else logits.new_full(
            logits.shape[:-1], -math.inf)
        ax.all_reduce_max(top)
        e = torch.exp(logits - top[..., None])
        total = ax.all_reduce_ordered(e.sum(dim=-1))
        p = (e / total[..., None]).to(cv.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(torch.float32),
                     cv.to(torch.float32))
    if seq is not None:
        o = seq[0].all_reduce_ordered(o)
    return o.reshape(B, 1, H, hd).to(q1.dtype)


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int,
                 first: int | None = None) -> None:
    """Write the new tokens' k/v (B, T, K*hd) at positions pos.. in place
    (the reference's functional ``dynamic_update_slice``).  ``first``:
    the cache is a rank's block of a sequence split over ``data``,
    starting at global position ``first``: only the positions that fall
    in the block are written (none on the other ranks)."""
    T = k_new.shape[1]
    if first is None:
        cache_k[:, pos:pos + T] = k_new
        cache_v[:, pos:pos + T] = v_new
        return
    a, b = _visible(pos, pos + T, first, cache_k.shape[1])
    if b > a:
        off = first + a - pos
        cache_k[:, a:b] = k_new[:, off:off + b - a]
        cache_v[:, a:b] = v_new[:, off:off + b - a]
