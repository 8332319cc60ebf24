"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Port of ``repro.kernels.ref``: deliberately naive definitions, run on
whatever device their inputs lie on.  The sign hash is bit-exact with
the reference's uint32 arithmetic.  PyTorch on the CPU has no ``+``,
``>>`` or ``<`` on ``uint32``, so the hash runs in int64 and masks every
step with ``& 0xFFFFFFFF``; each 32-bit multiply is split into two
16-bit halves so that no int64 product can overflow.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
HASH_MUL1 = 2654435761
HASH_MUL2 = 2246822519


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a uint32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_signs_ref(idx: torch.Tensor, key_scalar) -> torch.Tensor:
    """±1 float32 signs of column positions ``idx`` under a uint32 key
    (``key_scalar`` an int, or an int64 tensor broadcasting against
    ``idx``): the reference's xorshift-multiply hash, low bit -> sign."""
    if isinstance(key_scalar, torch.Tensor):
        key = key_scalar.to(torch.int64) & _M32
    else:
        key = int(key_scalar) & _M32
    h = (_mul32(idx.to(torch.int64) & _M32, HASH_MUL1) + key) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, HASH_MUL2)
    h = h ^ (h >> 13)
    one = torch.ones((), dtype=torch.float32, device=h.device)
    return torch.where((h & 1) == 1, one, -one)


def _bucketed(flat_g: torch.Tensor, k: int) -> torch.Tensor:
    """(..., d) -> (..., d_pad) float32 with zero padding to a multiple
    of k (zero columns are inert in every sketch)."""
    d = flat_g.shape[-1]
    pad = (-d) % k
    return torch.nn.functional.pad(flat_g.to(torch.float32), (0, pad))


def sketch_ref(flat_g: torch.Tensor, key_scalar, k: int) -> torch.Tensor:
    """CountSketch of a flat vector: (d,) -> (k,); bucket = column % k."""
    g = _bucketed(flat_g, k)
    idx = torch.arange(g.shape[0], device=g.device)
    return (g * hash_signs_ref(idx, key_scalar)).reshape(-1, k).sum(dim=0)


def block_sketch_ref(block: torch.Tensor, key_scalar, k: int, cfull: int,
                     c0: int) -> torch.Tensor:
    """CountSketch of a (rows, cols) block of a row-major leaf viewed as
    (rows, cfull) from column c0, under the full leaf's flat index
    p = r * cfull + c0 + c: bucket p % k, sign hash(p).  The blocks of a
    leaf's shards sum to ``sketch_ref`` of the whole leaf.  Each row's
    signed values are placed at their bucket's column of a zero-padded
    (rows, m, k) array, which is summed as ``sketch_ref`` sums: no
    atomic adds, the same bits on every run."""
    rows, cols = block.shape
    dev = block.device
    start = torch.arange(rows, device=dev, dtype=torch.int64)[:, None] \
        * cfull + c0
    col = torch.arange(cols, device=dev, dtype=torch.int64)[None]
    vals = block.to(torch.float32) * hash_signs_ref(start + col, key_scalar)
    width = -(-(k - 1 + cols) // k) * k
    padded = torch.zeros((rows, width), dtype=torch.float32, device=dev)
    padded.scatter_(1, (start % k + col).expand(rows, cols), vals)
    return padded.reshape(rows, -1, k).sum(dim=(0, 1))


def batched_sketch_ref(flat_g: torch.Tensor, key_scalar, k: int) -> torch.Tensor:
    """(B, d) -> (B, k): per-row ``sketch_ref`` under one shared key."""
    g = _bucketed(flat_g, k)
    idx = torch.arange(g.shape[1], device=g.device)
    signed = g * hash_signs_ref(idx, key_scalar)[None]
    return signed.reshape(g.shape[0], -1, k).sum(dim=1)


def pairwise_maxdiff_ref(replicas: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, R): rel[i, j] = max_t |a - b| / (1 + min(|a|, |b|))
    over replicas a = r_i, b = r_j (agreement iff rel <= tau)."""
    a = replicas[:, None].to(torch.float32)
    b = replicas[None, :].to(torch.float32)
    rel = (a - b).abs() / (1.0 + torch.minimum(a.abs(), b.abs()))
    return rel.amax(dim=-1)


def batched_pairwise_maxdiff_ref(replicas: torch.Tensor) -> torch.Tensor:
    """(B, R, d) -> (B, R, R): per-row ``pairwise_maxdiff_ref``."""
    a = replicas[:, :, None].to(torch.float32)
    b = replicas[:, None, :].to(torch.float32)
    rel = (a - b).abs() / (1.0 + torch.minimum(a.abs(), b.abs()))
    return rel.amax(dim=-1)


def coded_encode_ref(coeffs: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """coeffs (n_sym, m) @ grads (m, d) -> symbols (n_sym, d), f32."""
    return torch.einsum("sm,md->sd", coeffs.to(torch.float32),
                        grads.to(torch.float32))


def batched_coded_encode_ref(coeffs: torch.Tensor,
                             grads: torch.Tensor) -> torch.Tensor:
    """(B, n_sym, m) @ (B, m, d) -> (B, n_sym, d), f32."""
    return torch.einsum("bsm,bmd->bsd", coeffs.to(torch.float32),
                        grads.to(torch.float32))


def batched_regroup_ref(keys, active, repl):
    """numpy oracle of ``ops.batched_regroup``: per trial, order the
    active worker ids by a stable argsort on their keys (the host
    engine's ``CounterPermuter`` contract) and group the first m*r of
    them, r consecutive workers a group.  Returns (shard (B, n) int32,
    group (B, n) int32 with -1 = idle, m (B,) int32)."""
    import numpy as np

    keys = np.asarray(keys)
    active = np.asarray(active)
    repl = np.asarray(repl)
    B, n = active.shape
    shard = np.zeros((B, n), np.int32)
    group = np.full((B, n), -1, np.int32)
    m_out = np.zeros(B, np.int32)
    for b in range(B):
        act_idx = np.flatnonzero(active[b])
        perm = act_idx[np.argsort(keys[b, act_idx], kind="stable")]
        r = max(1, int(repl[b]))
        m = len(perm) // r
        m_out[b] = m
        mem = perm[: m * r]
        gid = np.repeat(np.arange(m, dtype=np.int32), r)
        shard[b, mem] = gid
        group[b, mem] = gid
    return shard, group, m_out


def fused_step_ref(rows: torch.Tensor, W: torch.Tensor, cw: torch.Tensor,
                   key_scalar, k: int = 256):
    """Composed oracle of the fused step, from the single-op oracles:
    W' = W - coded_encode(cw, rows); resid = W' @ rows^T (the same
    contraction, transposed); sk = per-row CountSketch of the rows."""
    rows32 = rows.to(torch.float32)
    W_new = W.to(torch.float32) - coded_encode_ref(cw, rows32)
    resid = coded_encode_ref(W_new, rows32.T)
    sk = batched_sketch_ref(rows32, key_scalar, k)
    return W_new, resid, sk


def gram_factors_ref(rows: torch.Tensor, W0: torch.Tensor | None,
                     keys: torch.Tensor, k: int = 256):
    """Composed oracle of the gram precompute: G = rows @ rows^T,
    S0 = W0 @ rows^T (None without W0), SK[t] = per-row CountSketch of
    the rows under keys[t] (``keys`` int64 values of uint32 keys)."""
    rows32 = rows.to(torch.float32)
    G = rows32 @ rows32.T
    S0 = None if W0 is None else W0.to(torch.float32) @ rows32.T
    Ie = rows32.shape[0]
    if keys.shape[0] == 0:
        SK = torch.zeros((0, Ie, k), dtype=torch.float32, device=rows.device)
    else:
        SK = torch.stack([batched_sketch_ref(rows32, int(key), k)
                          for key in keys.tolist()])
    return G, S0, SK


# ---------------------------------------------------------------------------
# Flash attention (causal / windowed), GQA
# ---------------------------------------------------------------------------

# the reference's mask sentinel; finite, so a row with no visible key
# stays finite (-inf would give NaN)
NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            scale: float | None = None) -> torch.Tensor:
    """Naive full-matrix attention.  q (B,Sq,H,hd); k/v (B,Sk,K,hd)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qg = q.reshape(B, Sq, K, G, hd).to(torch.float32)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg,
                          k.to(torch.float32)) * scale
    keep = _keep(torch.arange(Sq, device=q.device)[:, None],
                 torch.arange(Sk, device=q.device)[None, :], Sq, Sk, causal,
                 window)
    logits = torch.where(keep, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.to(torch.float32))
    return o.reshape(B, K * G, Sq, hd).transpose(1, 2).to(q.dtype)


def _keep(qpos, kpos, Sq: int, Sk: int, causal: bool, window: int | None):
    """True where query qpos attends key kpos; queries align to the END
    of the keys (offset Sk - Sq: prefill continuation)."""
    keep = kpos < Sk
    if causal:
        keep = keep & (kpos <= qpos + (Sk - Sq))
    if window is not None:
        keep = keep & (kpos > qpos + (Sk - Sq) - window)
    return keep


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None, q_block: int = 1024,
                        kv_block: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention: the plain version of K6.

    Port of ``repro.models.attention.blockwise_attention`` (what the
    reference's prefill runs): query blocks in a Python loop, each
    visiting only the kv blocks its causal / window range needs; the
    running (m, l, acc) start at (-inf, 0, 0), masked logits take the
    finite sentinel -1e30, the result is acc / max(l, 1e-30).  Keys past
    Sk (the zero padding to a kv_block multiple) are masked too.  All in
    f32; the output has q's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    if B == 0 or Sq == 0 or Sk == 0 or H == 0:
        return torch.zeros_like(q)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    pad = (-Sk) % kv_block
    k32 = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, pad))
    v32 = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    offs = Sk - Sq
    outs = []
    for q0 in range(0, Sq, q_block):
        qs = min(q_block, Sq - q0)
        qg = q[:, q0:q0 + qs].reshape(B, qs, K, G, hd).to(torch.float32)
        hi_pos = q0 + qs - 1 + offs if causal else Sk - 1
        hi_pos = min(max(hi_pos, 0), Sk - 1)
        lo_pos = max(0, q0 + offs - window + 1) if window is not None else 0
        m = torch.full((B, K, G, qs), -math.inf, device=q.device)
        l = torch.zeros((B, K, G, qs), device=q.device)
        acc = torch.zeros((B, K, G, qs, hd), device=q.device)
        qpos = torch.arange(q0, q0 + qs, device=q.device)[:, None]
        for kb in range(lo_pos // kv_block, hi_pos // kv_block + 1):
            k0 = kb * kv_block
            kpos = torch.arange(k0, k0 + kv_block, device=q.device)[None, :]
            logits = torch.einsum("bqkgh,bskh->bkgqs", qg,
                                  k32[:, k0:k0 + kv_block]) * scale
            logits = torch.where(_keep(qpos, kpos, Sq, Sk, causal, window),
                                 logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, v32[:, k0:k0 + kv_block])
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.reshape(B, H, qs, hd).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
