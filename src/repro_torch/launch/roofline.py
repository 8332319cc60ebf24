"""Roofline accounting of a step on one H100, from the dry-run's counts.

Port of ``repro.launch.roofline``, redesigned for the card.  The terms,
in seconds per device per step:

  compute    = sum over input dtypes of FLOPs / the card's peak for it
  memory     = bytes accessed / HBM rate
  collective = collective bytes / NVLink rate (0 on one card)

The FLOPs and bytes come from ``launch.dryrun.StepCounter``, which
counts the step's operators eagerly (on ``meta`` tensors or on the
card alike) and takes each hand-written kernel's own count from
``kernel_cost``.  The reference reads XLA's ``cost_analysis`` and
parses its collectives out of the HLO text; torch has no HLO, so only
the ring multipliers (``ring_bytes``) are kept, for the collectives of
multi-card training to come.

Constants: NVIDIA H100 SXM data sheet (700 W): HBM3 3.35 TB/s; dense
bf16 (and f16) tensor cores 989 TFLOP/s; f32 (and f64) 67 TFLOP/s, the
CUDA cores' f32 rate, as TF32 is left off; NVLink 450 GB/s a
direction.  ``HBM_PER_CARD`` is ``torch.cuda.get_device_properties(0)
.total_memory`` as the card reported it (NVIDIA H100 80GB HBM3,
``chip_smoke.py``'s ``phase_dryrun`` prints it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# 67 TFLOP/s counts an FMA as two operations, so one add is half of it
F32_ADDS_S = F32_OPS_S / 2
BF16_OPS_S = 989e12
NVLINK_BYTES_S = 450e9
HBM_PER_CARD = 85_017_493_504

PEAK_FLOPS = {"bfloat16": BF16_OPS_S, "float16": BF16_OPS_S,
              "float32": F32_OPS_S, "float64": F32_OPS_S}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes one device puts on the wire for a collective whose result
    is ``nbytes``, over a ring of ``group`` devices (at least 2), the
    reference's multipliers:

      all-gather          result * (g-1)/g    (the gathered size)
      reduce-scatter      result * (g-1)      (the shard; g-1 partials)
      all-reduce          result * 2(g-1)/g   (reduce-scatter + gather)
      all-to-all          result * (g-1)/g
      collective-permute  result
    """
    g = max(2, int(group))
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return nbytes * 2 * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")


def bound_ms(bytes_: float, flops: float, flops_s: float) -> tuple[float, str]:
    """(the least ms the card takes to move ``bytes_`` once and do
    ``flops`` at ``flops_s``, "bytes" or "operations": which bounds)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_S * 1e3, flops / flops_s * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


class KernelCost(NamedTuple):
    flops: int      # operations, at PEAK_FLOPS[dtype]
    bytes: int      # each input read once, each output written once
    dtype: str      # the operands' dtype, which sets the peak


def attention_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head): queries aligned
    to the end of the keys, an optional sliding window."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, i + Sk - Sq) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, i + Sk - Sq - window + 1) if window else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def kernel_cost(name: str, **d) -> KernelCost:
    """FLOPs and bytes of one call of a hand-written kernel, by its
    launch name (``ops.launch_counts``), from its shape:

      gram_factors             Ie, d, T, k: three bf16 tensor-core passes
                               of 2 T Ie d; R read, SK written
      fused_step               Ie, B, d, k: 4 B Ie d + Ie d f32
      pairwise_relmax_batched  B, R, d: one division per element and pair
      pairwise_relmax          R, d: the same at B = 1
      sketch_batched           B, d, k: one signed add per element
      sketch                   d, k: the same at B = 1
      sketch_shard             d, k, dtype: the same on a shard of d
                               elements, read in their dtype (launches
                               counted as sketch_shard for bf16 and
                               sketch_shard_f32 for f32)
      coded_encode_batched     B, n_sym, m, d: 2 B n_sym m d f32
      coded_encode             n_sym, m, d: the same at B = 1
      flash_attention          B, Sq, Sk, H, K, hd, causal, window,
                               dtype: 4 B H hd per unmasked pair; q, k,
                               v read, o written

    An add counts as two FLOPs at the f32 peak (the FMA pipe's rate for
    adds: ``F32_ADDS_S``), so ``flops / PEAK_FLOPS[dtype]`` is the
    operations' time.
    """
    f32 = "float32"
    if name == "gram_factors":
        Ie, dd, T, k = d["Ie"], d["d"], d["T"], d["k"]
        return KernelCost(3 * 2 * T * Ie * dd,
                          Ie * dd * 4 + T * 4 + T * Ie * k * 4, "bfloat16")
    if name == "fused_step":
        Ie, B, dd, k = d["Ie"], d["B"], d["d"], d["k"]
        return KernelCost(4 * B * Ie * dd + Ie * dd,
                          Ie * dd * 4 + 2 * B * dd * 4 + 2 * B * Ie * 4
                          + Ie * k * 4, f32)
    if name in ("pairwise_relmax_batched", "pairwise_relmax"):
        B, R, dd = d.get("B", 1), d["R"], d["d"]
        return KernelCost(B * R * R * dd, B * R * dd * 4 + B * R * R * 4,
                          f32)
    if name in ("sketch_batched", "sketch", "sketch_shard"):
        B, dd, k = d.get("B", 1), d["d"], d["k"]
        item = 2 if d.get("dtype") == "bfloat16" else 4
        return KernelCost(2 * B * dd, B * dd * item + B * k * 4, f32)
    if name in ("coded_encode_batched", "coded_encode"):
        B, n, m, dd = d.get("B", 1), d["n_sym"], d["m"], d["d"]
        return KernelCost(2 * B * n * m * dd,
                          B * m * dd * 4 + B * n * m * 4 + B * n * dd * 4,
                          f32)
    if name == "flash_attention":
        B, Sq, Sk, H, K, hd = (d[x] for x in ("B", "Sq", "Sk", "H", "K",
                                              "hd"))
        dtype = d.get("dtype", "bfloat16")
        item = 2 if dtype in ("bfloat16", "float16") else 4
        pairs = attention_pairs(Sq, Sk, d.get("causal", True),
                                d.get("window"))
        return KernelCost(4 * B * H * hd * pairs,
                          (2 * B * Sq * H * hd + 2 * B * Sk * K * hd) * item,
                          dtype)
    raise ValueError(f"no cost for kernel {name!r}")


def kernel_bound_ms(name: str, **d) -> tuple[float, str]:
    """``bound_ms`` of one kernel call (``kernel_cost``) at its dtype's
    peak."""
    c = kernel_cost(name, **d)
    return bound_ms(c.bytes, c.flops, PEAK_FLOPS[c.dtype])


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float = 0.0     # 6*N*D (dense) / 6*N_active*D (MoE)
    chips: int = 1
    flops_by_dtype: dict | None = None   # {dtype name: FLOPs}

    @property
    def compute_s(self) -> float:
        """FLOPs over the peak of their operands' dtype (all at the bf16
        peak when no split is given)."""
        if not self.flops_by_dtype:
            return self.flops_per_device / BF16_OPS_S
        return sum(f / PEAK_FLOPS.get(dt, F32_OPS_S)
                   for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BYTES_S

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BYTES_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (over all devices)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_s / bound_s (1.0 = compute-bound)."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
            "flops_by_dtype": dict(self.flops_by_dtype or {}),
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 * N * D (dense) or 6 * N_active * D (MoE)
# ---------------------------------------------------------------------------

def active_param_count(cfg) -> int:
    """Active parameters per token (an MoE layer counts top_k of its
    num_experts, and its shared expert; embeddings counted once), on
    ``model.abstract_params``: the reference's count."""
    from repro_torch.configs.base import layer_groups
    from repro_torch.core import tree
    from repro_torch.models import model as M

    abstract = M.abstract_params(cfg)

    def count(t) -> int:
        return sum(leaf.numel() for leaf in tree.leaves(t))

    total = count(abstract["embed"]) + count(abstract["final_norm"])
    if "encoder" in abstract:
        total += count(abstract["encoder"]) + count(abstract["encoder_norm"])
    for g, slots in zip(layer_groups(cfg), abstract["decoder"]):
        for kind, slot in zip(g.pattern, slots):
            for path, leaf in tree.leaves_with_paths(slot):
                n = math.prod(leaf.shape[1:])   # one of the `repeats` rows
                keys = path.split("/")
                if kind.ffn == "moe" and "ffn" in keys \
                        and "shared" not in keys \
                        and any(k in ("gate", "up", "down") for k in keys):
                    n = n * cfg.moe.top_k // cfg.moe.num_experts
                total += n * g.repeats
    return total


def model_flops(cfg, *, tokens: int, training: bool) -> float:
    return (6.0 if training else 2.0) * active_param_count(cfg) * tokens
