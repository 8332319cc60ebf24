"""Model / run configuration system.

One ``ModelConfig`` describes any architecture in the assigned pool: dense
GQA transformers, MoE, SSM (Mamba2/SSD), hybrid (Jamba), encoder-decoder
(Whisper) and VLM backbones (Llama-3.2-Vision).  Layer heterogeneity is
expressed by small periodic patterns (``global_period``, ``attn_period``,
``cross_attn_period``, ``moe.period``) from which :func:`layer_kinds` derives
the concrete per-layer (mixer, ffn) kinds, and :func:`layer_groups` derives
the maximal scan-able periodic grouping used by the model code.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Literal, Optional

Mixer = Literal["attn", "attn_local", "mamba", "cross_attn"]
Ffn = Literal["mlp", "moe", "none"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    period: int = 1        # MoE on layers with idx % period == offset
    offset: int = 0
    shared_expert: bool = False  # extra always-on dense expert (Llama-4 style)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256       # SSD chunk length
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 4096         # window for attn_local layers
    global_period: int = 0             # every Nth layer full/global attn (gemma3: 6); 0 = all global
    attn_period: int = 0               # hybrid: attention on idx % attn_period == attn_offset, else mamba; 0 = all attn
    attn_offset: int = 0
    cross_attn_period: int = 0         # vlm: cross-attn layer every Nth layer; 0 = none
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0            # >0 -> encoder-decoder (audio)
    num_encoder_positions: int = 1500  # stub frontend sequence length
    num_vision_tokens: int = 1601      # stub patch-embedding count (vlm)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    sub_quadratic: bool = False        # eligible for the long_500k shape
    unroll_layers: bool = False        # python-unroll scans (dry-run cost accounting)
    remat: bool = True                 # activation checkpointing, a layer at a time
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ----------------------------------------------------------
    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        moe = (
            dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff=64,
            )
            if self.moe
            else None
        )
        ssm = (
            dataclasses.replace(self.ssm, d_state=16, head_dim=8, chunk=16)
            if self.ssm
            else None
        )
        period = max(
            1,
            self.global_period or 1,
            self.attn_period or 1,
            self.cross_attn_period or 1,
            self.moe.period if self.moe else 1,
        )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 * period),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            sliding_window=32,
            moe=moe,
            ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            num_encoder_positions=24,
            num_vision_tokens=17,
        )


@dataclass(frozen=True)
class LayerKind:
    mixer: Mixer
    ffn: Ffn

    @property
    def tag(self) -> str:
        return f"{self.mixer}+{self.ffn}"


def layer_kinds(cfg: ModelConfig, num_layers: int | None = None) -> list[LayerKind]:
    """Concrete (mixer, ffn) kind of every decoder layer, in order."""
    n = cfg.num_layers if num_layers is None else num_layers
    kinds = []
    for i in range(n):
        if cfg.attn_period and (i % cfg.attn_period) != cfg.attn_offset:
            mixer: Mixer = "mamba"
        elif cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.cross_attn_period and (i % cfg.cross_attn_period) == (
            cfg.cross_attn_period - 1
        ):
            mixer = "cross_attn"
        elif cfg.global_period and (i % cfg.global_period) != (cfg.global_period - 1):
            mixer = "attn_local"
        else:
            mixer = "attn"
        if cfg.d_ff == 0 and cfg.moe is None:
            ffn: Ffn = "none"
        elif cfg.moe and (i % cfg.moe.period) == cfg.moe.offset:
            ffn = "moe"
        else:
            ffn = "mlp"
        kinds.append(LayerKind(mixer, ffn))
    return kinds


@dataclass(frozen=True)
class LayerGroup:
    """``repeats`` copies of a fixed ``pattern`` of layer kinds, scanned."""

    pattern: tuple[LayerKind, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


def layer_groups(cfg: ModelConfig, num_layers: int | None = None) -> list[LayerGroup]:
    """Split the layer stack into maximal periodic groups for lax.scan.

    The stack is scanned over ``repeats`` with the (short) pattern unrolled
    inside the scan body, so compile size is O(period) instead of O(L).
    A non-periodic tail becomes its own repeats=1 group.
    """
    kinds = layer_kinds(cfg, num_layers)
    n = len(kinds)
    if n == 0:
        return []
    # Find the smallest period p (<= 16) such that kinds is p-periodic over a
    # maximal prefix; the remainder becomes a tail group.
    best_p = n
    for p in range(1, min(16, n) + 1):
        if all(kinds[i] == kinds[i % p] for i in range(n - (n % p))):
            best_p = p
            break
    reps = n // best_p
    groups = [LayerGroup(tuple(kinds[:best_p]), reps)]
    tail = kinds[reps * best_p :]
    if tail:
        groups.append(LayerGroup(tuple(tail), 1))
    assert sum(g.num_layers for g in groups) == n
    return groups


# ---------------------------------------------------------------------------
# Input shapes (assigned shape pool)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell is run; reason if skipped (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (triggers registration imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs  # noqa: F401

    return sorted(_REGISTRY)
