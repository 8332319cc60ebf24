"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 with a shared expert, interleaved with
dense layers (MoE on every other layer, Llama-4 style).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=500_000.0,
        moe=MoEConfig(
            num_experts=128, top_k=1, d_ff=8192, period=2, offset=1,
            shared_expert=True,
        ),
        tie_embeddings=False,
        sub_quadratic=False,
        notes="interleaved dense/MoE; MoE layers carry a shared expert",
    )
)
