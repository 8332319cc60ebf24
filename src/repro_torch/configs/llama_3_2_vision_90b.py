"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a STUB per the brief: ``input_specs()`` supplies
precomputed patch embeddings (B, num_vision_tokens, d_model); the config
describes the transformer backbone only.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500_000.0,
        cross_attn_period=5,       # every 5th layer cross-attends patch embeds
        num_vision_tokens=1601,
        tie_embeddings=False,
        sub_quadratic=False,       # long_500k skipped (full attention)
        notes="vision frontend stubbed; 20 of 100 layers are cross-attention",
    )
)
