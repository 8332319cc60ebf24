"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 on every other layer; Mamba:attention 7:1
interleave (one attention layer per 8-layer block).

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn_period=8,             # layer idx % 8 == attn_offset -> attention
        attn_offset=4,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336, period=2, offset=1),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=False,
        sub_quadratic=True,        # 28/32 layers are Mamba -> long_500k runs
    )
)
