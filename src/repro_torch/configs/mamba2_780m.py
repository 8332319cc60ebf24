"""mamba2-780m [ssm] — 48L d_model=1536 attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) blocks; no separate FFN (d_ff=0).
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=True,
        sub_quadratic=True,        # attention-free -> long_500k runs
    )
)
