"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global attention (sliding window 512 on local layers, every 6th
layer global), qk-norm, head_dim=256.  [hf:google/gemma-3-1b-pt; unverified]

Sliding-window local attention on 25/26 of depth makes the arch effectively
sub-quadratic, so the ``long_500k`` cell IS run for it (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        qk_norm=True,
        rope_theta=1_000_000.0,
        sliding_window=512,
        global_period=6,          # 5 local : 1 global
        tie_embeddings=True,
        sub_quadratic=True,
        notes="5:1 local:global; 128k context in the released model",
    )
)
