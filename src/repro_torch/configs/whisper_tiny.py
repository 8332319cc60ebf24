"""whisper-tiny [audio] — 4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.

Encoder-decoder; the conv frame frontend is a STUB per the brief —
``input_specs()`` provides precomputed frame embeddings
(B, num_encoder_positions=1500, d_model).  [arXiv:2212.04356; unverified]

decode_32k / prefill_32k exercise the decoder mechanically even though the
released model caps at 448 decoder positions (noted in DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,              # decoder depth
        encoder_layers=4,
        num_encoder_positions=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        rope_theta=10_000.0,       # learned-abs in the paper; rotary stand-in
        tie_embeddings=True,
        sub_quadratic=False,
    )
)
