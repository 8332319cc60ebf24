"""The paper's own experimental setting: a small model trained by
parallelized-SGD under Byzantine workers.

The paper (Gupta & Vaidya 2019) is analytical and model-agnostic; for the
faithful-reproduction experiments we follow its framing — n workers, f
Byzantine, replication-coded gradient computation — on (a) a convex
least-squares problem (exact w* known, so *exact fault-tolerance* is
checkable) and (b) this small MLP-style transformer for the end-to-end
training run.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paper-smalllm",
        family="dense",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        head_dim=32,
        d_ff=1024,
        vocab_size=8192,
        tie_embeddings=True,
        sub_quadratic=False,
        notes="paper-faithful end-to-end BFT training target",
    )
)
