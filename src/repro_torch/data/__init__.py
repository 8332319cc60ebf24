"""The port's synthetic data pipeline (``repro.data``'s exports)."""
from repro_torch.data.pipeline import (  # noqa: F401
    global_batch_for_step,
    worker_batches,
)
