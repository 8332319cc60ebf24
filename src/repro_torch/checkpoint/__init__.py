"""The port's atomic checkpoints (``repro.checkpoint``'s exports)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore,
    save,
)
