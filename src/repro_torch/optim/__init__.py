"""Optimizers (SGD / momentum / AdamW) and gradient compression of the
port; the exports of ``repro.optim``."""
from repro_torch.optim.optimizer import (  # noqa: F401
    OptConfig,
    abstract_opt_state,
    global_norm,
    init_opt_state,
    lr_at,
    opt_update,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_tree,
    decompress_tree,
    init_error_feedback,
)
