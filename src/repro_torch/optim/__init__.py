"""Optimizers (SGD / momentum / AdamW) and gradient compression of the
port; the exports of ``repro.optim``, without ``abstract_opt_state``
(the reference's dry-run shapes, not ported: ROADMAP M11)."""
from repro_torch.optim.optimizer import (  # noqa: F401
    OptConfig,
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
