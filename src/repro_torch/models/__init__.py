"""Decoder models of the port, dense, MoE, Mamba2 and hybrid: layers,
attention (prefill through K6), the MoE layer (``moe``), the Mamba2 SSD
block (``ssm``), the layer stack, the model facade (serving, and the
training loss in the reference's stacked layout) and the converters
from the JAX package's parameters."""
from repro_torch.models.convert import (  # noqa: F401
    from_jax_params,
    from_jax_train_params,
)
from repro_torch.models.model import (  # noqa: F401
    allocate_cache,
    decode_step,
    forward,
    init,
    init_train,
    layer_views,
    prefill,
    stack_layers,
    train_loss,
)
