"""The port's models, dense, MoE, Mamba2, hybrid, the VLM backbone with
cross-attention and the encoder-decoder: layers, attention (prefill,
encoder and cross-attention through K6), the MoE layer (``moe``), the
Mamba2 SSD block (``ssm``), the layer stacks, the model facade
(serving, and the training loss in the reference's stacked layout) and
the converters from the JAX package's parameters."""
from repro_torch.models.convert import (  # noqa: F401
    from_jax_params,
    from_jax_train_params,
)
from repro_torch.models.model import (  # noqa: F401
    abstract_cache,
    abstract_params,
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
