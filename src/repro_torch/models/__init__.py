"""Dense decoder models of the port: layers, attention (prefill through
K6), the layer stack, the model facade and the converter from the JAX
package's parameters."""
from repro_torch.models.convert import from_jax_params  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    allocate_cache,
    decode_step,
    forward,
    init,
    prefill,
)
