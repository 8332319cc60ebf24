"""Architecture registry — importing this package registers all configs.

A copy of the JAX package's ``repro.configs`` (the port imports nothing
of ``repro``); the configurations are data and stay equal to the
reference's, which tests/test_torch_serving.py checks.
"""
from repro_torch.configs.base import (  # noqa: F401
    LayerGroup,
    LayerKind,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    get_config,
    layer_groups,
    layer_kinds,
    list_configs,
    shape_applicable,
)

# Register every assigned architecture (+ the paper's own setting).
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    jamba_v0_1,
    llama3_2_1b,
    llama4_maverick,
    llama_3_2_vision_90b,
    mamba2_780m,
    paper_mlp,
    phi3_5_moe,
    qwen3_4b,
    starcoder2_7b,
    whisper_tiny,
)

ASSIGNED = [
    "llama-3.2-vision-90b",
    "llama3.2-1b",
    "gemma3-1b",
    "qwen3-4b",
    "starcoder2-7b",
    "phi3.5-moe-42b-a6.6b",
    "llama4-maverick-400b-a17b",
    "whisper-tiny",
    "jamba-v0.1-52b",
    "mamba2-780m",
]
