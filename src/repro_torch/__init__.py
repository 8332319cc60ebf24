"""PyTorch / CUDA port of the randomized reactive-redundancy engine.

``run_batch(specs, device=...)`` runs B protocol trials on an NVIDIA
GPU (Hopper, ``sm_90a``) with hand-written CUDA kernels, or on the CPU
with their plain PyTorch versions when asked (``device="cpu"``);
``repro_torch.serving`` serves the dense models and Mamba2 with the
audit and ``repro_torch.train`` trains them with n workers, up to f
Byzantine.  The
JAX package ``repro`` is the reference this port is held against; the
port imports nothing of it.
"""
from repro_torch.core import (  # noqa: F401
    SCENARIOS,
    BatchResult,
    BFTConfig,
    FaultEvent,
    FaultPattern,
    ModeSpec,
    ProtocolState,
    ScenarioMatrix,
    TrialSpec,
    run_batch,
)
