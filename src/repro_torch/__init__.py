"""PyTorch / CUDA port of the randomized reactive-redundancy engine.

``run_batch(specs, device=...)`` runs B protocol trials on an NVIDIA
GPU (Hopper, ``sm_90a``) with hand-written CUDA kernels, or on the CPU
with their plain PyTorch versions when asked (``device="cpu"``).  The
JAX package ``repro`` is the reference this port is held against; the
port imports nothing of it.
"""
from repro_torch.core.engine import BatchResult, FaultEvent, TrialSpec  # noqa: F401
from repro_torch.core.engine_torch import run_batch  # noqa: F401
