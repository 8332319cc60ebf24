"""The port's Byzantine-tolerant trainer: the fast / check / identify /
filter steps and the protocol-driven ``Trainer`` (``repro.train``'s
exports)."""
from repro_torch.train.steps import (  # noqa: F401
    AttackConfig,
    PhaseClock,
    StepConfig,
    make_check_step,
    make_fast_step,
    make_filter_step,
    make_identify_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
