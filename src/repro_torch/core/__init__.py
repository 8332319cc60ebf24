"""Core BFT protocol of the port: replica-group assignment, the
detection codes (replication, Fig-2 linear, sketch-compressed), reactive
majority identification, the randomized check schedule with the
adaptive q*, the DRACO and gradient-filter baselines, the numpy scenario
engine and its serial reference, and the device engine facade."""
from repro_torch.core import (  # noqa: F401
    adaptive,
    assignment,
    byzantine,
    codes,
    detection,
    draco,
    efficiency,
    engine,
    filters,
    identification,
    randomized,
)
from repro_torch.core.engine import (  # noqa: F401
    BatchResult,
    FaultEvent,
    FaultPattern,
    ModeSpec,
    SCENARIOS,
    ScenarioMatrix,
    TrialSpec,
)
from repro_torch.core.engine_torch import run_batch  # noqa: F401
from repro_torch.core.randomized import BFTConfig, ProtocolState  # noqa: F401
