from .config import (
    ClassMap,
    EITConfig,
    ImageConfig,
    MeshConfig,
    ModelConfig,
    PipelineConfig,
    SimulationConfig,
)
from .device import resolve_device
from .errors import (
    EitxError,
    IngestError,
    MeshingError,
    ModelError,
    SimulationError,
)
from .timing import Timer

__all__ = [
    "ClassMap",
    "EITConfig",
    "ImageConfig",
    "MeshConfig",
    "ModelConfig",
    "PipelineConfig",
    "SimulationConfig",
    "resolve_device",
    "EitxError",
    "IngestError",
    "MeshingError",
    "ModelError",
    "SimulationError",
    "Timer",
]
