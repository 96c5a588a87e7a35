from .config import (
    DataConfig,
    LossConfig,
    ModelConfig,
    Preset,
    SamplerConfig,
    TrainConfig,
    get_preset,
    list_presets,
)

__all__ = [
    "ModelConfig",
    "LossConfig",
    "TrainConfig",
    "DataConfig",
    "SamplerConfig",
    "Preset",
    "get_preset",
    "list_presets",
]
