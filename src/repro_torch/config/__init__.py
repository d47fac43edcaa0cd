from repro_torch.config.base import (
    FLConfig,
    InputShape,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    get_arch,
    list_archs,
    register_arch,
)

__all__ = [
    "ModelConfig",
    "FLConfig",
    "MeshConfig",
    "TrainConfig",
    "InputShape",
    "register_arch",
    "get_arch",
    "list_archs",
]
