from tpugnn_torch.configs.config import (
    CodeConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = ["CodeConfig", "ExperimentConfig", "MeshConfig", "ModelConfig", "TrainConfig"]
