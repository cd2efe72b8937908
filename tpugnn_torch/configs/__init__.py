from tpugnn_torch.configs.config import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

__all__ = ["CodeConfig", "ExperimentConfig", "ModelConfig", "TrainConfig"]
