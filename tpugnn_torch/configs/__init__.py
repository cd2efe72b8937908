from tpugnn_torch.configs.config import CodeConfig, ExperimentConfig, ModelConfig

__all__ = ["CodeConfig", "ExperimentConfig", "ModelConfig"]
