"""tpugnn_torch: the PyTorch/CUDA port of tpugnn's GNN decoder.

Runs the decode path (graph -> syndrome sampling -> embed -> R fused message
rounds in one hand-written CUDA kernel -> heads -> corrections -> Monte-Carlo
failure counts) and the training path (``tpugnn_torch.train``: the rounds'
forward and backward in two more hand-written kernels) on an NVIDIA Hopper
card; every entry point takes ``device="cpu"`` to run the plain PyTorch
versions instead.  Imports nothing of JAX or of ``tpugnn``.
"""

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

__all__ = ["CodeConfig", "ExperimentConfig", "ModelConfig", "TrainConfig"]
