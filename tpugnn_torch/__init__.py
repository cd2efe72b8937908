"""tpugnn_torch: the PyTorch/CUDA port of tpugnn's GNN decoder.

Runs the decode path (graph -> syndrome sampling -> embed -> R fused message
rounds in one hand-written CUDA kernel -> heads -> corrections -> Monte-Carlo
failure counts) on an NVIDIA Hopper card; every entry point takes
``device="cpu"`` to run the plain PyTorch version instead.  Imports nothing
of JAX or of ``tpugnn``.
"""

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig

__all__ = ["CodeConfig", "ExperimentConfig", "ModelConfig"]
