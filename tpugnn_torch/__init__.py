"""tpugnn_torch: the PyTorch/CUDA port of tpugnn's GNN decoder.

Runs the decode path (graph -> syndrome sampling -> embed -> R fused message
rounds in one hand-written CUDA kernel -> heads -> corrections -> Monte-Carlo
failure counts), the same decode with the rounds on the surface code's
raster (``tpugnn_torch.models.PallasDecoder(model, schedule=("rollgather",))``,
one more hand-written kernel), the same decode on the generic
message-passing engine (``tpugnn_torch.mp``, whose ``'pallas'`` aggregation
is two more hand-written kernels), and the training path
(``tpugnn_torch.train``: the fused rounds' forward and backward in
hand-written kernels) on an NVIDIA Hopper card; every entry point takes
``device="cpu"`` to run the plain PyTorch versions instead.  Imports nothing
of JAX or of ``tpugnn``.
"""

from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig

__all__ = ["CodeConfig", "ExperimentConfig", "ModelConfig", "TrainConfig"]
