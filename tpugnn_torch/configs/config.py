"""Config dataclasses of the decoder (the JAX package's, minus training).

Plain frozen dataclasses with the same names, fields and defaults as
``tpugnn.configs.config`` for everything the decode path reads; the training
and mesh configs are left out until the port trains.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CodeConfig", "ModelConfig", "ExperimentConfig"]


@dataclass(frozen=True)
class CodeConfig:
    """Which QEC code instance to decode."""

    family: str = "surface"
    distance: int = 3
    p: float = 0.05                 # depolarizing rate
    pad_nodes: int = 8
    pad_edges: int = 128


@dataclass(frozen=True)
class ModelConfig:
    """GNN decoder architecture."""

    hidden: int = 128               # node state width
    msg_hidden: int = 128           # edge-message MLP hidden width
    rounds: int = 8                 # weight-tied message-round count
    weight_tied: bool = True
    update: str = "mlp"             # residual MLP + LayerNorm
    aggr: str = "sum"
    backend: str = "fused"          # parameter layout of the weights
    readout: str = "both"           # per_qubit | logical | both
    qubit_head: str = "bits"        # bits (ex, ez sigmoids) | pauli4 (I/X/Z/Y)
    dtype: str = "float32"          # node-state storage type in the rounds


@dataclass(frozen=True)
class ExperimentConfig:
    code: CodeConfig = CodeConfig()
    model: ModelConfig = ModelConfig()
