"""Config dataclasses of the decoder and its training (the JAX package's).

Plain frozen dataclasses with the same names, fields and defaults as
``tpugnn.configs.config``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["CodeConfig", "ModelConfig", "TrainConfig", "MeshConfig", "ExperimentConfig"]


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
    rounds: int = 8                 # fixed message-round count
    weight_tied: bool = True        # one cell reused every round
    update: str = "mlp"             # mlp (residual MLP + LayerNorm) | gru
                                    # (generic backends only)
    aggr: str = "sum"               # sum | mean | max
    # fused: the fused layout, rounds in the kernels K1/K2; segment | dense |
    # ell | pallas: the generic message-passing engine (pallas through the
    # ELL-aggregation kernels K3a/K3b).  train() maps pallas to fused.
    backend: str = "segment"
    # recompute each round in the backward (torch.utils.checkpoint) on the
    # generic engine; the fused layout keeps only the stash of round inputs
    # (K2a) and ignores it
    remat: bool = False
    readout: str = "both"           # per_qubit | logical | both
    qubit_head: str = "bits"        # bits (ex, ez sigmoids) | pauli4 (I/X/Z/Y)
    dtype: str = "float32"          # node-state storage type in the rounds


@dataclass(frozen=True)
class TrainConfig:
    """Training run (``tpugnn.configs.config.TrainConfig``)."""

    batch: int = 256
    steps: int = 2000
    lr: float = 1e-3
    warmup_steps: int = 100
    weight_decay: float = 1e-4
    seed: int = 0
    loss_qubit_weight: float = 1.0
    loss_logical_weight: float = 1.0
    eval_every: int = 500
    eval_shots: int = 4096
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    metrics_jsonl: Optional[str] = None   # one JSON line per evaluation
    profile_dir: Optional[str] = None     # torch.profiler trace of steps 10..14
    # linear noise curriculum (p_from, p_to, over_steps); None = fixed code.p
    p_curriculum: Optional[Tuple[float, float, int]] = None
    # per-shot rate p ~ Uniform[lo, hi]; exclusive with p_curriculum
    p_mix: Optional[Tuple[float, float]] = None
    # EMA of the parameters for evaluation and serving (e.g. 0.999)
    ema_decay: Optional[float] = None
    # warm start: parameters only (step 0, fresh optimizer) from a port
    # checkpoint directory or an exported weights file (.npz), when
    # checkpoint_dir holds no checkpoint of its own
    init_from: Optional[str] = None


@dataclass(frozen=True)
class MeshConfig:
    """Layout of the ranks (``tpugnn.configs.config.MeshConfig``): ``data``
    shards the syndrome batch, ``graph`` edge-partitions the Tanner graph
    (:mod:`tpugnn_torch.dist`)."""

    data: int = 1
    graph: int = 1
    axis_names: Tuple[str, str] = ("data", "graph")


@dataclass(frozen=True)
class ExperimentConfig:
    code: CodeConfig = CodeConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
