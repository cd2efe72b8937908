"""Training of the decoder on the port: loss, optimizer, loop, checkpoints."""

from tpugnn_torch.configs import TrainConfig
from tpugnn_torch.train.checkpoint import CheckpointManager
from tpugnn_torch.train.loop import (
    TrainState,
    ema_update,
    init_state,
    loss_fn,
    train,
    train_model_config,
    train_step,
)
from tpugnn_torch.train.optim import OptaxAdamW, make_optimizer, warmup_cosine_decay

__all__ = ["train", "init_state", "train_model_config", "loss_fn", "make_optimizer",
           "TrainConfig", "TrainState", "train_step", "ema_update", "CheckpointManager",
           "OptaxAdamW", "warmup_cosine_decay"]
