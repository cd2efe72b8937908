"""Training of the decoder on the port: loss, optimizer, loop, checkpoints."""

from tpugnn_torch.configs import TrainConfig
from tpugnn_torch.train.checkpoint import CheckpointManager
from tpugnn_torch.train.loop import TrainState, ema_update, loss_fn, train, train_step
from tpugnn_torch.train.optim import OptaxAdamW, make_optimizer, warmup_cosine_decay

__all__ = ["train", "loss_fn", "make_optimizer", "TrainConfig", "TrainState",
           "train_step", "ema_update", "CheckpointManager", "OptaxAdamW",
           "warmup_cosine_decay"]
