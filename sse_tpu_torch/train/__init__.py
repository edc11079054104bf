"""Training layer: losses, train step, the training driver, metrics and
checkpoints (``train.checkpoint``) (port of ``sse_tpu.train``)."""

from sse_tpu_torch.train.losses import LossConfig, similarity_loss
from sse_tpu_torch.train.loop import (
    TrainConfig,
    TrainState,
    inference_params,
    init_train_state,
    make_train_step,
    train,
)

__all__ = [
    "LossConfig",
    "similarity_loss",
    "TrainState",
    "TrainConfig",
    "inference_params",
    "init_train_state",
    "make_train_step",
    "train",
]
