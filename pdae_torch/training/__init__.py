"""The representation-learning train step of the port (``pdae_tpu/training``)."""

from .partition import split_params, split_shift_unet, trainable_params
from .state import (TrainState, accumulate_grads, ema_update, make_optimizer,
                    maybe_ema_update, parse_adam_betas)
from .steps import make_representation_train_step

__all__ = ["split_params", "split_shift_unet", "trainable_params", "TrainState",
           "accumulate_grads", "ema_update", "make_optimizer", "maybe_ema_update",
           "parse_adam_betas", "make_representation_train_step"]
