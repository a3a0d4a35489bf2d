"""The representation-learning trainer of the port (``pdae_tpu/training``)."""

from .artifacts import (graft_ddpm_into_decoder, load_ddpm_params, load_latent_stats,
                        load_pdae, resolve_model_config)
from .base import BaseTrainer
from .partition import split_params, split_shift_unet, trainable_params
from .representation import RepresentationLearningTrainer
from .state import (TrainState, accumulate_grads, ema_update, make_optimizer,
                    maybe_ema_update, parse_adam_betas)
from .steps import make_representation_train_step

__all__ = ["graft_ddpm_into_decoder", "load_ddpm_params", "load_latent_stats",
           "load_pdae", "resolve_model_config", "BaseTrainer",
           "RepresentationLearningTrainer", "split_params", "split_shift_unet",
           "trainable_params", "TrainState", "accumulate_grads", "ema_update",
           "make_optimizer", "maybe_ema_update", "parse_adam_betas",
           "make_representation_train_step"]
