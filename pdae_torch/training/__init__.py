"""The four trainers of the port (``pdae_tpu/training``): the regular DPM,
PDAE representation learning, the latent DPM and the manipulation
classifier."""

from .artifacts import (graft_ddpm_into_decoder, load_ddpm_params, load_latent_stats,
                        load_pdae, resolve_model_config)
from .base import BaseTrainer
from .latent import LatentDiffusionTrainer
from .manipulation import ManipulationTrainer
from .partition import split_params, split_shift_unet, trainable_params
from .regular import RegularDiffusionTrainer
from .representation import RepresentationLearningTrainer
from .state import (TrainState, accumulate_grads, ema_update, make_optimizer,
                    maybe_ema_update, parse_adam_betas)
from .steps import (make_latent_train_step, make_manipulation_train_step,
                    make_regular_train_step, make_representation_train_step, remat_wrap)

__all__ = ["graft_ddpm_into_decoder", "load_ddpm_params", "load_latent_stats",
           "load_pdae", "resolve_model_config", "BaseTrainer",
           "RegularDiffusionTrainer", "RepresentationLearningTrainer",
           "LatentDiffusionTrainer", "ManipulationTrainer", "split_params",
           "split_shift_unet", "trainable_params", "TrainState", "accumulate_grads",
           "ema_update", "make_optimizer", "maybe_ema_update", "parse_adam_betas",
           "make_regular_train_step", "make_representation_train_step",
           "make_latent_train_step", "make_manipulation_train_step", "remat_wrap"]
