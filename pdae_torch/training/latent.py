"""The latent DPM trainer: an MLPSkipNet over the PDAE's z-space, the port of
``pdae_tpu/training/latent.py``.

* The trained PDAE's EMA encoder and decoder are read from
  ``trained_representation_learning_{config,checkpoint}`` and frozen; the z
  statistics from ``inferred_latents`` (``InferLatents``' file). The
  MLPSkipNet and both frozen models compute in ``_compute_dtype``.
* Each step is ``make_latent_train_step``: the frozen encoder's z,
  normalised, under the latent schedule's l1 loss; the MLPSkipNet in train
  mode (dropout seeded per (seed, step)), Adam or AdamW, the EMA every
  ``ema_every`` steps.
* ``runner_config.latent_train_source: precomputed`` (needs
  ``device_resident`` and no augmentation) encodes the corpus once
  (``resident.encode_corpus``, chunks of 512), keeps z on the device and
  steps through ``IdentityEncoder``; ``encode`` (the default) runs the
  encoder in every step. Under several processes every rank encodes the
  whole corpus onto its own card, JAX's replicated placement.
* ``evaluate`` writes ``samples/sample{N//1000}k.png``: ``num_generations``
  images from the EMA latent DPM, its z decoded by the frozen decoder
  (ddim100/ddim100 by default), z_T then x_T drawn with (seed, ``EVAL``, N);
  under several processes each rank samples its share of both draws and the
  primary writes the grid.
* Checkpoints hold ``latent_denoise_fn``, ``ema_latent_denoise_fn``,
  ``optimizer`` and ``step``.
"""

from __future__ import annotations

import os
import time

import torch

from ..diffusion import GaussianDiffusion
from ..models import build_latent_denoise_fn
from ..utils import (mlp_skip_net_state_dict, mlp_skip_net_tree, save_image_grid,
                     to_uint8)
from ..utils.image import make_grid
from ..utils.rng import EVAL, generator
from .base import init_on_cpu, with_weights
from .resident import IdentityEncoder
from .stage import StageTrainer
from .steps import make_latent_train_step


class LatentDiffusionTrainer(StageTrainer):

    params_key, ema_key = "latent_denoise_fn", "ema_latent_denoise_fn"
    to_tree = staticmethod(mlp_skip_net_tree)
    to_state_dict = staticmethod(mlp_skip_net_state_dict)

    def _build(self):
        pdae_cfg = self._load_frozen_pdae()
        self.gd = GaussianDiffusion(self.config.get("diffusion_config",
                                                    pdae_cfg.get("diffusion_config")))
        ds = self.config["train_dataset_config"]
        size, chans = int(ds["image_size"]), int(ds["image_channel"])
        self.sample_shape = (chans, size, size)
        self._train_module(init_on_cpu(self.seed, 2, lambda: build_latent_denoise_fn(
            self.config["latent_denoise_fn_config"], dtype=self._compute_dtype())))
        self.latent_source = self._latent_source()
        step_encoder = (IdentityEncoder() if self.latent_source == "precomputed"
                        else self.encoder)
        self._step_fn = make_latent_train_step(
            self.gd, self.model, step_encoder, self.optimizer, self.latents_mean,
            self.latents_std, ema_decay=self.ema_decay, ema_every=self.ema_every,
            num_iters=self.num_iterations, device=self.device, **self._data_parallel())

    def _step_batch_keys(self):
        return ("x_0",)

    def _resident_device_data(self):
        if self.latent_source != "precomputed":
            return super()._resident_device_data()
        return self._precomputed_device_data()

    def _step(self, batch, ema=None):
        return {"prediction_loss": self._step_fn(self.state, batch["x_0"],
                                                 self._train_gen.generator, ema=ema)}

    def evaluate(self, step: int, latent_ddim_style: str = "ddim100",
                 decoder_ddim_style: str = "ddim100"):
        t0 = time.perf_counter()
        n = int(self.dataloader_config.get("eval", {}).get("num_generations", 36))
        gen = generator(self.seed, EVAL, step, self.device)
        z_T = torch.randn((n, self.latent_dim), device=self.device, generator=gen)
        x_T = torch.randn((n,) + self.sample_shape, device=self.device, generator=gen)
        mine = self._eval_shard(n)
        z_T, x_T = z_T[mine], x_T[mine]

        def sample(model, z_T, x_T):
            return self.gd.latent_diffusion_sample(
                None, latent_ddim_style, decoder_ddim_style, model, self.decoder, x_T,
                self.latents_mean, self.latents_std, latent_dim=self.latent_dim, z_T=z_T)

        self.model.eval()
        try:
            with torch.inference_mode(), self._whole_frozen():
                imgs = with_weights({"model": self.model}, {"model": self.ema_weights()},
                                    sample, z_T, x_T)
        finally:
            self.model.train()
        grid = self._gather_eval_images(to_uint8(imgs.permute(0, 2, 3, 1).cpu().numpy()))
        self.eval_seconds.append(time.perf_counter() - t0)
        if grid is None:
            return
        save_image_grid(grid, os.path.join(self.run_path, "samples",
                                           f"sample{step // 1000}k.png"))
        self.logger.image(step, "result", make_grid(grid))
