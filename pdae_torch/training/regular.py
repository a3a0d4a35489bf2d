"""The regular (unconditional or class-conditional) DDPM trainer: the port of
``pdae_tpu/training/regular.py``.

* The UNet is built from ``denoise_fn_config`` and initialised from the seed
  (``utils/rng.py``'s ``INIT`` stream).
* Each step is ``make_regular_train_step``: the epsilon-MSE of
  ``gd.regular_train_one_batch`` over ``num_iterations`` micro-batches, with
  the batch's class ``condition`` when ``num_class`` is set, the UNet in
  train mode (dropout seeded per (seed, step)), Adam or AdamW, and the EMA
  every ``ema_every`` steps; the UNet computes in the trainer's
  ``_compute_dtype`` and its forward runs under ``runner_config.remat``.
* ``evaluate`` writes ``samples/step-{N}.png``: a DDIM-100 grid of
  ``num_generations`` samples from the EMA weights, from x_T drawn with
  (seed, ``EVAL``, N); a conditional model cycles through its classes. Under
  several processes each rank samples its share and the primary writes the
  grid.
* Checkpoints hold ``denoise_fn``, ``ema_denoise_fn``, ``optimizer`` and
  ``step`` in the flax and optax layouts.
"""

from __future__ import annotations

import os
import time

import torch

from ..diffusion import GaussianDiffusion
from ..models import build_denoise_fn
from ..utils import save_image_grid, to_uint8, unet_state_dict, unet_tree
from ..utils.image import make_grid
from ..utils.rng import EVAL, generator
from .base import init_on_cpu, with_weights
from .stage import StageTrainer
from .steps import make_regular_train_step


class RegularDiffusionTrainer(StageTrainer):

    params_key, ema_key = "denoise_fn", "ema_denoise_fn"
    to_tree, to_state_dict = staticmethod(unet_tree), staticmethod(unet_state_dict)

    def _build(self):
        self.gd = GaussianDiffusion(self.config["diffusion_config"])
        ds = self.config["train_dataset_config"]
        size, chans = int(ds["image_size"]), int(ds["image_channel"])
        self.sample_shape = (chans, size, size)
        self._train_module(init_on_cpu(self.seed, 0, lambda: build_denoise_fn(
            self.config["denoise_fn_config"], dtype=self._compute_dtype())))
        self.num_class = (self.model.label_emb.num_embeddings
                          if hasattr(self.model, "label_emb") else None)
        self._step_fn = make_regular_train_step(
            self.gd, self.model, self.optimizer, ema_decay=self.ema_decay,
            num_iters=self.num_iterations, device=self.device, ema_every=self.ema_every,
            remat=self.runner_config.get("remat"), **self._data_parallel())

    def _step_batch_keys(self):
        return ("x_0", "condition") if self.num_class is not None else ("x_0",)

    def _step(self, batch, ema=None):
        return {"prediction_loss": self._step_fn(
            self.state, batch["x_0"], self._train_gen.generator,
            condition=batch.get("condition"), ema=ema)}

    def evaluate(self, step: int, ddim_style: str = "ddim100"):
        t0 = time.perf_counter()
        n = int(self.dataloader_config.get("eval", {}).get("num_generations", 36))
        x_T = torch.randn((n,) + self.sample_shape, device=self.device,
                          generator=generator(self.seed, EVAL, step, self.device))
        cond = (torch.arange(n, device=self.device) % self.num_class
                if self.num_class is not None else None)
        mine = self._eval_shard(n)
        x_T, cond = x_T[mine], None if cond is None else cond[mine]

        def sample(model, x_T, cond):
            return self.gd.regular_ddim_sample(ddim_style, model, x_T, cond)

        self.model.eval()
        try:
            with torch.inference_mode():
                imgs = with_weights({"model": self.model}, {"model": self.ema_weights()},
                                    sample, x_T, cond)
        finally:
            self.model.train()
        grid = self._gather_eval_images(to_uint8(imgs.permute(0, 2, 3, 1).cpu().numpy()))
        self.eval_seconds.append(time.perf_counter() - t0)
        if grid is None:
            return
        save_image_grid(grid, os.path.join(self.run_path, "samples", f"step-{step}.png"))
        self.logger.image(step, "samples", make_grid(grid))
