"""The manipulation trainer: a linear attribute classifier over the PDAE's
normalised z, the port of ``pdae_tpu/training/manipulation.py``.

* ``Linear(latent_dim, num_classes)`` (40 CelebA-HQ attributes by default)
  trained with BCE-with-logits against ``label > 0``
  (``make_manipulation_train_step``) over the frozen EMA encoder of the
  trained PDAE, the z normalised with ``inferred_latents``' statistics; Adam
  or AdamW, the EMA every ``ema_every`` steps. The frozen models compute in
  ``_compute_dtype``, the classifier in fp32, as ``pdae_tpu`` builds it.
* ``latent_train_source: precomputed`` (needs ``device_resident`` and no
  augmentation) keeps the corpus's z and labels on the device and steps
  through ``IdentityEncoder``; ``encode`` runs the encoder in every step.
* ``evaluate`` takes the first eval image: a DDIM-500 shift encode, then a
  DDIM-200 decode with its z moved along the EMA classifier's row of
  ``class_id`` (31, "Smiling") by ``scale`` 0.3; it writes
  ``samples/sample{N//1000}k.png`` (the image, then its manipulation); on the
  primary alone under several processes (after every rank has joined the
  EMA's gather, under FSDP).
* Checkpoints hold ``classifier``, ``ema_classifier``, ``optimizer`` and
  ``step``.
"""

from __future__ import annotations

import os
import time

import torch

from ..diffusion import GaussianDiffusion
from ..models import build_classifier
from ..utils import classifier_state_dict, classifier_tree, save_image_grid, to_uint8
from ..utils.image import make_grid, x0_from_transfer
from .base import init_on_cpu
from .resident import IdentityEncoder
from .stage import StageTrainer
from .steps import make_manipulation_train_step


class ManipulationTrainer(StageTrainer):

    params_key, ema_key = "classifier", "ema_classifier"
    to_tree = staticmethod(classifier_tree)
    to_state_dict = staticmethod(classifier_state_dict)

    def _build(self):
        pdae_cfg = self._load_frozen_pdae()
        self.gd = GaussianDiffusion(self.config.get("diffusion_config",
                                                    pdae_cfg.get("diffusion_config")))
        self.num_classes = int(self.config.get("num_classes", 40))
        self._train_module(init_on_cpu(self.seed, 3, lambda: build_classifier(
            self.num_classes, self.latent_dim)))
        self.latent_source = self._latent_source()
        step_encoder = (IdentityEncoder() if self.latent_source == "precomputed"
                        else self.encoder)
        dp = self._data_parallel()
        self._step_fn = make_manipulation_train_step(
            self.gd, self.model, step_encoder, self.optimizer, self.latents_mean,
            self.latents_std, ema_decay=self.ema_decay, ema_every=self.ema_every,
            device=self.device, reduce=dp["reduce"], plan=dp["plan"])

    def _step_batch_keys(self):
        return ("x_0", "label")

    def _resident_device_data(self):
        if self.latent_source != "precomputed":
            return super()._resident_device_data()
        return self._precomputed_device_data(keys=("label",))

    def _step(self, batch, ema=None):
        return {"bce_loss": self._step_fn(self.state, batch["x_0"], batch["label"], ema=ema)}

    def evaluate(self, step: int, encode_style: str = "ddim500",
                 decode_style: str = "ddim200", class_id: int = 31, scale: float = 0.3):
        if not 0 <= class_id < self.num_classes:
            raise ValueError(f"class_id {class_id} is not one of the classifier's "
                             f"{self.num_classes} classes")
        weight = self.ema_weights(whole=True)["weight"]      # collective under FSDP/tp
        with self._whole_frozen():                           # collective under FSDP
            # under tensor or spatial parallelism the frozen PDAE runs split:
            # every rank decodes, the primary writes
            if not self.primary and self.tp_layout is None and self.sp_groups is None:
                return
            t0 = time.perf_counter()
            batch = type(self.eval_dataset).collate_fn([self.eval_dataset[0]])
            x_0 = x0_from_transfer(torch.from_numpy(batch["x_0"]).to(self.device)
                                   .permute(0, 3, 1, 2).contiguous())
            with torch.inference_mode():
                x_T = self.gd.representation_learning_ddim_encode(
                    encode_style, self.encoder, self.decoder, x_0)
                imgs = self.gd.manipulation_sample(
                    decode_style, weight, self.encoder, self.decoder, x_0, x_T,
                    self.latents_mean, self.latents_std, class_id, scale)
        if not self.primary:
            return
        grid = to_uint8(torch.cat([x_0, imgs]).permute(0, 2, 3, 1).cpu().numpy())
        save_image_grid(grid, os.path.join(self.run_path, "samples",
                                           f"sample{step // 1000}k.png"),
                        nrow=grid.shape[0])
        self.logger.image(step, "result", make_grid(grid, nrow=grid.shape[0]))
        self.eval_seconds.append(time.perf_counter() - t0)
