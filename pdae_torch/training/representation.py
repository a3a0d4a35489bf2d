"""PDAE representation learning: the semantic encoder and the ShiftUNet's
gradient branch trained on a frozen pre-trained DPM. The port of
``pdae_tpu/training/representation.py``.

* The models are built from the config and initialised from the seed
  (``utils/rng.py``'s ``INIT`` stream), then the DPM checkpoint of
  ``trained_ddpm_checkpoint`` (either package's, key ``ema_denoise_fn``) is
  grafted into the trunk with ``strict=False`` semantics.
* Each step is ``make_representation_train_step`` (trunk in eval mode, shift
  branch in train mode, Adam/AdamW, EMA every ``ema_every`` steps), its t,
  noise and dropout drawn from generators seeded with (seed, step)
  (``BaseTrainer.seeded``), eager or replayed from a CUDA graph, the
  decoder's forward under ``runner_config.remat``. Both models compute in the
  trainer's ``_compute_dtype``, the eval grid too; params stay fp32.
* ``evaluate`` decodes a shift-DDIM grid of ``num_generations`` eval images
  with the EMA weights (swapped in for the call by
  ``torch.func.functional_call``; the trained tensors are never touched) and
  writes ``samples/sample{N}k.png`` with the ground truths interleaved. Under
  several processes each rank decodes its share of the images (every rank
  draws the whole x_T) and the primary gathers them and writes the grid.
* Checkpoints hold ``encoder``, ``ema_encoder``, ``decoder`` (trunk and
  shift branch), ``ema_decoder`` (trunk and EMA shift branch), ``optimizer``
  (optax's layout) and ``step``, every tree in the flax layout, so
  ``pdae_tpu``'s trainer resumes from the port's files and the port from its.
  Under FSDP (``param_sharding: fsdp``) the plan (``training/fsdp.py``)
  holds the encoder's, the shift branch's and the trunk's large tensors as
  each rank's blocks; the trunk's checkpoint tree stays the whole host copy
  made at the graft, which rank 0 writes in a sharded checkpoint. Under tensor
  parallelism the encoder and the whole decoder, trunk too, hold the rank's
  tp blocks and run split (``parallel/tp.py``); the trunk's checkpoint tree
  stays the whole host copy made at the graft.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..diffusion import GaussianDiffusion
from ..models import build_decoder, build_encoder
from ..utils import (encoder_state_dict, encoder_tree, optimizer_moments,
                     optimizer_tree, restore_into, save_image_grid, to_uint8,
                     unet_state_dict, unet_tree)
from ..utils.image import make_grid, x0_from_transfer
from ..utils.rng import EVAL, generator
from .artifacts import graft_ddpm_into_decoder, load_ddpm_params, resolve_model_config
from .base import BaseTrainer, has_dropout, init_on_cpu, with_weights
from .partition import split_shift_tree, split_shift_unet, trainable_params
from .steps import make_representation_train_step

def _copy_tree(tree):
    return ({k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.array(tree))


class RepresentationLearningTrainer(BaseTrainer):

    def _build(self):
        cfg = self.config
        self.gd = GaussianDiffusion(cfg["diffusion_config"])
        ds_cfg = cfg["train_dataset_config"]
        size = int(ds_cfg["image_size"])
        ddpm_model_cfg = resolve_model_config(cfg["trained_ddpm_config"])
        dtype = self._compute_dtype()
        self.encoder = init_on_cpu(self.seed, 0, lambda: build_encoder(
            cfg["encoder_config"], image_size=size, dtype=dtype))
        self.decoder = init_on_cpu(self.seed, 1, lambda: build_decoder(
            cfg["decoder_config"], ddpm_model_cfg, dtype=dtype))
        ckpt = cfg.get("trained_ddpm_checkpoint")
        if ckpt:
            tree = graft_ddpm_into_decoder(self.decoder, load_ddpm_params(ckpt))
        else:
            tree = unet_tree(self.decoder.state_dict())
        # the trunk never changes: its checkpoint tree is made once here
        # (and again when a checkpoint loads), not at every save
        self._trunk_tree = _copy_tree(split_shift_tree(tree)[1])
        self.encoder.to(self.device)
        self.decoder.to(self.device)
        self._dropout = has_dropout(self.decoder)

        self._shard_module(self.encoder, encoder_tree)
        self._shard_module(self.decoder, unet_tree)
        self._freeze("trunk", self.decoder, unet_tree,
                     split_shift_unet(dict(self.decoder.named_parameters()))[1])
        self._shard_state(trainable_params(self.encoder, self.decoder),
                          {"encoder": encoder_tree, "shift": unet_tree},
                          (self.encoder, self.decoder))
        rc = self.runner_config
        self._step_fn = make_representation_train_step(
            self.gd, self.encoder, self.decoder, self.optimizer,
            ema_decay=float(rc.get("ema_decay", 0.9999)),
            num_iters=self.num_iterations, device=self.device,
            ema_every=self.ema_every, remat=rc.get("remat"), **self._data_parallel())
        self.eval_seconds = []

    @property
    def step(self) -> int:
        return int(self.state.step)

    def _step_batch_keys(self):
        return ("x_0",)

    def _step(self, batch, ema=None):
        return {"prediction_loss": self._step_fn(self.state, batch["x_0"],
                                                 self._train_gen.generator, ema=ema)}

    def evaluate(self, step: int, ddim_style: str = "ddim100"):
        t0 = time.perf_counter()
        n = int(self.dataloader_config.get("eval", {}).get("num_generations", 36))
        items = [self.eval_dataset[i] for i in range(min(n, len(self.eval_dataset)))]
        eval_batch = type(self.eval_dataset).collate_fn(items)
        x_0 = x0_from_transfer(torch.from_numpy(eval_batch["x_0"]).to(self.device)
                               .permute(0, 3, 1, 2).contiguous())
        x_T = torch.randn(x_0.shape, device=self.device,
                          generator=generator(self.seed, EVAL, step, self.device))
        mine = self._eval_shard(x_0.shape[0])
        x_0, x_T = x_0[mine], x_T[mine]
        ema = self._eval_ema()

        def sample(encoder, decoder, x_0, x_T):
            return self.gd.representation_learning_ddim_sample(ddim_style, encoder, decoder,
                                                               x_0, x_T)

        self.encoder.eval()
        self.decoder.eval()
        try:
            with torch.inference_mode(), self._whole_frozen():
                imgs = with_weights({"encoder": self.encoder, "decoder": self.decoder},
                                    {"encoder": ema["encoder"], "decoder": ema["shift"]},
                                    sample, x_0, x_T)
        finally:
            self.encoder.train()
            self.decoder.train()
        grid = self._gather_eval_images(to_uint8(imgs.permute(0, 2, 3, 1).cpu().numpy()))
        self.eval_seconds.append(time.perf_counter() - t0)
        if grid is None:
            return
        path = os.path.join(self.run_path, "samples", f"sample{step // 1000}k.png")
        save_image_grid(grid, path, gts=eval_batch["gts"][:grid.shape[0]])
        self.logger.image(step, "result", make_grid(grid))

    # -- checkpoints ------------------------------------------------------ #

    def _frozen_snapshot(self):
        return {"trunk": self._trunk_tree}

    def checkpoint_tree(self, snap):
        params, ema = snap["params"], snap["ema"]
        return {
            "encoder": encoder_tree(params["encoder"]),
            "ema_encoder": encoder_tree(ema["encoder"]),
            "decoder": {**snap["trunk"], **unet_tree(params["shift"])},
            "ema_decoder": {**snap["trunk"], **unet_tree(ema["shift"])},
            "optimizer": optimizer_tree(self.optimizer_config, snap["count"], snap["mu"],
                                        snap["nu"]),
        }

    def load_state_dict(self, raw):
        """A checkpoint's trees (either package's, whole) into the modules,
        and this rank's part into the masters, the EMA and the moments."""
        keys = ("encoder", "ema_encoder", "decoder", "ema_decoder", "optimizer")
        template = self._template()
        restore_into({k: template[k] for k in keys}, raw)
        shift, trunk = split_shift_tree(raw["decoder"])
        ema_shift, _ = split_shift_tree(raw["ema_decoder"])
        moments = optimizer_moments(self.optimizer_config, raw["optimizer"])
        self._load_module(self.decoder, unet_state_dict(raw["decoder"]))
        self.state.load_converted({
            "step": int(raw["step"]),
            "params": {"encoder": encoder_state_dict(raw["encoder"]),
                       "shift": unet_state_dict(shift)},
            "ema_params": {"encoder": encoder_state_dict(raw["ema_encoder"]),
                           "shift": unet_state_dict(ema_shift)},
            **moments})
        # the trunk comes from the checkpoint, not from the graft
        self._trunk_tree = _copy_tree(trunk)
