"""What every sampler and the file-built service need: the configs read, the
stage checkpoints loaded, the models built on one device.

Port of ``pdae_tpu/sampling/context.py``. It takes the same config keys:

* ``config_path`` (the run config of the PDAE stage, or of the DPM for
  ``test_dpms``) and ``checkpoint_path`` (its checkpoint);
* ``trained_ddpm_config_path``, else the run config's ``trained_ddpm_config``
  (inline or a path): the UNet geometry of the decoder's trunk;
* ``latent_config_path`` and ``latent_checkpoint_path`` (the latent DPM),
  ``inferred_latents_path`` (``{mean, std}``), ``classifier_checkpoint_path``
  and ``num_classes`` (40);
* ``image_size``/``image_channel``, else the ``dataset_config``'s, else the
  run's training set's; ``dataset_config`` for the samplers that read images;
* ``diffusion_config``, else the run config's, else linear over 1000 steps.

Files of either package are read through ``utils.load_checkpoint`` (a single
file, or a ``pdae_tpu`` sharded directory); the flax trees under
``ema_encoder``, ``ema_decoder``, ``ema_denoise_fn``,
``ema_latent_denoise_fn`` and ``ema_classifier`` go through
``utils.convert`` and load with ``strict=True``. Models are kept in eval
mode on ``device``: ``cuda`` unless the caller names another
(``cuda:LOCAL_RANK`` in a process that torchrun started, whose process group
the context joins: ``parallel.init_distributed``), and without a card the
caller must. The context sets TF32 off for the process, as the service does:
the port's numerics are fp32.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data import build_dataset
from ..diffusion import GaussianDiffusion
from ..models import (build_classifier, build_decoder, build_denoise_fn, build_encoder,
                      build_latent_denoise_fn)
from ..parallel import init_distributed
from ..training.artifacts import resolve_model_config
from ..utils import (classifier_state_dict, encoder_state_dict, load_checkpoint,
                     load_yaml, mlp_skip_net_state_dict, unet_state_dict)

DEFAULT_DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}


def _load_cfg(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    return load_yaml(path_or_dict)


def _loaded(model: torch.nn.Module, state: dict, device) -> torch.nn.Module:
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def _stage(raw: dict, key: str, path: str) -> dict:
    if key not in raw:
        raise KeyError(f"{path} lacks '{key}' (keys: {sorted(raw)})")
    return raw[key]


class SamplerContext:
    """Builds, on demand, every model the sampler suite needs."""

    def __init__(self, config: dict, device=None):
        self.config = config
        init_distributed()
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self._run_cfg = (_load_cfg(config["config_path"]) if "config_path" in config
                         else None)
        self._pdae_cfg = (self._run_cfg if self._run_cfg is not None
                          and "encoder_config" in self._run_cfg else None)
        # a sampler's own schedule, else the run's whatever its kind (a
        # plain-DPM run on a cosine schedule must not fall back to linear)
        diff_cfg = config.get("diffusion_config")
        if diff_cfg is None and self._run_cfg is not None:
            diff_cfg = self._run_cfg.get("diffusion_config")
        self.diffusion_config = dict(diff_cfg or DEFAULT_DIFFUSION)
        self.gd = GaussianDiffusion(self.diffusion_config)
        self.encoder = self.decoder = None
        self.denoise_fn = None
        self.latent_denoise_fn = None

    # -- dataset ------------------------------------------------------------ #

    def dataset(self):
        """The sampler's dataset. ``transfer_uint8`` is refused: the samplers
        compare and encode ``x_0`` as float [-1, 1], and uint8 pixels would
        reach SSIM, MSE and the encoder unnormalised."""
        cfg = dict(self.config["dataset_config"])
        cfg.setdefault("name", cfg.pop("dataset_name", None))
        if cfg.get("transfer_uint8", False):
            raise ValueError("dataset_config.transfer_uint8 is a training option; the "
                             "samplers read x_0 as float [-1, 1], so set it to false")
        return build_dataset(cfg)

    # -- the PDAE stage ------------------------------------------------------- #

    def pdae_geometry(self) -> dict:
        """The PDAE stage's model configs and image geometry:
        ``encoder_config``, ``decoder_config``, ``trained_ddpm_config`` (the
        trunk's UNet config), ``image_size``, ``image_channel`` and
        ``latent_dim``."""
        if self._pdae_cfg is None:
            raise KeyError(f"config_path {self.config.get('config_path')!r} is not the "
                           "run config of a PDAE stage (it has no encoder_config)")
        pdae = self._pdae_cfg
        ds = self.config.get("dataset_config") or {}
        train_ds = pdae["train_dataset_config"]
        ddpm = self.config.get("trained_ddpm_config_path", pdae.get("trained_ddpm_config"))
        return {
            "encoder_config": pdae["encoder_config"],
            "decoder_config": pdae["decoder_config"],
            "trained_ddpm_config": resolve_model_config(_load_cfg(ddpm)),
            "image_size": int(self.config.get(
                "image_size", ds.get("image_size", train_ds["image_size"]))),
            "image_channel": int(self.config.get(
                "image_channel", ds.get("image_channel", train_ds.get("image_channel", 3)))),
            "latent_dim": int(pdae["encoder_config"]["latent_dim"]),
        }

    def pdae_states(self) -> Tuple[dict, dict]:
        """The EMA encoder's and decoder's state dicts from ``checkpoint_path``."""
        path = self.config["checkpoint_path"]
        raw = load_checkpoint(path)
        return (encoder_state_dict(_stage(raw, "ema_encoder", path)),
                unet_state_dict(_stage(raw, "ema_decoder", path)))

    def build_pdae(self) -> None:
        """Sets ``.encoder`` (x -> z) and ``.decoder`` ((x, t, z) -> (eps,
        gradient)), and ``.geometry`` (``pdae_geometry()``)."""
        if self.encoder is not None:
            return
        geo = self.pdae_geometry()
        enc_state, dec_state = self.pdae_states()
        self.geometry = geo
        self.encoder = _loaded(build_encoder(geo["encoder_config"],
                                             image_size=geo["image_size"]),
                               enc_state, self.device)
        self.decoder = _loaded(build_decoder(geo["decoder_config"],
                                             geo["trained_ddpm_config"]),
                               dec_state, self.device)

    # -- the pre-trained DPM (test_dpms) --------------------------------------- #

    def build_denoise(self) -> None:
        """Sets ``.denoise_fn`` ((x, t, condition) -> eps) from the DPM run
        at ``config_path`` and its ``ema_denoise_fn``."""
        if self.denoise_fn is not None:
            return
        path = self.config["checkpoint_path"]
        state = unet_state_dict(_stage(load_checkpoint(path), "ema_denoise_fn", path))
        self.denoise_fn = _loaded(build_denoise_fn(resolve_model_config(self._run_cfg)),
                                  state, self.device)

    # -- the latent DPM ------------------------------------------------------- #

    def latent_config(self) -> dict:
        """The latent DPM's ``latent_denoise_fn_config``."""
        return _load_cfg(self.config["latent_config_path"])["latent_denoise_fn_config"]

    def latent_state(self) -> dict:
        """The state dict of ``ema_latent_denoise_fn``."""
        path = self.config["latent_checkpoint_path"]
        return mlp_skip_net_state_dict(
            _stage(load_checkpoint(path), "ema_latent_denoise_fn", path))

    def build_latent(self) -> torch.nn.Module:
        """Sets and returns ``.latent_denoise_fn`` ((z, t) -> eps), and
        ``.latent_input_channel``."""
        if self.latent_denoise_fn is None:
            lat_cfg = self.latent_config()
            self.latent_input_channel = int(lat_cfg["input_channel"])
            self.latent_denoise_fn = _loaded(build_latent_denoise_fn(lat_cfg),
                                             self.latent_state(), self.device)
        return self.latent_denoise_fn

    # -- the classifier and the latent stats ---------------------------------- #

    def classifier_state(self) -> dict:
        """The state dict of ``ema_classifier``."""
        path = self.config["classifier_checkpoint_path"]
        return classifier_state_dict(_stage(load_checkpoint(path), "ema_classifier", path))

    def classifier_weight(self) -> torch.Tensor:
        """The ``[num_classes, latent_dim]`` weight of ``ema_classifier``."""
        latent_dim = (int(self._pdae_cfg["encoder_config"]["latent_dim"])
                      if self._pdae_cfg is not None else 512)
        clf = build_classifier(int(self.config.get("num_classes", 40)), latent_dim)
        return _loaded(clf, self.classifier_state(), self.device).weight.detach()

    def latent_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mean, std)`` of the inferred latents, fp32 on the device."""
        raw = load_checkpoint(self.config["inferred_latents_path"])
        return tuple(torch.from_numpy(np.array(raw[k], np.float32)).to(self.device)
                     for k in ("mean", "std"))

    # -- misc ---------------------------------------------------------------- #

    def output_path(self, default_name: str) -> str:
        out = self.config.get("output_path", f"./{default_name}")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        return out

