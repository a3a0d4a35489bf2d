"""Cross-stage artifacts: pre-trained DPMs, PDAE autoencoders and inferred
latent statistics, read from checkpoints of either package. The port of
``pdae_tpu/training/artifacts.py``.

The stages compose through checkpoint keys: a DPM run's ``ema_denoise_fn``
grafts into the ShiftUNet trunk (a ``strict=False`` load), a PDAE run's
``ema_encoder``/``ema_decoder`` feed the later stages, and infer-latents
writes ``{mean, std}``. The trees under those keys are in the flax layout;
``pdae_torch.utils.convert`` maps them to the port's state dicts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import (load_checkpoint, load_yaml, merge_partial, unet_state_dict,
                     unet_tree)


def resolve_model_config(config_or_path) -> dict:
    """A trained-DPM config reference is an inline dict or the path of the
    DPM run's config file; a run config's ``denoise_fn_config`` is returned,
    a bare model config as it is."""
    cfg = config_or_path if isinstance(config_or_path, dict) else load_yaml(config_or_path)
    return cfg.get("denoise_fn_config", cfg)


def load_ddpm_params(ckpt_path: str, key: str = "ema_denoise_fn") -> dict:
    """The pre-trained DPM's weights (a flax tree) for the frozen trunk."""
    raw = load_checkpoint(ckpt_path)
    if key not in raw:
        raise KeyError(f"{ckpt_path} lacks '{key}' (keys: {list(raw)})")
    return raw[key]


def graft_ddpm_into_decoder(decoder: torch.nn.Module, ddpm_params: dict) -> dict:
    """``strict=False`` load of the DPM into the ShiftUNet: every subtree of
    the decoder's flax tree that the DPM has is overwritten (keys only the DPM
    has are dropped; the shift branch keeps its init), then the merged tree
    loads into ``decoder`` with ``strict=True``. Returns the merged tree."""
    merged = merge_partial(unet_tree(decoder.state_dict()), ddpm_params)
    decoder.load_state_dict(unet_state_dict(merged), strict=True)
    return merged


def load_pdae(config_or_path, ckpt_path: str):
    """A trained PDAE stage: (run config, ema_encoder, ema_decoder), the
    weights as flax trees."""
    cfg = config_or_path if isinstance(config_or_path, dict) else load_yaml(config_or_path)
    raw = load_checkpoint(ckpt_path)
    return cfg, raw["ema_encoder"], raw["ema_decoder"]


def load_latent_stats(path: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """{mean, std} of the inferred z distribution, as float32 tensors."""
    raw = load_checkpoint(path)
    return (torch.from_numpy(np.array(raw["mean"], np.float32)),
            torch.from_numpy(np.array(raw["std"], np.float32)))
