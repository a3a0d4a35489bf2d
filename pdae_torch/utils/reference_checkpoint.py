"""The reference's torch ``.pt`` checkpoints to and from the port's msgpack
checkpoints: the port of ``pdae_tpu/utils/torch_convert.py``'s
``convert_reference_checkpoint`` and ``export_reference_checkpoint``.

The reference releases its pre-trained DPMs and trained PDAE stages as
``torch.save`` dicts of state dicts (``step``, ``denoise_fn``/
``ema_denoise_fn``, ``encoder``/``ema_encoder``, ``decoder``/``ema_decoder``,
``latent_denoise_fn``/``ema_latent_denoise_fn``, ``classifier``/
``ema_classifier``; an inferred-latents file holds ``mean``/``std``), beside
``optimizer`` and ``scaler`` entries that are not portable and are skipped.
The port's modules use the reference's state-dict keys, so a converted
checkpoint is the flax-layout trees of ``convert.py``'s inverse maps, and an
exported one is their forward maps: the same trees and state dicts, key for
key and bit for bit, as the JAX package's converter gives.

The encoder's stage count is the geometry: 4 for the 64px encoder, 5 for the
128px one. It is read off the state dict and must equal
``num_encoder_stages``, so a 4-stage dict is never taken for a 5-stage one.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .convert import (_numpy, classifier_state_dict, classifier_tree,
                      encoder_state_dict, encoder_tree, mlp_skip_net_state_dict,
                      mlp_skip_net_tree, unet_state_dict, unet_tree)

UNET_KEYS = ("denoise_fn", "ema_denoise_fn", "decoder", "ema_decoder")
ENCODER_KEYS = ("encoder", "ema_encoder")
LATENT_KEYS = ("latent_denoise_fn", "ema_latent_denoise_fn")
CLASSIFIER_KEYS = ("classifier", "ema_classifier")
STATS_KEYS = ("mean", "std")


def _check_stages(tree: Dict, num_stages: int, key: str) -> None:
    found = sum(1 for k in tree if re.fullmatch(r"conv_\d+", k))
    if found != num_stages:
        raise ValueError(f"'{key}' has {found} encoder stages, not {num_stages}: "
                         f"pass --encoder-stages {found} (4 for the 64px encoder, "
                         "5 for the 128px one)")


def convert_reference_checkpoint(data: Dict, num_encoder_stages: int = 4) -> Dict:
    """A reference trainer checkpoint dict (torch tensors, on any device) ->
    the port's msgpack-ready dict of flax-layout trees, key for key.
    Optimizer and scaler states are skipped."""
    out: Dict = {}
    for key, value in data.items():
        if key == "step":
            out["step"] = np.asarray(int(value), np.int32)
        elif key in UNET_KEYS:
            out[key] = unet_tree(value)
        elif key in ENCODER_KEYS:
            out[key] = encoder_tree(value)
            _check_stages(out[key], num_encoder_stages, key)
        elif key in LATENT_KEYS:
            out[key] = mlp_skip_net_tree(value)
        elif key in CLASSIFIER_KEYS:
            # the bare Linear's keys, or a module's (``fc.weight``)
            out[key] = classifier_tree({k.split(".")[-1]: v for k, v in value.items()})
        elif key in STATS_KEYS:
            out[key] = np.asarray(_numpy(value), np.float32)
    return out


def export_reference_checkpoint(data: Dict, num_encoder_stages: int = 4) -> Dict:
    """The port's checkpoint dict (flax-layout trees, numpy leaves) -> a
    reference-trainer-shaped dict of torch state dicts that the reference's
    modules load with ``strict=True``: the inverse of
    ``convert_reference_checkpoint``. Optimizer state is skipped."""
    out: Dict = {}
    for key, value in data.items():
        if key == "step":
            out["step"] = int(np.asarray(value))
        elif key in UNET_KEYS:
            out[key] = unet_state_dict(value)
        elif key in ENCODER_KEYS:
            _check_stages(value, num_encoder_stages, key)
            out[key] = encoder_state_dict(value)
        elif key in LATENT_KEYS:
            out[key] = mlp_skip_net_state_dict(value)
        elif key in CLASSIFIER_KEYS:
            out[key] = classifier_state_dict(value)
        elif key in STATS_KEYS:
            out[key] = torch.from_numpy(np.array(value, np.float32))
    return out
