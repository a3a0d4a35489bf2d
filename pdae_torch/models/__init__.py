"""Model registry: config dicts -> modules, as ``pdae_tpu.models`` builds them.
Each builder takes the compute ``dtype`` (fp32 parameters either way)."""

from __future__ import annotations

import torch

from .blocks import timestep_embedding
from .classifier import LinearClassifier
from .encoder import SemanticEncoder, encoder_for_resolution
from .mlp_skip_net import MLPLNAct, MLPSkipNet
from .shift_unet import FROZEN_PREFIXES, SHIFT_TRAINABLE_PREFIXES, ShiftUNet
from .unet import UNet

# the celeba64 DPM geometry (the JAX repo's ``CELEBA64_DPM``): the UNet
# trunk of the PDAE decoder that serves the 64px autoencoding headline
CELEBA64_DPM = dict(
    input_channel=3, base_channel=128, channel_multiplier=(1, 2, 2, 4),
    num_residual_blocks_of_a_block=2, attention_resolutions=(16,),
    num_heads=4, head_channel=-1, use_new_attention_order=False, dropout=0.0)

# the 128px DPM geometry of ffhq, celebahq, horse and bedroom
# (``configs/dpm_ffhq.yml``; the JAX repo's ``FFHQ128_DPM``)
FFHQ128_DPM = dict(
    input_channel=3, base_channel=128, channel_multiplier=(1, 1, 2, 2, 4, 4),
    num_residual_blocks_of_a_block=2, attention_resolutions=(16,),
    num_heads=4, head_channel=-1, use_new_attention_order=False, dropout=0.0)

# a two-level 16px geometry for smoke runs on the CPU (the JAX repo's ``TINY_DPM``)
TINY_DPM = dict(
    input_channel=3, base_channel=32, channel_multiplier=(1, 2),
    num_residual_blocks_of_a_block=1, attention_resolutions=(2,),
    num_heads=2, head_channel=-1, use_new_attention_order=False, dropout=0.0)

_UNET_KEYS = ("input_channel", "base_channel", "channel_multiplier",
              "num_residual_blocks_of_a_block", "attention_resolutions",
              "num_heads", "head_channel", "use_new_attention_order",
              "dropout", "num_class", "learn_sigma")

_ENCODER_RESOLUTION = {
    "CELEBA64Encoder": 64,
    "FFHQEncoder": 128,
    "CELEBAHQEncoder": 128,
    "HORSEEncoder": 128,
    "BEDROOMEncoder": 128,
}


def _filter(config: dict, keys) -> dict:
    out = {k: config[k] for k in keys if k in config}
    for seq_key in ("channel_multiplier", "attention_resolutions"):
        if seq_key in out:
            out[seq_key] = tuple(out[seq_key])
    return out


def build_denoise_fn(config: dict, dtype=torch.float32) -> UNet:
    """``UNet``, ``MNISTDenoiseFn`` or ``<DS>DenoiseFn`` -> UNet (a pre-trained
    DPM's model config)."""
    name = config.get("model", "UNet")
    if name not in ("UNet", "MNISTDenoiseFn") and not name.endswith("DenoiseFn"):
        raise KeyError(f"unknown denoise_fn model: {name}")
    return UNet(dtype=dtype, **_filter(config, _UNET_KEYS))


def build_decoder(config: dict, trained_ddpm_config: dict,
                  dtype=torch.float32) -> ShiftUNet:
    """``<DS>Decoder`` -> ShiftUNet: the UNet geometry comes from the
    pre-trained DPM config, ``latent_dim`` from the decoder config."""
    name = config.get("model", "ShiftUNet")
    if name != "ShiftUNet" and not name.endswith("Decoder"):
        raise KeyError(f"unknown decoder model: {name}")
    kwargs = _filter(trained_ddpm_config, _UNET_KEYS)
    kwargs.pop("num_class", None)
    return ShiftUNet(latent_dim=config["latent_dim"], dtype=dtype, **kwargs)


def build_encoder(config: dict, image_size: int = None,
                  dtype=torch.float32) -> SemanticEncoder:
    name = config.get("model", "")
    if name in _ENCODER_RESOLUTION:
        image_size = _ENCODER_RESOLUTION[name]
    if image_size is None:
        raise KeyError(f"unknown encoder model: {name} (and no image_size)")
    return encoder_for_resolution(image_size, config["latent_dim"], dtype=dtype)


def build_latent_denoise_fn(config: dict, dtype=torch.float32) -> MLPSkipNet:
    """``<DS>LatentDenoiseFn`` -> MLPSkipNet."""
    name = config.get("model", "MLPSkipNet")
    if name != "MLPSkipNet" and not name.endswith("LatentDenoiseFn"):
        raise KeyError(f"unknown latent denoise fn: {name}")
    return MLPSkipNet(
        input_channel=config["input_channel"],
        model_channel=config.get("model_channel", 2048),
        num_layers=config.get("num_layers", 10),
        time_emb_channel=config.get("time_emb_channel", 64),
        use_norm=config.get("use_norm", True),
        dropout=config.get("dropout", 0.0),
        dtype=dtype)


def build_classifier(num_classes: int = 40, latent_dim: int = 512,
                     dtype=torch.float32) -> LinearClassifier:
    return LinearClassifier(num_classes=num_classes, latent_dim=latent_dim, dtype=dtype)


__all__ = ["CELEBA64_DPM", "FFHQ128_DPM", "TINY_DPM", "UNet", "ShiftUNet", "SemanticEncoder",
           "MLPSkipNet", "MLPLNAct", "LinearClassifier", "timestep_embedding",
           "encoder_for_resolution", "build_denoise_fn", "build_decoder", "build_encoder",
           "build_latent_denoise_fn", "build_classifier",
           "SHIFT_TRAINABLE_PREFIXES", "FROZEN_PREFIXES"]
