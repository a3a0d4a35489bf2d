"""Model registry: config dicts -> modules, as ``pdae_tpu.models`` builds them."""

from __future__ import annotations

from .blocks import timestep_embedding
from .encoder import SemanticEncoder, encoder_for_resolution
from .shift_unet import FROZEN_PREFIXES, SHIFT_TRAINABLE_PREFIXES, ShiftUNet
from .unet import UNet

# the celeba64 DPM geometry (the JAX repo's ``CELEBA64_DPM``): the UNet
# trunk of the PDAE decoder that serves the 64px autoencoding headline
CELEBA64_DPM = dict(
    input_channel=3, base_channel=128, channel_multiplier=(1, 2, 2, 4),
    num_residual_blocks_of_a_block=2, attention_resolutions=(16,),
    num_heads=4, head_channel=-1, use_new_attention_order=False, dropout=0.0)

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


def build_decoder(config: dict, trained_ddpm_config: dict) -> ShiftUNet:
    """``<DS>Decoder`` -> ShiftUNet: the UNet geometry comes from the
    pre-trained DPM config, ``latent_dim`` from the decoder config."""
    name = config.get("model", "ShiftUNet")
    if name != "ShiftUNet" and not name.endswith("Decoder"):
        raise KeyError(f"unknown decoder model: {name}")
    kwargs = _filter(trained_ddpm_config, _UNET_KEYS)
    kwargs.pop("num_class", None)
    return ShiftUNet(latent_dim=config["latent_dim"], **kwargs)


def build_encoder(config: dict, image_size: int = None) -> SemanticEncoder:
    name = config.get("model", "")
    if name in _ENCODER_RESOLUTION:
        image_size = _ENCODER_RESOLUTION[name]
    if image_size is None:
        raise KeyError(f"unknown encoder model: {name} (and no image_size)")
    return encoder_for_resolution(image_size, config["latent_dim"])


__all__ = ["CELEBA64_DPM", "UNet", "ShiftUNet", "SemanticEncoder", "timestep_embedding",
           "encoder_for_resolution", "build_decoder", "build_encoder",
           "SHIFT_TRAINABLE_PREFIXES", "FROZEN_PREFIXES"]
