"""A cell's weights, made from ``--seed`` on the device in one draw.

The leaves are those of the plain reference's encoder and ShiftUNet, in
their state-dict order (``encoder.*`` then ``decoder.*``); the program's
modules carry the same names. One ``randn`` over every leaf's elements at
once, then each leaf scaled in place:

* a convolution's or linear layer's weight: std 1/sqrt(fan_in), and half
  that for the layers the reference zero-initialises (each block's last
  conv, the attention's output projection, both output heads), which left
  at zero would hide the layers behind them from the comparison;
* a bias: std 0.02;
* a GroupNorm's weight 1 + 0.1 n, its bias 0.1 n.

No leaf is zero, so every layer shapes both the loss and the images.
"""

from __future__ import annotations

import torch
from torch import nn

from .reference.model import Encoder, ShiftUNet

HALF_SCALE = ("out_layers.3.", "proj_out.", "out.2.", "shift_out.2.")


def reference_models(config: dict, device="meta"):
    """The plain reference's (encoder, decoder) of ``config``, built on
    ``device`` (``meta``: shapes only)."""
    with torch.device(device):
        enc = Encoder(int(config["image_size"]), int(config["latent_dim"]))
        dec = ShiftUNet(latent_dim=int(config["latent_dim"]), **config["dpm"])
    return enc, dec


def _leaves(config: dict):
    """[(name, shape, kind)] in draw order; kind is ``norm``, ``weight`` or
    ``bias``."""
    out = []
    for prefix, model in zip(("encoder.", "decoder."), reference_models(config)):
        norms = {n for n, m in model.named_modules() if isinstance(m, nn.GroupNorm)}
        for name, p in model.named_parameters():
            owner = name.rsplit(".", 1)[0]
            kind = "norm" if owner in norms else "weight" if p.dim() > 1 else "bias"
            out.append((prefix + name, tuple(p.shape), kind))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """``{name: fp32 tensor}`` on ``device``, from ``seed`` alone."""
    leaves = _leaves(config)
    total = sum(torch.Size(shape).numel() for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, kind in leaves:
        n = torch.Size(shape).numel()
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "norm":
            leaf.mul_(0.1)
            if name.endswith(".weight"):
                leaf.add_(1.0)
        elif kind == "bias":
            leaf.mul_(0.02)
        else:
            scale = (n // shape[0]) ** -0.5
            if any(f".{h}" in f".{name.split('.', 1)[1]}" for h in HALF_SCALE):
                scale *= 0.5
            leaf.mul_(scale)
        out[name] = leaf
    return out


def split(weights: dict, prefix: str) -> dict:
    """The state dict of one model (``encoder.`` or ``decoder.``)."""
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
