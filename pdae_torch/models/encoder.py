"""Semantic encoders z = Enc(x_0), NCHW in (channels-last inside in bf16:
``blocks.nhwc_model``).

Port of ``pdae_tpu/models/encoder.py``: stride-2 3x3 convs with GN+SiLU
pre-activations, one attention block at the 16x16 map, then GN+SiLU, flatten
and a Linear to ``latent_dim``. The stack is one ``nn.Sequential`` named
``encoder`` so the keys read ``encoder.<index>.*`` as in the reference; the
SiLU indices hold ``nn.Identity`` (fused into the GN chain before them).

* 64px:  channels (64, 128, 128, 128), attention after stage 2;
* 128px: channels (64, 128, 256, 256, 256), attention after stage 3.

Both end at 4x4, so the flatten is ``channels[-1] * 16`` wide, in NCHW order
(a channels-last map is made contiguous first, so that converted checkpoints
keep matching). ``dtype`` is the compute dtype (``models/blocks.py``): x is
cast to it, z is fp32.

Under spatial parallelism (``sp``, ``parallel/sp.py``) x comes in whole, the
convs, chains and the attention run on the rank's rows of each map whose
height splits, and the rows are gathered before the flatten (``pdae_tpu``'s
``constrain_batch`` there), so z is whole on every rank; the gather's
backward sums the ranks' partial gradients of z.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..parallel import sp as _sp
from .blocks import AttentionBlock, Conv2d, GNSiluChain, Linear, conv3x3, model_input


class SemanticEncoder(nn.Module):

    sp = _sp.ONE       # the groups of spatial parallelism (parallel/sp.py)

    def __init__(self, latent_dim: int, channels: Sequence[int] = (64, 128, 128, 128),
                 attn_after_stage: int = 2, attn_heads: int = 4,
                 image_size: int = 64, input_channel: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        layers = []
        cin = input_channel
        for i, ch in enumerate(channels):
            if i > 0:
                layers += [GNSiluChain(channels[i - 1]), nn.Identity()]
            layers.append(conv3x3(cin, ch, stride=2, dtype=dtype))
            cin = ch
            if (i + 1) == attn_after_stage:
                layers.append(AttentionBlock(ch, num_heads=attn_heads, dtype=dtype))
        final_size = image_size >> len(channels)
        layers += [GNSiluChain(channels[-1]), nn.Identity(), nn.Flatten(),
                   Linear(channels[-1] * final_size * final_size, latent_dim,
                          compute_dtype=dtype)]
        self.encoder = nn.Sequential(*layers)

    def forward(self, x):
        x = model_input(self, x)
        g = self.sp
        height, h = x.shape[2], _sp.enter(x, g)
        for layer in self.encoder:
            if isinstance(layer, GNSiluChain):
                h = _sp.chain(layer, h, g, height)
            elif isinstance(layer, Conv2d):
                h, height = _sp.conv(layer, h, g, height)
            elif isinstance(layer, AttentionBlock):
                h = layer(h, g, height)
            elif isinstance(layer, nn.Flatten):
                h = layer(_sp.whole(h, g, height).contiguous())
            else:
                h = layer(h)
        return h.float()


def encoder_for_resolution(image_size: int, latent_dim: int,
                           dtype=torch.float32) -> SemanticEncoder:
    """The reference's per-dataset encoder geometry by input resolution."""
    if image_size == 64:
        return SemanticEncoder(latent_dim, channels=(64, 128, 128, 128),
                               attn_after_stage=2, image_size=64, dtype=dtype)
    if image_size == 128:
        return SemanticEncoder(latent_dim, channels=(64, 128, 256, 256, 256),
                               attn_after_stage=3, image_size=128, dtype=dtype)
    raise ValueError(f"no reference encoder geometry for {image_size}px")
