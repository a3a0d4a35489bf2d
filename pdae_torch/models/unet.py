"""ADM-style diffusion UNet, NCHW.

Port of ``pdae_tpu/models/unet.py``. The trunk builders
(``build_input_stack``, ``build_decode_stack``; ``build_trunk`` in the JAX
package) are shared with ``ShiftUNet`` so the frozen trunk has one layout in
both models; stage lists
are ``nn.ModuleList``s so the state-dict keys read ``input_blocks.I.J.*``,
``middle_block.J.*`` and ``output_blocks.I.J.*`` as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import (AttentionBlock, GNSiluChain, ResBlock, ResBlockShift,
                     conv3x3, timestep_embedding, zero_init)


def time_embed_mlp(base_channel: int) -> nn.Sequential:
    """Two-layer SiLU MLP on the sinusoidal embedding (``time_embed.0/.2``)."""
    dim = base_channel * 4
    return nn.Sequential(nn.Linear(base_channel, dim), nn.SiLU(), nn.Linear(dim, dim))


def _attention(ch, num_heads, head_channel, use_new_attention_order):
    return AttentionBlock(ch, num_heads=num_heads, head_channel=head_channel,
                          use_new_attention_order=use_new_attention_order)


def build_input_stack(base_channel: int, channel_multiplier: Sequence[int],
                      num_residual_blocks_of_a_block: int,
                      attention_resolutions: Sequence[int], num_heads: int,
                      head_channel: int, use_new_attention_order: bool,
                      dropout: float, input_channel: int):
    """Build the encoding half of the trunk.

    Returns ``(input_blocks, skip_chans)``: the stage list and the channel
    count of each stored skip, in push order. Attention goes only where the
    downsample rate ``ds`` is in ``attention_resolutions``.
    """
    attn = set(attention_resolutions)
    time_embed_dim = base_channel * 4
    ch = int(channel_multiplier[0] * base_channel)
    input_blocks = nn.ModuleList([nn.ModuleList([conv3x3(input_channel, ch)])])
    skip_chans = [ch]
    ds = 1
    for level, mult in enumerate(channel_multiplier):
        for _ in range(num_residual_blocks_of_a_block):
            layers = [ResBlock(ch, time_embed_dim, dropout,
                               out_channels=int(mult * base_channel))]
            ch = int(mult * base_channel)
            if ds in attn:
                layers.append(_attention(ch, num_heads, head_channel,
                                         use_new_attention_order))
            input_blocks.append(nn.ModuleList(layers))
            skip_chans.append(ch)
        if level != len(channel_multiplier) - 1:
            input_blocks.append(nn.ModuleList([
                ResBlock(ch, time_embed_dim, dropout, out_channels=ch, down=True)]))
            skip_chans.append(ch)
            ds *= 2
    return input_blocks, skip_chans


def build_decode_stack(base_channel: int, channel_multiplier: Sequence[int],
                       num_residual_blocks_of_a_block: int,
                       attention_resolutions: Sequence[int], num_heads: int,
                       head_channel: int, use_new_attention_order: bool,
                       dropout: float, skip_chans: Sequence[int],
                       shift: bool = False):
    """Build the middle block and the decoding half, reading the skips of
    ``build_input_stack`` (``skip_chans`` is not modified).

    Returns ``(middle_block, output_blocks, final_ch)``. With ``shift=True``
    the ResBlocks are ResBlockShift (the PDAE gradient branch); the geometry
    is the same either way.
    """
    attn = set(attention_resolutions)
    time_embed_dim = base_channel * 4
    Res = ResBlockShift if shift else ResBlock
    skips = list(skip_chans)
    ch = skips[-1]                      # the input stack's last output
    ds = 2 ** (len(channel_multiplier) - 1)

    middle_block = nn.ModuleList([
        Res(ch, time_embed_dim, dropout),
        _attention(ch, num_heads, head_channel, use_new_attention_order),
        Res(ch, time_embed_dim, dropout),
    ])

    output_blocks = nn.ModuleList()
    for level, mult in list(enumerate(channel_multiplier))[::-1]:
        for i in range(num_residual_blocks_of_a_block + 1):
            ich = skips.pop()
            layers = [Res(ch + ich, time_embed_dim, dropout,
                          out_channels=int(base_channel * mult))]
            ch = int(base_channel * mult)
            if ds in attn:
                layers.append(_attention(ch, num_heads, head_channel,
                                         use_new_attention_order))
            if level and i == num_residual_blocks_of_a_block:
                layers.append(Res(ch, time_embed_dim, dropout, out_channels=ch, up=True))
                ds //= 2
            output_blocks.append(nn.ModuleList(layers))
    return middle_block, output_blocks, ch


def apply_stage(layers, h, emb, emb_z=None):
    """Apply one stage list, dispatching on layer kind."""
    for layer in layers:
        if isinstance(layer, ResBlockShift):
            h = layer(h, emb, emb_z)
        elif isinstance(layer, ResBlock):
            h = layer(h, emb)
        else:
            h = layer(h)
    return h


def output_head(final_ch: int, out_ch: int) -> nn.ModuleList:
    """``[GN, SiLU, zero-init conv]`` (``out.0``/``out.2``); index 1 is fused
    into the chain at index 0."""
    return nn.ModuleList([GNSiluChain(final_ch), nn.Identity(),
                          zero_init(conv3x3(final_ch, out_ch))])


class UNet(nn.Module):
    """Epsilon-prediction UNet. ``x`` is NCHW, ``time`` an int [N] vector on
    the original diffusion time axis, ``condition`` an optional [N] class."""

    def __init__(self, input_channel: int, base_channel: int,
                 channel_multiplier: Sequence[int],
                 num_residual_blocks_of_a_block: int,
                 attention_resolutions: Sequence[int], num_heads: int = 1,
                 head_channel: int = -1, use_new_attention_order: bool = False,
                 dropout: float = 0.0, num_class: Optional[int] = None,
                 learn_sigma: bool = False):
        super().__init__()
        self.base_channel = base_channel
        self.time_embed = time_embed_mlp(base_channel)
        if num_class is not None:
            self.label_emb = nn.Embedding(num_class, base_channel * 4)
        geometry = (base_channel, channel_multiplier, num_residual_blocks_of_a_block,
                    attention_resolutions, num_heads, head_channel,
                    use_new_attention_order, dropout)
        self.input_blocks, skip_chans = build_input_stack(*geometry, input_channel)
        self.middle_block, self.output_blocks, final_ch = build_decode_stack(
            *geometry, skip_chans)
        self.out = output_head(final_ch, input_channel * 2 if learn_sigma
                               else input_channel)

    def forward(self, x, time, condition=None):
        emb = self.time_embed(timestep_embedding(time, self.base_channel))
        if hasattr(self, "label_emb"):
            if condition is None:
                raise ValueError("a class-conditional UNet needs a condition")
            emb = emb + self.label_emb(condition)
        hs = []
        h = x
        for stage in self.input_blocks:
            h = apply_stage(stage, h, emb)
            hs.append(h)
        h = apply_stage(self.middle_block, h, emb)
        for stage in self.output_blocks:
            h = apply_stage(stage, torch.cat([h, hs.pop()], dim=1), emb)
        return self.out[2](self.out[0](h)).float()
