"""ShiftUNet, the PDAE decoder: a frozen pre-trained UNet trunk plus a
parallel trainable gradient branch, NCHW.

Port of ``pdae_tpu/models/shift_unet.py``. The input trunk runs once and both
decode stacks (``middle_block``/``output_blocks`` for epsilon,
``shift_middle_block``/``shift_output_blocks`` for the gradient) read the
same stored skips. ``forward`` returns ``(epsilon, gradient)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import timestep_embedding
from .unet import (apply_stage, build_decode_stack, build_input_stack,
                   output_head, time_embed_mlp)


class ShiftUNet(nn.Module):

    def __init__(self, input_channel: int, base_channel: int,
                 channel_multiplier: Sequence[int],
                 num_residual_blocks_of_a_block: int,
                 attention_resolutions: Sequence[int], latent_dim: int,
                 num_heads: int = 1, head_channel: int = -1,
                 use_new_attention_order: bool = False, dropout: float = 0.0,
                 learn_sigma: bool = False):
        super().__init__()
        self.base_channel = base_channel
        self.time_embed = time_embed_mlp(base_channel)
        self.label_emb = nn.Linear(latent_dim, base_channel * 4)
        geometry = (base_channel, channel_multiplier, num_residual_blocks_of_a_block,
                    attention_resolutions, num_heads, head_channel,
                    use_new_attention_order, dropout)
        self.input_blocks, skip_chans = build_input_stack(*geometry, input_channel)
        self.middle_block, self.output_blocks, final_ch = build_decode_stack(
            *geometry, skip_chans)
        self.shift_middle_block, self.shift_output_blocks, _ = build_decode_stack(
            *geometry, skip_chans, shift=True)
        self.out = output_head(final_ch, input_channel * 2 if learn_sigma
                               else input_channel)
        self.shift_out = output_head(final_ch, input_channel)

    def forward(self, x, time, condition):
        """``condition`` is the semantic latent z ``[N, latent_dim]``."""
        emb = self.time_embed(timestep_embedding(time, self.base_channel))
        shift_emb = self.label_emb(condition.to(x.dtype))
        hs = []
        h = x
        for stage in self.input_blocks:
            h = apply_stage(stage, h, emb)
            hs.append(h)
        epsilon_h = apply_stage(self.middle_block, h, emb)
        shift_h = apply_stage(self.shift_middle_block, h, emb, shift_emb)
        for stage, shift_stage in zip(self.output_blocks, self.shift_output_blocks):
            h_previous = hs.pop()
            epsilon_h = apply_stage(stage, torch.cat([epsilon_h, h_previous], dim=1), emb)
            shift_h = apply_stage(shift_stage, torch.cat([shift_h, h_previous], dim=1),
                                  emb, shift_emb)
        epsilon = self.out[2](self.out[0](epsilon_h))
        gradient = self.shift_out[2](self.shift_out[0](shift_h))
        return epsilon.float(), gradient.float()
