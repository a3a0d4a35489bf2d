"""ShiftUNet, the PDAE decoder: a frozen pre-trained UNet trunk plus a
parallel trainable gradient branch, NCHW in and out (channels-last inside in
bf16: ``blocks.nhwc_model``).

Port of ``pdae_tpu/models/shift_unet.py``. The input trunk runs once and both
decode stacks (``middle_block``/``output_blocks`` for epsilon,
``shift_middle_block``/``shift_output_blocks`` for the gradient) read the
same stored skips. ``forward`` returns ``(epsilon, gradient)``.

Freezing: the pre-trained trunk (``FROZEN_PREFIXES``) never trains. Its
parameters are built with ``requires_grad_(False)`` and its modules stay in
eval mode whatever ``train()`` is asked for, so dropout acts in the shift
branch alone (the JAX model's ``deterministic`` / ``shift_deterministic``
pair) and a backward saves nothing for the trunk. Only
``SHIFT_TRAINABLE_PREFIXES`` train.

``dtype`` is the compute dtype (``models/blocks.py``): x and z are cast to it,
both outputs are fp32. The epsilon decode runs before the shift branch, so
that its transients are gone before the shift branch's saved activations
pile up. ``remat`` (``runner_config.remat``) puts non-reentrant activation
checkpoints on the training forward: ``"skips"`` on the shift branch, so the
backward keeps the trunk's skips and recomputes the shift branch alone;
``"full"`` on the trunk and the shift branch together (the epsilon decode,
which no gradient reaches, runs outside, as JAX's remat leaves it out of the
recompute); the RNG state is stashed only where the model draws
(``unet.draws``). Under spatial parallelism (``sp``, ``parallel/sp.py``) x
and z come in whole, the trunk and both decodes run on the rank's rows, and
both outputs are whole on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Linear, model_input, model_output, timestep_embedding
from torch.utils.checkpoint import checkpoint

from ..parallel import sp as _sp
from .unet import (apply_stage, build_decode_stack, build_input_stack, check_remat,
                   decode, draws, output_head, rematerialised, skip_heights, time_embed_mlp)


# Top-level names of the trainable PDAE branch, in the port's key layout
# (the JAX package's ``shift_out_norm``/``shift_out_conv`` are ``shift_out.0/.2``
# here); everything else is the frozen pre-trained DPM.
SHIFT_TRAINABLE_PREFIXES = ("label_emb", "shift_middle_block",
                            "shift_output_blocks", "shift_out")
FROZEN_PREFIXES = ("time_embed", "input_blocks", "middle_block", "output_blocks",
                   "out")


class ShiftUNet(nn.Module):

    sp = _sp.ONE       # the groups of spatial parallelism (parallel/sp.py)

    def __init__(self, input_channel: int, base_channel: int,
                 channel_multiplier: Sequence[int],
                 num_residual_blocks_of_a_block: int,
                 attention_resolutions: Sequence[int], latent_dim: int,
                 num_heads: int = 1, head_channel: int = -1,
                 use_new_attention_order: bool = False, dropout: float = 0.0,
                 learn_sigma: bool = False, dtype=torch.float32):
        super().__init__()
        self.base_channel = base_channel
        self.dtype = dtype
        self.time_embed = time_embed_mlp(base_channel, dtype)
        self.label_emb = Linear(latent_dim, base_channel * 4, compute_dtype=dtype)
        geometry = (base_channel, channel_multiplier, num_residual_blocks_of_a_block,
                    attention_resolutions, num_heads, head_channel,
                    use_new_attention_order, dropout)
        self.input_blocks, skip_chans = build_input_stack(*geometry, input_channel,
                                                          dtype=dtype)
        self.middle_block, self.output_blocks, final_ch = build_decode_stack(
            *geometry, skip_chans, dtype=dtype)
        self.shift_middle_block, self.shift_output_blocks, _ = build_decode_stack(
            *geometry, skip_chans, shift=True, dtype=dtype)
        self.out = output_head(final_ch, input_channel * 2 if learn_sigma
                               else input_channel, dtype)
        self.shift_out = output_head(final_ch, input_channel, dtype)
        for name in FROZEN_PREFIXES:
            getattr(self, name).requires_grad_(False)
        self.train()

    def train(self, mode: bool = True):
        """Set the shift branch's mode; the frozen trunk stays in eval mode."""
        super().train(mode)
        for name in FROZEN_PREFIXES:
            getattr(self, name).eval()
        return self

    def _trunk(self, x, emb):
        hs = []
        h, inputs = x, [x.shape[2]] + skip_heights(self.input_blocks, x.shape[2])[:-1]
        h = _sp.enter(h, self.sp)
        for stage, height in zip(self.input_blocks, inputs):
            h = apply_stage(stage, h, emb, None, self.sp, height)
            hs.append(h)
        return hs

    def _decode(self, middle, outputs, head, hs, height, emb, emb_z=None):
        """A decode from the skips ``hs`` of an input of ``height`` rows."""
        return decode(middle, outputs, head, hs, emb, emb_z, self.sp,
                      skip_heights(self.input_blocks, height))

    def _shift(self, hs, height, emb, shift_emb):
        return self._decode(self.shift_middle_block, self.shift_output_blocks, self.shift_out,
                            hs, height, emb, shift_emb)

    def _trunk_and_shift(self, x, emb, shift_emb):
        hs = self._trunk(x, emb)
        return (self._shift(hs, x.shape[2], emb, shift_emb), *hs)

    def forward(self, x, time, condition, remat=None):
        """``condition`` is the semantic latent z ``[N, latent_dim]``."""
        check_remat(remat)
        emb = self.time_embed(timestep_embedding(time, self.base_channel))
        shift_emb = self.label_emb(condition.to(self.dtype))
        x = model_input(self, x)
        height = x.shape[2]
        rng = remat is not None and draws(self)
        if remat == "full":
            gradient, *hs = checkpoint(self._trunk_and_shift, x, emb, shift_emb,
                                       use_reentrant=False, preserve_rng_state=rng)
            epsilon = self._decode(self.middle_block, self.output_blocks, self.out, hs, height,
                                   emb)
        else:
            hs = self._trunk(x, emb)
            epsilon = self._decode(self.middle_block, self.output_blocks, self.out, hs, height,
                                   emb)
            gradient = rematerialised(remat == "skips", self._shift, hs, height, emb,
                                      shift_emb, rng=rng)
        return model_output(epsilon), model_output(gradient)
