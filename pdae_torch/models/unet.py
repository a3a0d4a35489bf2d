"""ADM-style diffusion UNet, NCHW in and out (channels-last inside in bf16:
``blocks.nhwc_model``).

Port of ``pdae_tpu/models/unet.py``. The trunk builders
(``build_input_stack``, ``build_decode_stack``; ``build_trunk`` in the JAX
package) are shared with ``ShiftUNet`` so the frozen trunk has one layout in
both models; stage lists
are ``nn.ModuleList``s so the state-dict keys read ``input_blocks.I.J.*``,
``middle_block.J.*`` and ``output_blocks.I.J.*`` as in the reference.

``dtype`` is the compute dtype of ``pdae_tpu``'s models (see ``blocks``): the
input is cast to it, every stage runs in it, the output is fp32.
``remat`` is the training forward's rematerialisation
(``runner_config.remat``, ``pdae_tpu/training/steps.py::remat_wrap``) under
non-reentrant activation checkpoints: ``"full"`` checkpoints the whole
forward; ``"skips"`` keeps the skips, as JAX's policy keeps the tagged ones,
and checkpoints each input stage and then the decode, so the backward
recomputes the rest from them. A checkpoint stashes and restores the RNG
state only where a module of the model draws (``draws``: dropout in train
mode), so that a forward without draws reads no RNG state on the host and
can be captured into a CUDA graph like any other.

Under spatial parallelism (``parallel/sp.py``: ``sp`` set by ``shard_rows``)
the forward takes ``x`` whole, runs every stage on the rank's rows of each
map whose height splits (``apply_stage`` and ``decode`` with the sp groups
and the maps' heights) and returns the whole output on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import sp as _sp
from .blocks import (AttentionBlock, Embedding, GNSiluChain, Linear, ResBlock,
                     ResBlockShift, conv3x3, model_input, model_output, timestep_embedding,
                     zero_init)


def time_embed_mlp(base_channel: int, dtype=torch.float32) -> nn.Sequential:
    """Two-layer SiLU MLP on the sinusoidal embedding (``time_embed.0/.2``)."""
    dim = base_channel * 4
    return nn.Sequential(Linear(base_channel, dim, compute_dtype=dtype), nn.SiLU(),
                         Linear(dim, dim, compute_dtype=dtype))


def _attention(ch, num_heads, head_channel, use_new_attention_order, dtype):
    return AttentionBlock(ch, num_heads=num_heads, head_channel=head_channel,
                          use_new_attention_order=use_new_attention_order, dtype=dtype)


REMAT_MODES = (None, "skips", "full")


def check_remat(remat) -> None:
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")


def draws(model: nn.Module) -> bool:
    """Whether a forward of ``model`` draws from the RNG: a dropout with p >
    0 in train mode."""
    return any(isinstance(m, nn.Dropout) and m.p > 0 and m.training
               for m in model.modules())


def rematerialised(remat: bool, fn, *args, rng: bool = True):
    """``fn(*args)``, under a non-reentrant activation checkpoint where
    ``remat``: the backward recomputes what ``fn`` saved, with the forward's
    RNG state (the same dropout masks) where ``rng``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=rng)
    return fn(*args)


def build_input_stack(base_channel: int, channel_multiplier: Sequence[int],
                      num_residual_blocks_of_a_block: int,
                      attention_resolutions: Sequence[int], num_heads: int,
                      head_channel: int, use_new_attention_order: bool,
                      dropout: float, input_channel: int, dtype=torch.float32):
    """Build the encoding half of the trunk.

    Returns ``(input_blocks, skip_chans)``: the stage list and the channel
    count of each stored skip, in push order. Attention goes only where the
    downsample rate ``ds`` is in ``attention_resolutions``.
    """
    attn = set(attention_resolutions)
    time_embed_dim = base_channel * 4
    ch = int(channel_multiplier[0] * base_channel)
    input_blocks = nn.ModuleList([nn.ModuleList([conv3x3(input_channel, ch, dtype=dtype)])])
    skip_chans = [ch]
    ds = 1
    for level, mult in enumerate(channel_multiplier):
        for _ in range(num_residual_blocks_of_a_block):
            layers = [ResBlock(ch, time_embed_dim, dropout,
                               out_channels=int(mult * base_channel), dtype=dtype)]
            ch = int(mult * base_channel)
            if ds in attn:
                layers.append(_attention(ch, num_heads, head_channel,
                                         use_new_attention_order, dtype))
            input_blocks.append(nn.ModuleList(layers))
            skip_chans.append(ch)
        if level != len(channel_multiplier) - 1:
            input_blocks.append(nn.ModuleList([
                ResBlock(ch, time_embed_dim, dropout, out_channels=ch, down=True,
                         dtype=dtype)]))
            skip_chans.append(ch)
            ds *= 2
    return input_blocks, skip_chans


def build_decode_stack(base_channel: int, channel_multiplier: Sequence[int],
                       num_residual_blocks_of_a_block: int,
                       attention_resolutions: Sequence[int], num_heads: int,
                       head_channel: int, use_new_attention_order: bool,
                       dropout: float, skip_chans: Sequence[int],
                       shift: bool = False, dtype=torch.float32):
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
        Res(ch, time_embed_dim, dropout, dtype=dtype),
        _attention(ch, num_heads, head_channel, use_new_attention_order, dtype),
        Res(ch, time_embed_dim, dropout, dtype=dtype),
    ])

    output_blocks = nn.ModuleList()
    for level, mult in list(enumerate(channel_multiplier))[::-1]:
        for i in range(num_residual_blocks_of_a_block + 1):
            ich = skips.pop()
            layers = [Res(ch + ich, time_embed_dim, dropout,
                          out_channels=int(base_channel * mult), dtype=dtype)]
            ch = int(base_channel * mult)
            if ds in attn:
                layers.append(_attention(ch, num_heads, head_channel,
                                         use_new_attention_order, dtype))
            if level and i == num_residual_blocks_of_a_block:
                layers.append(Res(ch, time_embed_dim, dropout, out_channels=ch, up=True,
                                  dtype=dtype))
                ds //= 2
            output_blocks.append(nn.ModuleList(layers))
    return middle_block, output_blocks, ch


def stage_height(layers, height: int) -> int:
    """The height of a stage's output from its input's ``height``."""
    for layer in layers:
        if isinstance(layer, ResBlock):
            height = layer.out_height(height)
        elif not isinstance(layer, AttentionBlock):
            height //= layer.stride[0]
    return height


def skip_heights(input_blocks, height: int) -> list:
    """The heights of the input stages' outputs (the skips) from the
    input's ``height``."""
    out = []
    for stage in input_blocks:
        height = stage_height(stage, height)
        out.append(height)
    return out


def apply_stage(layers, h, emb, emb_z=None, sp=_sp.ONE, height=None):
    """Apply one stage list, dispatching on layer kind, to a map of
    ``height`` rows (its own by default); under spatial parallelism
    (``sp``, the groups) on the rank's rows where it splits."""
    height = h.shape[2] if height is None else height
    for layer in layers:
        if isinstance(layer, ResBlock):
            h = layer(h, emb, emb_z, sp, height)
            height = layer.out_height(height)
        elif isinstance(layer, AttentionBlock):
            h = layer(h, sp, height)
        else:
            h, height = _sp.conv(layer, h, sp, height)
    return h


def decode(middle_block, output_blocks, head, skips, emb, emb_z=None, sp=_sp.ONE,
           heights=None):
    """The middle block from the last skip, the output stages each on the
    concat with its skip (the last first), then the output head; ``skips``
    is not modified. ``heights`` are the skips' heights (their own by
    default); under spatial parallelism (``sp``) the output is whole on
    every rank."""
    heights = heights or [s.shape[2] for s in skips]
    h = apply_stage(middle_block, skips[-1], emb, emb_z, sp, heights[-1])
    for stage, skip, height in zip(output_blocks, reversed(skips), reversed(heights)):
        h = apply_stage(stage, torch.cat([h, skip], dim=1), emb, emb_z, sp, height)
    out, height = _sp.conv(head[2], _sp.chain(head[0], h, sp, heights[0]), sp, heights[0])
    return _sp.leave(out, sp, height)


def output_head(final_ch: int, out_ch: int, dtype=torch.float32) -> nn.ModuleList:
    """``[GN, SiLU, zero-init conv]`` (``out.0``/``out.2``); index 1 is fused
    into the chain at index 0."""
    return nn.ModuleList([GNSiluChain(final_ch), nn.Identity(),
                          zero_init(conv3x3(final_ch, out_ch, dtype=dtype))])


class UNet(nn.Module):
    """Epsilon-prediction UNet. ``x`` is NCHW, ``time`` an int [N] vector on
    the original diffusion time axis, ``condition`` an optional [N] class."""

    sp = _sp.ONE       # the groups of spatial parallelism (parallel/sp.py)

    def __init__(self, input_channel: int, base_channel: int,
                 channel_multiplier: Sequence[int],
                 num_residual_blocks_of_a_block: int,
                 attention_resolutions: Sequence[int], num_heads: int = 1,
                 head_channel: int = -1, use_new_attention_order: bool = False,
                 dropout: float = 0.0, num_class: Optional[int] = None,
                 learn_sigma: bool = False, dtype=torch.float32):
        super().__init__()
        self.base_channel = base_channel
        self.dtype = dtype
        self.time_embed = time_embed_mlp(base_channel, dtype)
        if num_class is not None:
            self.label_emb = Embedding(num_class, base_channel * 4)
        geometry = (base_channel, channel_multiplier, num_residual_blocks_of_a_block,
                    attention_resolutions, num_heads, head_channel,
                    use_new_attention_order, dropout)
        self.input_blocks, skip_chans = build_input_stack(*geometry, input_channel,
                                                          dtype=dtype)
        self.middle_block, self.output_blocks, final_ch = build_decode_stack(
            *geometry, skip_chans, dtype=dtype)
        self.out = output_head(final_ch, input_channel * 2 if learn_sigma
                               else input_channel, dtype)

    def forward(self, x, time, condition=None, remat=None):
        check_remat(remat)
        rng = remat is not None and draws(self)
        if remat == "full":
            return checkpoint(self.forward, x, time, condition, use_reentrant=False,
                              preserve_rng_state=rng)
        remat_skips = remat == "skips"
        emb = self.time_embed(timestep_embedding(time, self.base_channel))
        if hasattr(self, "label_emb"):
            if condition is None:
                raise ValueError("a class-conditional UNet needs a condition")
            emb = emb + self.label_emb(condition).to(self.dtype)
        hs = []
        h = model_input(self, x)
        heights = skip_heights(self.input_blocks, h.shape[2])
        inputs = [h.shape[2]] + heights[:-1]
        h = _sp.enter(h, self.sp)
        for stage, height in zip(self.input_blocks, inputs):
            h = rematerialised(remat_skips, apply_stage, stage, h, emb, None, self.sp,
                               height, rng=rng)
            hs.append(h)
        return model_output(rematerialised(remat_skips, decode, self.middle_block,
                                           self.output_blocks, self.out, hs, emb, None,
                                           self.sp, heights, rng=rng))
