"""Plain PyTorch versions of the PDAE models: the semantic encoder and the
ShiftUNet (a frozen DPM trunk with its epsilon decode, and the trained
gradient branch), NCHW, written from the published description (ADM's UNet,
PDAE's shift branch) in fp32 with no kernel, cache or batching.

The parameter names follow the reference PyTorch state-dict layout, so one
state dict made by ``h100_bench.weights`` loads into these modules and into
the program's alike. Every convolution, linear layer and attention product
goes through ``Precision`` (``h100_bench.reference.precision``), which is
plain fp32 unless a control asks for a lower precision.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .precision import FP32, Precision

GN_EPS = 1e-5


def num_groups(channels: int) -> int:
    """GroupNorm(32), or the largest divisor below 32 for narrow channels."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the diffusion step, ``[cos | sin]``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Norm(nn.GroupNorm):
    """GroupNorm, AdaGN and SiLU: ``forward(x, scale, shift, z_scale,
    z_shift)`` is silu((1 + z_scale) * (GN(x) * (1 + scale) + shift) +
    z_shift), two-pass statistics in fp32; a step whose inputs are None is
    left out."""

    def __init__(self, channels: int):
        super().__init__(num_groups(channels), channels, GN_EPS)

    def forward(self, x, scale=None, shift=None, z_scale=None, z_shift=None):
        b = x.shape[0]
        xf = x.float().reshape(b, self.num_groups, -1)
        mean = xf.mean(dim=2, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=2, keepdim=True)
        y = ((xf - mean) / torch.sqrt(var + GN_EPS)).reshape(x.shape)
        y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        if scale is not None:
            y = y * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
        if z_scale is not None:
            y = (1.0 + z_scale[:, :, None, None]) * y + z_shift[:, :, None, None]
        return y * torch.sigmoid(y)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose product runs in the model's ``Precision``."""

    precision: Precision = FP32

    def forward(self, x):
        return self.precision.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Conv1(nn.Conv1d):
    precision: Precision = FP32

    def forward(self, x):
        return self.precision.conv1d(x, self.weight, self.bias)


class Dense(nn.Linear):
    precision: Precision = FP32

    def forward(self, x):
        return self.precision.linear(x, self.weight, self.bias)


def conv3x3(cin, cout, stride=1):
    return Conv(cin, cout, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    """ADM's residual block with AdaGN on the time embedding; with ``shift``
    PDAE's block, whose second norm also takes (z_scale, z_shift) from the
    latent's embedding."""

    def __init__(self, ch, emb_ch, out_ch=None, up=False, down=False, shift=False):
        super().__init__()
        out_ch = out_ch or ch
        self.up, self.down, self.shift = up, down, shift
        self.in_layers = nn.ModuleList([Norm(ch), nn.SiLU(), conv3x3(ch, out_ch)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), Dense(emb_ch, 2 * out_ch)])
        if shift:
            self.emb_z_layers = nn.ModuleList([nn.SiLU(), Dense(emb_ch, 2 * out_ch)])
        self.out_layers = nn.ModuleList([Norm(out_ch), nn.SiLU(), nn.Dropout(0.0),
                                         conv3x3(out_ch, out_ch)])
        self.skip_connection = (nn.Identity() if out_ch == ch
                                else Conv(ch, out_ch, 1))

    def forward(self, x, emb, emb_z=None):
        h = self.in_layers[0](x)
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers[1](F.silu(emb)).chunk(2, dim=1)
        z_scale = z_shift = None
        if self.shift:
            z_scale, z_shift = self.emb_z_layers[1](F.silu(emb_z)).chunk(2, dim=1)
        h = self.out_layers[0](h, scale, shift, z_scale, z_shift)
        return self.skip_connection(x) + self.out_layers[3](h)


class AttentionBlock(nn.Module):
    """GroupNorm, a 1x1 qkv projection, heads in the legacy heads-major split,
    softmax attention with D^-1/4 on q and on k, a 1x1 output projection and
    the residual."""

    def __init__(self, ch, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(num_groups(ch), ch, GN_EPS)
        self.qkv = Conv1(ch, 3 * ch, 1)
        self.proj_out = Conv1(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        tokens = x.reshape(b, c, hh * ww)
        qkv = self.qkv(self.norm(tokens))
        d = c // self.num_heads
        q, k, v = qkv.reshape(b * self.num_heads, 3 * d, hh * ww).split(d, dim=1)
        s = 1.0 / math.sqrt(math.sqrt(d))
        p = self.proj_out.precision
        w = torch.softmax(p.bmm((q * s).transpose(1, 2), k * s), dim=-1)   # [bH, T, T]
        a = p.bmm(v, w.transpose(1, 2)).reshape(b, c, hh * ww)            # [bH, D, T]
        return (tokens + self.proj_out(a)).reshape(b, c, hh, ww)


def _stage(layers, h, emb, emb_z):
    for layer in layers:
        h = layer(h, emb, emb_z) if isinstance(layer, ResBlock) else layer(h)
    return h


def _input_stack(base, mult, nres, attn, heads, cin):
    emb = 4 * base
    ch = mult[0] * base
    blocks = nn.ModuleList([nn.ModuleList([conv3x3(cin, ch)])])
    skips, ds = [ch], 1
    for level, m in enumerate(mult):
        for _ in range(nres):
            layers = [ResBlock(ch, emb, m * base)]
            ch = m * base
            if ds in attn:
                layers.append(AttentionBlock(ch, heads))
            blocks.append(nn.ModuleList(layers))
            skips.append(ch)
        if level != len(mult) - 1:
            blocks.append(nn.ModuleList([ResBlock(ch, emb, ch, down=True)]))
            skips.append(ch)
            ds *= 2
    return blocks, skips


def _decode_stack(base, mult, nres, attn, heads, skips, shift):
    emb = 4 * base
    skips = list(skips)
    ch, ds = skips[-1], 2 ** (len(mult) - 1)
    middle = nn.ModuleList([ResBlock(ch, emb, shift=shift), AttentionBlock(ch, heads),
                            ResBlock(ch, emb, shift=shift)])
    out = nn.ModuleList()
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nres + 1):
            layers = [ResBlock(ch + skips.pop(), emb, m * base, shift=shift)]
            ch = m * base
            if ds in attn:
                layers.append(AttentionBlock(ch, heads))
            if level and i == nres:
                layers.append(ResBlock(ch, emb, ch, up=True, shift=shift))
                ds //= 2
            out.append(nn.ModuleList(layers))
    return middle, out, ch


def _head(ch, cout):
    return nn.ModuleList([Norm(ch), nn.SiLU(), conv3x3(ch, cout)])


class ShiftUNet(nn.Module):
    """PDAE's decoder: ``forward(x, t, z) -> (epsilon, gradient)``. The
    trunk (``time_embed``, ``input_blocks``, ``middle_block``,
    ``output_blocks``, ``out``) is the pre-trained DPM; ``label_emb`` and the
    ``shift_*`` modules are the trained gradient branch, which reads the
    trunk's skips."""

    TRAINED = ("label_emb", "shift_middle_block", "shift_output_blocks", "shift_out")

    def __init__(self, input_channel: int, base_channel: int,
                 channel_multiplier: Sequence[int], num_residual_blocks_of_a_block: int,
                 attention_resolutions: Sequence[int], num_heads: int, latent_dim: int,
                 **_ignored):
        super().__init__()
        base, mult = base_channel, tuple(channel_multiplier)
        nres, attn = num_residual_blocks_of_a_block, set(attention_resolutions)
        self.base = base
        self.time_embed = nn.Sequential(Dense(base, 4 * base), nn.SiLU(),
                                        Dense(4 * base, 4 * base))
        self.label_emb = Dense(latent_dim, 4 * base)
        self.input_blocks, skips = _input_stack(base, mult, nres, attn, num_heads,
                                                input_channel)
        self.middle_block, self.output_blocks, ch = _decode_stack(
            base, mult, nres, attn, num_heads, skips, False)
        self.shift_middle_block, self.shift_output_blocks, _ = _decode_stack(
            base, mult, nres, attn, num_heads, skips, True)
        self.out = _head(ch, input_channel)
        self.shift_out = _head(ch, input_channel)

    def trunk(self, x, emb):
        hs, h = [], x
        for stage in self.input_blocks:
            h = _stage(stage, h, emb, None)
            hs.append(h)
        return hs

    @staticmethod
    def decode(middle, outputs, head, hs, emb, emb_z=None):
        h = _stage(middle, hs[-1], emb, emb_z)
        for stage, skip in zip(outputs, reversed(hs)):
            h = _stage(stage, torch.cat([h, skip], dim=1), emb, emb_z)
        return head[2](head[0](h))

    def forward(self, x, t, z):
        emb = self.time_embed(timestep_embedding(t, self.base))
        hs = self.trunk(x, emb)
        eps = self.decode(self.middle_block, self.output_blocks, self.out, hs, emb)
        grad = self.decode(self.shift_middle_block, self.shift_output_blocks,
                           self.shift_out, hs, emb, self.label_emb(z))
        return eps, grad


class Encoder(nn.Module):
    """PDAE's semantic encoder: stride-2 3x3 convs with GN+SiLU between them,
    one attention block, GN+SiLU, flatten and a linear layer to the latent.
    64px: channels (64, 128, 128, 128), attention after stage 2; 128px:
    (64, 128, 256, 256, 256), after stage 3."""

    GEOMETRY = {64: ((64, 128, 128, 128), 2), 128: ((64, 128, 256, 256, 256), 3)}

    def __init__(self, image_size: int, latent_dim: int, input_channel: int = 3):
        super().__init__()
        channels, attn_after = self.GEOMETRY[image_size]
        layers, cin = [], input_channel
        for i, ch in enumerate(channels):
            if i:
                layers += [Norm(cin), nn.SiLU()]
            layers.append(conv3x3(cin, ch, stride=2))
            cin = ch
            if i + 1 == attn_after:
                layers.append(AttentionBlock(ch, 4))
        final = image_size >> len(channels)
        layers += [Norm(cin), nn.SiLU(), nn.Flatten(),
                   Dense(cin * final * final, latent_dim)]
        self.encoder = nn.Sequential(*layers)

    def forward(self, x):
        h = x
        for layer in self.encoder:
            if not isinstance(layer, nn.SiLU):     # its SiLU runs in the norm before it
                h = layer(h)
        return h


def set_precision(model: nn.Module, precision: Precision) -> nn.Module:
    """Every product of ``model`` in ``precision``."""
    for m in model.modules():
        if isinstance(m, (Conv, Conv1, Dense)):
            m.precision = precision
    return model
