"""MLPSkipNet, the MLP denoiser of the latent DPM.

Port of ``pdae_tpu/models/mlp_skip_net.py``: ``num_layers`` blocks, the input
z concatenated (skip) into every layer after the first, time conditioning by
a per-layer scale ``h * (1 + cond)`` before the LayerNorm. The keys follow the
reference layout (``export_mlp_skip_net_state_dict`` of the JAX package):
``time_embed.0/.2``, ``layers.<i>.linear``, ``layers.<i>.linear_emb`` and
``layers.<i>.norm``. The reference registers each ``linear_emb`` a second time
as ``layers.<i>.cond_layers.1``; here one ``nn.Linear`` sits under both names,
so a state dict with both keys loads with ``strict=True``. ``dtype`` is the
compute dtype (``models/blocks.py``): z is cast to it, each LayerNorm takes
fp32 statistics first, the output is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import LayerNorm, Linear, timestep_embedding


class MLPLNAct(nn.Module):
    """Linear -> (times 1 + cond) -> LayerNorm -> SiLU -> dropout; the last
    layer has no condition, norm or activation."""

    def __init__(self, in_channels: int, out_channels: int, norm: bool,
                 use_cond: bool, activation: str, dropout: float,
                 cond_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.linear = Linear(in_channels, out_channels, compute_dtype=dtype)
        if use_cond:
            self.linear_emb = Linear(cond_channels, out_channels, compute_dtype=dtype)
            self.cond_layers = nn.Sequential(
                nn.SiLU() if activation == "silu" else nn.Identity(), self.linear_emb)
        else:
            self.cond_layers = None
        self.norm = (LayerNorm(out_channels, eps=1e-5, compute_dtype=dtype) if norm
                     else None)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        if activation == "silu":       # the reference's kaiming init
            for layer in (self.linear,) + ((self.linear_emb,) if use_cond else ()):
                nn.init.kaiming_normal_(layer.weight)
                nn.init.zeros_(layer.bias)

    def forward(self, x, cond=None):
        x = self.linear(x)
        if self.cond_layers is not None:
            x = x * (1.0 + self.cond_layers(cond))
        if self.norm is not None:
            x = self.norm(x)
        if self.activation == "silu":
            x = F.silu(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class MLPSkipNet(nn.Module):
    """Latent denoiser ``f(z_t, t) -> eps``."""

    def __init__(self, input_channel: int, model_channel: int = 2048,
                 num_layers: int = 10, time_emb_channel: int = 64,
                 use_norm: bool = True, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.time_emb_channel = time_emb_channel
        self.dtype = dtype
        self.time_embed = nn.Sequential(
            Linear(time_emb_channel, input_channel, compute_dtype=dtype), nn.SiLU(),
            Linear(input_channel, input_channel, compute_dtype=dtype))
        layers = []
        for i in range(num_layers):
            last = i == num_layers - 1
            layers.append(MLPLNAct(
                (model_channel if i > 0 else 0) + input_channel,
                input_channel if last else model_channel,
                norm=use_norm and not last, use_cond=not last,
                activation="none" if last else "silu",
                dropout=0.0 if last else dropout, cond_channels=input_channel,
                dtype=dtype))
        self.layers = nn.ModuleList(layers)

    def forward(self, x, t):
        cond = self.time_embed(timestep_embedding(t, self.time_emb_channel))
        x = x.to(self.dtype)
        h = x
        for i, layer in enumerate(self.layers):
            if i > 0:
                h = torch.cat([h, x], dim=-1)
            h = layer(h, cond)
        return h.float()
