"""Building blocks of the diffusion UNets, NCHW or channels-last.

Port of ``pdae_tpu/models/blocks.py``. Submodule names and indices follow the
reference torch state-dict layout (``pdae_tpu/utils/torch_convert.py``), so a
converted checkpoint loads with ``load_state_dict(strict=True)``. Where the
reference has a SiLU after a GroupNorm, the GN+AdaGN+SiLU chain runs as one op
(``pdae_torch.ops.gn_adagn_silu``) and the SiLU's index holds an
``nn.Identity`` placeholder, which has no parameters.

Compute dtype, as the JAX blocks' ``dtype`` attribute: parameters stay fp32
and each conv, linear and norm that has a ``compute_dtype`` casts its input
and its parameters to it at the call, as flax's ``dtype=`` does, and returns
that dtype (``Conv2d``, ``Conv1d``, ``Linear``; the norms compute in fp32
first, as flax's ``_normalize``). The casts are written out, not left to
``torch.autocast``, whose op lists are not flax's. In fp32 every cast is the
tensor itself, so the fp32 graph is the one without them. The GN+AdaGN+SiLU
chain computes in the dtype of its input.

Memory layout (``nhwc_model``): a model computing in bf16 and unsharded by
tensor and spatial parallelism takes its input channels-last
(``model_input``), keeps every activation so (cuDNN's bf16 kernels on sm90
run NHWC, so an NCHW model would transpose each conv's tensors in and out)
and hands its outputs back contiguous NCHW (``model_output``). The blocks
follow their input: a conv on a channels-last map casts its filter to
channels-last in the same copy as the cast to the compute dtype, the GN
chain runs the kernels' NHWC variants, and the attention block runs its
norm and 1x1 products on the ``[B, T, C]`` view of the map. Everything else
(fp32 models, the tp and sp paths) is NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..parallel import sp as _sp
from ..parallel import tp as _tp


def is_nhwc(x: torch.Tensor) -> bool:
    """Whether ``x`` is a channels-last map (a shape that is contiguous both
    ways, H*W = 1 or C = 1, counts as NCHW)."""
    return ops.groupnorm.memory_layout(x) == "nhwc"


def nhwc_model(model: nn.Module) -> bool:
    """The layout rule: a UNet, ShiftUNet or semantic encoder runs
    channels-last where it computes in bf16 and runs unsharded: no spatial
    parallelism (``sp``) and no tensor parallelism (``parallel/tp.py`` marks
    every ResBlock and AttentionBlock of a sharded model)."""
    if model.dtype != torch.bfloat16 or model.sp.sp > 1:
        return False
    block = next((m for m in model.modules() if isinstance(m, (ResBlock, AttentionBlock))),
                 None)
    return block is None or block.tp is None


def model_input(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A model's input cast to its compute dtype: channels-last under
    ``nhwc_model``, else contiguous NCHW (the tensor itself where it is
    both already, as an fp32 model's NCHW input is)."""
    if x.dim() == 4 and nhwc_model(model):
        return x.to(model.dtype, memory_format=torch.channels_last)
    return x.to(model.dtype, memory_format=torch.contiguous_format)


def model_output(y: torch.Tensor) -> torch.Tensor:
    """A model's output, fp32 and contiguous (the tensor itself where it is
    both)."""
    return y.to(torch.float32, memory_format=torch.contiguous_format)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample. A channels-last map is upsampled as a broadcast
    copy of its ``[B, H, W, C]`` view, channels-last out: the same values, and
    on an H100 at the bf16 FFHQ128 step's shapes it and its backward (a sum
    of each 2x2 block) take about half the time of PyTorch's NHWC nearest
    kernels (an NCHW map's time)."""
    if not is_nhwc(x):
        return F.interpolate(x, scale_factor=2, mode="nearest")
    b, c, h, w = x.shape
    rows = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return rows.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool. A channels-last map is pooled as the mean of each
    2x2 block of its ``[B, H, W, C]`` view, channels-last out: the same values
    (a sum of four and a quarter of it), a third of the time of PyTorch's
    NHWC pooling kernel on an H100 at the FFHQ128 step's shapes."""
    b, c, h, w = x.shape
    if not is_nhwc(x) or h % 2 or w % 2:
        return F.avg_pool2d(x, 2)
    blocks = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    return blocks.mean(dim=(2, 4)).permute(0, 3, 1, 2)


class _NHWCConv(torch.autograd.Function):
    """A conv of a channels-last map whose backward takes the bias gradient
    as a product with a row of ones: PyTorch's sum over N, H and W of a
    channels-last bf16 gradient runs about three times as long as over an
    NCHW one on an H100, the product a third of the NCHW sum. The input and
    filter gradients are the conv's own (``convolution_backward``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.conf = (stride, padding, dilation, groups)
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.contiguous(memory_format=torch.channels_last)
        dx = dw = db = None
        if need_x or need_w:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, weight, None, stride, padding, dilation, False, [0, 0], groups,
                [need_x, need_w, False])
        if need_b:
            rows = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
            db = (rows.new_ones(1, rows.shape[0]) @ rows)[0]
        return dx, dw, db, None, None, None, None


def num_groups(channels: int) -> int:
    """GroupNorm(32), or the largest divisor <= 32 for narrow test models."""
    groups = min(32, channels)
    while channels % groups != 0:
        groups -= 1
    return groups


class _ComputeDtype:
    """Mixin of the layers below: ``compute_dtype`` is a keyword of the
    constructor (the layer's own ``dtype`` keyword stays its parameters')."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype


class _CastConv(_ComputeDtype):
    tp = None          # the split of a tensor-parallel module (parallel/tp.py)

    def forward(self, x):
        if self.tp is not None:
            return _tp.dense(self, x, False, False, 1)[0]
        dt = self.compute_dtype
        if is_nhwc(x):   # the filter's layout folded into its cast: one copy
            weight = self.weight.to(dt, memory_format=torch.channels_last)
            args = (x.to(dt), weight, self.bias.to(dt))
            # the Function only where a gradient is wanted: in eager bf16
            # FFHQ128 inference on an H100 its bookkeeping cost 9% of the host time
            if torch.is_grad_enabled() and any(a.requires_grad for a in args):
                return _NHWCConv.apply(*args, self.stride, self.padding, self.dilation,
                                       self.groups)
            return self._conv_forward(*args)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(_CastConv, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``: the input, weight and bias
    are cast at the call and the output keeps that dtype."""


class Conv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` (see ``Conv2d``)."""


class Linear(_ComputeDtype, nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``)."""

    tp = None

    def forward(self, x):
        if self.tp is not None:
            return _tp.dense(self, x, False, False, -1)[0]
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embedding(nn.Embedding):
    """``nn.Embedding`` that runs split in a tensor-parallel module."""

    tp = None

    def forward(self, x):
        if self.tp is not None:
            return _tp.dense(self, x, False, False, -1)[0]
        return super().forward(x)


class GroupNorm(_ComputeDtype, nn.GroupNorm):
    """``nn.GroupNorm`` with flax's ``GroupNorm(dtype=)`` order: statistics,
    normalisation and affine in fp32, then the cast to ``compute_dtype``."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)

    def forward_tokens(self, x):
        """The same on ``[B, T, C]`` tokens, channels last: the statistics of
        each group over its tokens and channels."""
        b, t, c = x.shape
        xg = x.float().reshape(b, t, self.num_groups, c // self.num_groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight + self.bias).to(self.compute_dtype)


class LayerNorm(_ComputeDtype, nn.LayerNorm):
    """``nn.LayerNorm`` with flax's ``LayerNorm(dtype=)`` order (see
    ``GroupNorm``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


def group_norm(channels: int, dtype=torch.float32) -> GroupNorm:
    return GroupNorm(num_groups(channels), channels, eps=1e-5, compute_dtype=dtype)


class GNSiluChain(nn.Module):
    """GroupNorm(+AdaGN)+SiLU with GroupNorm's parameters (``weight``,
    ``bias``); runs the model-mode op (the CUDA kernel on the card)."""

    tp = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = num_groups(channels)

    def forward(self, x, scale=None, shift=None, z_scale=None, z_shift=None):
        if self.tp is not None:
            # whole in, whole out: the kernel on the rank's channels (the
            # AdaGN inputs, where given, are the rank's channels too)
            h, _ = _tp.gn_chain(self, x, False, scale, shift, z_scale, z_shift)
            return _tp.gather(h, self.tp.groups, 1)
        return ops.gn_adagn_silu(x, self.weight, self.bias, scale, shift,
                                 z_scale, z_shift, self.groups)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, ``[cos | sin]`` layout."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def conv3x3(cin: int, cout: int, stride: int = 1, dtype=torch.float32) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, compute_dtype=dtype)


def zero_init(module: nn.Module) -> nn.Module:
    """Zero a layer's parameters, as the reference initialises its output
    convs and attention projections."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class Upsample(nn.Module):
    """2x nearest upsample with an optional 3x3 conv after it."""

    def __init__(self, channels: int, use_conv: bool, out_channels=None,
                 dtype=torch.float32):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = conv3x3(channels, out_channels or channels, dtype=dtype)

    def forward(self, x):
        x = upsample2x(x)
        return self.conv(x) if self.use_conv else x


class Downsample(nn.Module):
    """2x downsample by a stride-2 3x3 conv or a 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool, out_channels=None,
                 dtype=torch.float32):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = conv3x3(channels, out_channels or channels, stride=2, dtype=dtype)
        elif (out_channels or channels) != channels:
            raise ValueError("average-pool downsampling keeps the channel count")

    def forward(self, x):
        return self.op(x) if self.use_conv else avg_pool2x(x)


class ResBlock(nn.Module):
    """Residual block with AdaGN time conditioning; with ``shift=True`` the
    PDAE ResBlockShift, whose second chain also takes (z_scale, z_shift)
    from the latent embedding."""

    def __init__(self, channels: int, emb_channels: int, dropout: float,
                 out_channels=None, use_conv: bool = False, up: bool = False,
                 down: bool = False, shift: bool = False, dtype=torch.float32):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down, self.shift = up, down, shift
        # [GN, SiLU, conv] in the reference; index 1 is fused into index 0
        self.in_layers = nn.ModuleList([GNSiluChain(channels), nn.Identity(),
                                        conv3x3(channels, out_ch, dtype=dtype)])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(), Linear(emb_channels, 2 * out_ch, compute_dtype=dtype)])
        if shift:
            self.emb_z_layers = nn.ModuleList([
                nn.SiLU(), Linear(emb_channels, 2 * out_ch, compute_dtype=dtype)])
        # [GN, SiLU, dropout, zero-init conv]
        self.out_layers = nn.ModuleList([GNSiluChain(out_ch), nn.Identity(),
                                         nn.Dropout(dropout),
                                         zero_init(conv3x3(out_ch, out_ch, dtype=dtype))])
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = conv3x3(channels, out_ch, dtype=dtype)
        else:
            self.skip_connection = Conv2d(channels, out_ch, 1, compute_dtype=dtype)

    tp = None

    def forward(self, x, emb, emb_z=None, sp=_sp.ONE, height=None):
        """``x`` a map of ``height`` rows (its own by default); under spatial
        parallelism (``sp``, the groups of ``parallel/sp.py``) the rank's
        rows where the map splits, and the result likewise at
        ``out_height``; the embeddings whole."""
        if self.tp is not None:
            return self._forward_tp(x, emb, emb_z)
        height = x.shape[2] if height is None else height
        h_out = self.out_height(height)
        h = _sp.chain(self.in_layers[0], x, sp, height)
        if self.up:
            x, h = (_sp.resample(upsample2x, t, sp, height, h_out) for t in (x, h))
        elif self.down:
            h, x = (_sp.resample(avg_pool2x, t, sp, height, h_out) for t in (h, x))
        h, _ = _sp.conv(self.in_layers[2], h, sp, h_out)
        scale, shift = self.emb_layers[1](F.silu(emb)).chunk(2, dim=1)
        z_scale = z_shift = None
        if self.shift:
            z_scale, z_shift = self.emb_z_layers[1](F.silu(emb_z)).chunk(2, dim=1)
        h = _sp.chain(self.out_layers[0], h, sp, h_out, scale, shift, z_scale, z_shift)
        h, _ = _sp.conv(self.out_layers[3], _sp.dropout(self.out_layers[2], h, sp, h_out), sp,
                        h_out)
        if isinstance(self.skip_connection, nn.Identity):
            return x + h
        return _sp.conv(self.skip_connection, x, sp, h_out)[0] + h

    def out_height(self, height: int) -> int:
        return height * 2 if self.up else height // 2 if self.down else height

    def _adagn(self, linear, emb):
        """(scale, shift) of the out chain from ``linear`` on ``silu(emb)``:
        its ``[B, 2C]`` output whole (gathered: a rank's out block of ``2C``
        is not the scale and shift of its channels), then, where the chain
        runs on the rank's channels, those channels of each half."""
        g = self.tp.groups
        y, _ = _tp.dense(linear, F.silu(emb), False, False, -1, g)
        if self.out_layers[0].tp is None:
            return y.chunk(2, dim=1)
        return _tp.split(y.unflatten(1, (2, -1)), g, 2).unbind(1)

    def _forward_tp(self, x, emb, emb_z):
        """The forward of a tensor-parallel module (``parallel/tp.py``):
        ``x`` and the result whole, the convs and chains inside on the
        rank's channel blocks where their splits allow."""
        g = self.tp.groups
        h, hb = _tp.gn_chain(self.in_layers[0], x, False, groups=g)
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h, hb = _tp.dense(self.in_layers[2], h, hb, True, 1, g)
        scale, shift = self._adagn(self.emb_layers[1], emb)
        z_scale = z_shift = None
        if self.shift:
            z_scale, z_shift = self._adagn(self.emb_z_layers[1], emb_z)
        h, hb = _tp.gn_chain(self.out_layers[0], h, hb, scale, shift, z_scale, z_shift,
                             groups=g)
        h = _tp.dropout(self.out_layers[2], h, hb, g)
        h, hb = _tp.dense(self.out_layers[3], h, hb, True, 1, g)
        s, sb = ((x, False) if isinstance(self.skip_connection, nn.Identity) else
                 _tp.dense(self.skip_connection, x, False, True, 1, g))
        if hb and sb:
            return _tp.gather(s + h, g, 1)
        if hb:
            h = _tp.gather(h, g, 1)
        if sb:
            s = _tp.gather(s, g, 1)
        return s + h


class ResBlockShift(ResBlock):
    """PDAE conditioning block: the double AdaGN
    ``(1 + z_scale) * (GN(h) * (1 + scale) + shift) + z_shift``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, shift=True, **kwargs)


def split_heads(qkv: torch.Tensor, num_heads: int, new_order: bool):
    """``(q, k, v)``, each a contiguous ``[B, H, T, D]``, from ``qkv`` ``[B,
    3C, T]`` in the head order of ``qkv_attention``."""
    b, w, t = qkv.shape
    if w % (3 * num_heads):
        raise ValueError(f"{w} qkv channels do not split into 3 x {num_heads} heads")
    ch = w // (3 * num_heads)
    if new_order:
        q, k, v = qkv.reshape(b, 3, num_heads, ch, t).unbind(1)
    else:
        q, k, v = qkv.reshape(b, num_heads, 3, ch, t).unbind(2)
    return tuple(a.transpose(-1, -2).contiguous() for a in (q, k, v))


def split_heads_last(qkv: torch.Tensor, num_heads: int, new_order: bool):
    """``split_heads`` of ``qkv`` ``[B, T, 3C]``, the channels last."""
    b, t, w = qkv.shape
    if w % (3 * num_heads):
        raise ValueError(f"{w} qkv channels do not split into 3 x {num_heads} heads")
    ch = w // (3 * num_heads)
    if new_order:
        q, k, v = qkv.reshape(b, t, 3, num_heads, ch).unbind(2)
    else:
        q, k, v = qkv.reshape(b, t, num_heads, 3, ch).unbind(3)
    return tuple(a.transpose(1, 2).contiguous() for a in (q, k, v))


def pointwise(conv: "Conv1d", x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv1d`` on ``[B, T, C]`` tokens, channels last: the same
    product as a linear layer, in the conv's compute dtype."""
    dt = conv.compute_dtype
    return F.linear(x.to(dt), conv.weight[..., 0].to(dt), conv.bias.to(dt))


def qkv_attention(qkv: torch.Tensor, num_heads: int, new_order: bool) -> torch.Tensor:
    """Multi-head self-attention over flattened spatial tokens.

    ``qkv``: ``[B, 3C, T]``, the conv1d layout. ``new_order=False`` is the
    reference's legacy heads-major split (``[B, H, 3, D, T]``), ``True`` its
    qkv-major split (``[B, 3, H, D, T]``). q, k and v are permuted into
    contiguous ``[B, H, T, D]`` for the kernel; returns ``[B, C, T]``.
    """
    b, _, t = qkv.shape
    q, k, v = split_heads(qkv, num_heads, new_order)
    out = ops.fused_qkv_attention(q, k, v)
    return out.transpose(-1, -2).reshape(b, -1, t)


class AttentionBlock(nn.Module):
    """GN -> conv1d qkv -> multi-head attention -> zero-init conv1d proj ->
    residual. ``head_channel == -1`` selects ``num_heads`` heads, otherwise
    ``channels // head_channel``."""

    def __init__(self, channels: int, num_heads: int = 1, head_channel: int = -1,
                 use_new_attention_order: bool = False, dtype=torch.float32):
        super().__init__()
        if head_channel == -1:
            self.num_heads = num_heads
        else:
            if channels % head_channel:
                raise ValueError(f"{channels} channels, head_channel {head_channel}")
            self.num_heads = channels // head_channel
        self.new_order = use_new_attention_order
        self.norm = group_norm(channels, dtype)
        self.qkv = Conv1d(channels, 3 * channels, 1, compute_dtype=dtype)
        self.proj_out = zero_init(Conv1d(channels, channels, 1, compute_dtype=dtype))

    tp = None

    def forward(self, x, sp=_sp.ONE, height=None):
        """``x`` a map of ``height`` rows (its own by default); under spatial
        parallelism (``sp``) the rank's rows where the map splits: the
        norm's statistics summed over the sp group, and the rank's query
        tokens against k and v gathered in token order."""
        if self.tp is not None:
            return self._forward_tp(x)
        b, c, h, w = x.shape
        split = sp.splits(h if height is None else height)
        if not split and is_nhwc(x):
            return self._forward_nhwc(x)
        tokens = x.reshape(b, c, h * w)
        normed = _sp.group_norm(self.norm, tokens, sp) if split else self.norm(tokens)
        q, k, v = split_heads(self.qkv(normed), self.num_heads, self.new_order)
        if split:
            k, v = (t.contiguous() for t in _sp.gather_tokens(torch.stack([k, v]), sp,
                                                               3).unbind(0))
        a = ops.fused_qkv_attention(q, k, v).transpose(-1, -2).reshape(b, c, h * w)
        return (tokens + self.proj_out(a)).reshape(b, c, h, w)

    def _forward_nhwc(self, x):
        """The forward of a channels-last map: the norm, qkv and the
        projection on its ``[B, T, C]`` view (a view, not a transpose), the
        heads split from there; returns the map channels-last."""
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = split_heads_last(pointwise(self.qkv, self.norm.forward_tokens(tokens)),
                                   self.num_heads, self.new_order)
        a = ops.fused_qkv_attention(q, k, v).transpose(1, 2).reshape(b, h * w, c)
        out = tokens + pointwise(self.proj_out, a)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def _forward_tp(self, x):
        """The forward of a tensor-parallel module: with the legacy
        heads-major order and heads that divide by ``tp``, the rank's out
        block of the column-parallel qkv holds whole heads, and the
        attention runs on them (``[B, heads / tp, T, D]``); otherwise qkv is
        gathered and the attention runs whole."""
        g = self.tp.groups
        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w)
        normed = self.norm(tokens)
        qkv = self.qkv
        if (qkv.tp is not None and qkv.tp.kind == "col" and not self.new_order
                and self.num_heads % g.tp == 0):
            part, _ = _tp.dense(qkv, normed, False, True, 1, g)
            a, ab = qkv_attention(part, self.num_heads // g.tp, False), True
        else:
            whole, _ = _tp.dense(qkv, normed, False, False, 1, g)
            a, ab = qkv_attention(whole, self.num_heads, self.new_order), False
        out, _ = _tp.dense(self.proj_out, a, ab, False, 1, g)
        return (tokens + out).reshape(b, c, h, w)
