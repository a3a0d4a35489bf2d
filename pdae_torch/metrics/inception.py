"""InceptionV3 pool3 features for FID: the port of
``pdae_tpu/metrics/inception.py``, an ``nn.Module`` whose state-dict keys
are torchvision's, so that pytorch-fid's ``pt_inception-2015-12-05`` loads
with ``strict=True`` once its ``fc.*`` and ``AuxLogits.*`` are dropped.

The FID variant of the graph, as the JAX package computes it:

* ``BasicConv2d`` is a conv without bias, BatchNorm on the running
  statistics with eps 1e-3, ``(x - mean) * rsqrt(var + eps) * scale + bias``,
  then ReLU. Stride-1 convs pad SAME: ``(k // 2)`` on each side of each axis,
  so ``(0, 3)`` for a 1x7 and ``(3, 0)`` for a 7x1; the stride-2 convs and
  the stem's ``Conv2d_2a_3x3`` and ``Conv2d_4a_3x3`` are VALID.
* The pool branches of InceptionA, InceptionC and the first InceptionE take
  a 3x3 stride-1 average that counts only the pixels inside the image
  (``count_include_pad=False``); the second InceptionE's is a 3x3 stride-1
  max pool padded with -inf; the reduction pools are 3x3 stride-2 VALID.
* Input: uint8 NHWC, scaled to [0, 1], resized to 299x299, mapped to [-1, 1]
  in that order; output the spatial mean after Mixed_7c, ``[N, 2048]``.

The resize follows ``jax.image.resize(..., "bilinear")``, not pytorch-fid
(which never antialiases): half-pixel centres, and when it shrinks an axis a
triangle filter widened by the scale, its weights renormalised over the
pixels inside the image. That is ``F.interpolate(mode="bilinear",
align_corners=False)`` with ``antialias=True`` for an input above 299 px;
below, the two agree without it (torch clamps an index that falls off the
image where JAX renormalises a kernel that does, which picks the same edge
pixel), and ``antialias=False`` is used.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FID_SIZE = 299


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, same: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        padding = (kh // 2, kw // 2) if same else 0
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = self.conv(x)
        inv = torch.rsqrt(bn.running_var + bn.eps)
        x = (x - bn.running_mean[:, None, None]) * inv[:, None, None] * \
            bn.weight[:, None, None] + bn.bias[:, None, None]
        return F.relu(x)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool_3x3_same_no_pad(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same_no_pad(x))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, same=False)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, same=False)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same_no_pad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, same=False)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, same=False)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    """``pool`` "avg" is FIDInceptionE_1, "max" FIDInceptionE_2."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (_avg_pool_3x3_same_no_pad(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_to_fid(x: torch.Tensor) -> torch.Tensor:
    """NCHW float -> NCHW at 299x299, as ``jax.image.resize(..., "bilinear")``
    (module docstring)."""
    return F.interpolate(x, size=(FID_SIZE, FID_SIZE), mode="bilinear",
                         align_corners=False, antialias=max(x.shape[2:]) > FID_SIZE)


class InceptionV3(nn.Module):
    """uint8 NHWC images of any size -> ``[N, 2048]`` pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, same=False)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, same=False)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, same=False)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x_uint8_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_uint8_nhwc.permute(0, 3, 1, 2).float() / 255.0
        x = resize_to_fid(x) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def convert_inception_state_dict(sd: Mapping) -> dict:
    """A torchvision-keyed state dict -> the flat numpy file of ``pdae_tpu``
    (conv kernels to HWIO, BatchNorm buffers as they are); ``fc.*`` and
    ``AuxLogits.*``, unused for FID, are dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("fc.", "AuxLogits.")):
            continue
        v = _tensor(v).numpy()
        out[k] = v.transpose(2, 3, 1, 0) if k.endswith(".conv.weight") else v
    return out


def inception_state_dict(source) -> dict:
    """The module's state dict from ``source``: a torchvision-keyed state dict
    (``Mapping``, or a ``.pth``/``.pt`` file of one) as it is, or the flat
    file that ``python -m pdae_torch.convert --inception`` writes (conv
    kernels HWIO, transposed here to OIHW). ``fc.*`` and ``AuxLogits.*`` are
    dropped."""
    hwio = False
    if not isinstance(source, Mapping):
        path = os.fspath(source)
        if path.endswith((".pth", ".pt")):
            source = torch.load(path, map_location="cpu", weights_only=True)
        else:
            from ..utils import load_checkpoint
            source, hwio = load_checkpoint(path), True
    out = {}
    for k, v in source.items():
        if k.startswith(("fc.", "AuxLogits.")):
            continue
        v = _tensor(v)
        out[k] = v.permute(3, 2, 0, 1).contiguous() if hwio and k.endswith(".conv.weight") \
            else v
    return out


def load_inception(source, device=None) -> InceptionV3:
    """``InceptionV3`` with the weights of ``source``
    (``inception_state_dict``), loaded ``strict=True``, in eval mode on
    ``device`` (the card unless named)."""
    from .. import resolve_device
    model = InceptionV3()
    model.load_state_dict(inception_state_dict(source), strict=True)
    return model.to(resolve_device(device)).eval()


def load_inception_feature_fn(path: str, device=None):
    """``features(images_uint8_nhwc) -> [N, 2048]``, numpy in and out."""
    model = load_inception(path, device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def features(images_uint8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images_uint8)).to(dev)
        return model(x).cpu().numpy()

    return features
