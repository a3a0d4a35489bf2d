"""LPIPS with the AlexNet backbone: the port of ``pdae_tpu/metrics/lpips.py``,
an ``nn.Module`` with the ``lpips`` package's state-dict keys
(``net.slice{1..5}.<idx>.{weight,bias}`` for the five convs at torchvision's
``features`` indices 0, 3, 6, 8, 10; ``lin{0..4}.model.1.weight`` as
``[1, C, 1, 1]``).

The distance of two [-1, 1] images: each is shifted and scaled by the fixed
LPIPS buffers, then the AlexNet convs (64, 192, 384, 256, 256 channels) give
a feature map after each ReLU, before any pool (a 3x3 stride-2 VALID max
pool follows the first two stages only); each map is normalised over its
channels, ``f / (sqrt(sum f^2) + 1e-10)``, and the squared difference of the
two is weighted by the stage's ``lin`` weights, summed over channels,
averaged over space, and summed over the five stages.

Weights: the pretrained AlexNet and the lpips package's ``alex.pth`` are not
in the repository; ``load_lpips`` reads the flat file that
``python -m pdae_torch.convert --lpips`` writes (what
``lpips_weights`` names), or torch state dicts keyed as the lpips package or
torchvision's AlexNet keys them.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .base import BaseMetric

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, pad) of each AlexNet conv
ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
CHANNELS = [c for c, _, _, _ in ALEX]
# torchvision ``features`` index of each conv -> its stage
_LPIPS_CONV_IDX = {"0": 0, "3": 1, "6": 2, "8": 3, "10": 4}
_CONV_KEY = {stage: f"net.slice{stage + 1}.{idx}" for idx, stage in _LPIPS_CONV_IDX.items()}


def _stage(i: int, cin: int) -> nn.Sequential:
    """The lpips package's ``slice{i+1}``: the pool that ends the previous
    stage (after stages 0 and 1), the conv, its ReLU, at torchvision's
    indices."""
    idx = int(_CONV_KEY[i].rsplit(".", 1)[1])
    cout, k, s, p = ALEX[i]
    layers = [(str(idx - 1), nn.MaxPool2d(3, 2))] if i in (1, 2) else []
    layers += [(str(idx), nn.Conv2d(cin, cout, k, s, p)), (str(idx + 1), nn.ReLU())]
    return nn.Sequential(OrderedDict(layers))


class _AlexFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, (cout, _, _, _) in enumerate(ALEX):
            setattr(self, f"slice{i + 1}", _stage(i, cin))
            cin = cout

    def forward(self, x):
        feats = []
        for i in range(len(ALEX)):
            x = getattr(self, f"slice{i + 1}")(x)
            feats.append(x)
        return feats


class _Lin(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(OrderedDict([("0", nn.Identity()),
                                                ("1", nn.Conv2d(c, 1, 1, bias=False))]))


def _unit_normalize(f, eps: float = 1e-10):
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``forward(img1, img2)``: NCHW in [-1, 1] -> per-image LPIPS ``[N]``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)
        self.net = _AlexFeatures()
        for i, c in enumerate(CHANNELS):
            setattr(self, f"lin{i}", _Lin(c))

    def forward(self, img1, img2):
        f1 = self.net((img1 - self.shift) / self.scale)
        f2 = self.net((img2 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.view(1, -1, 1, 1)
            total = total + torch.sum(d * w, dim=1).mean(dim=(1, 2))
        return total


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def convert_lpips_state_dict(sd: Mapping) -> dict:
    """A torch state dict keyed as the lpips package keys it
    (``net.sliceK.<idx>``, ``linK.model.1.weight``), or as torchvision's
    AlexNet does (``features.<idx>``), to the module's keys; the scaling
    layer's buffers (fixed here) and every other key are dropped."""
    out = {}
    for key, value in sd.items():
        if key.startswith("lin") and key.endswith(".model.1.weight"):
            out[key] = _tensor(value)
            continue
        parts = key.split(".")
        idx = (parts[2] if key.startswith("net.slice") else
               parts[1] if key.startswith("features.") else None)
        if idx in _LPIPS_CONV_IDX:
            out[f"{_CONV_KEY[_LPIPS_CONV_IDX[idx]]}.{parts[-1]}"] = _tensor(value)
    return out


def _from_flat(raw: Mapping) -> dict:
    """The flat file of ``pdae_tpu`` (``conv{i}_w`` HWIO, ``conv{i}_b``,
    ``lin{i}_w`` ``[C]``) to the module's keys."""
    out = {}
    for i, c in enumerate(CHANNELS):
        out[f"{_CONV_KEY[i]}.weight"] = _tensor(raw[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous()
        out[f"{_CONV_KEY[i]}.bias"] = _tensor(raw[f"conv{i}_b"])
        out[f"lin{i}.model.1.weight"] = _tensor(raw[f"lin{i}_w"]).reshape(1, c, 1, 1)
    return out


def flat_lpips_state_dict(sd: Mapping) -> dict:
    """A torch state dict as ``convert_lpips_state_dict`` takes it -> the flat
    numpy file of ``pdae_tpu`` (``conv{i}_w`` HWIO, ``conv{i}_b``,
    ``lin{i}_w`` ``[C]``; the inverse of ``_from_flat``), with the entries the
    state dict has: torchvision's AlexNet gives no ``lin{i}_w``."""
    module = convert_lpips_state_dict(sd)
    out = {}
    for i in range(len(CHANNELS)):
        for name, key, layout in ((f"conv{i}_w", f"{_CONV_KEY[i]}.weight", (2, 3, 1, 0)),
                                  (f"conv{i}_b", f"{_CONV_KEY[i]}.bias", None),
                                  (f"lin{i}_w", f"lin{i}.model.1.weight", -1)):
            if key in module:
                v = module[key].numpy()
                out[name] = (v.reshape(-1) if layout == -1 else
                             v.transpose(*layout) if layout else v)
    return out


def lpips_state_dict(*sources) -> dict:
    """The module's state dict, merged from ``sources`` in order: the flat
    file that ``lpips_weights`` names (a path), a ``.pth``/``.pt`` file of a
    torch state dict, or a torch state dict (``convert_lpips_state_dict``).
    torchvision's AlexNet has no ``lin`` weights: merge it with the lpips
    package's ``alex.pth``."""
    out = {}
    for source in sources:
        if not isinstance(source, Mapping):
            path = os.fspath(source)
            if not path.endswith((".pth", ".pt")):
                from ..utils import load_checkpoint
                out.update(_from_flat(load_checkpoint(path)))
                continue
            source = torch.load(path, map_location="cpu", weights_only=True)
        out.update(convert_lpips_state_dict(source))
    return out


def load_lpips(*sources, device=None) -> LPIPS:
    """``LPIPS`` with the weights of ``sources`` (``lpips_state_dict``),
    loaded ``strict=True``, in eval mode on ``device`` (the card unless
    named)."""
    from .. import resolve_device
    model = LPIPS()
    model.load_state_dict(lpips_state_dict(*sources), strict=True)
    return model.to(resolve_device(device)).eval()


class LPIPSMetric(BaseMetric):
    """Per-image LPIPS of pairs in [0, 1], accumulated (the reference's
    ``lpips.LPIPS(net="alex")`` fed [-1, 1])."""

    def __init__(self, weights_path: str, device=None):
        super().__init__()
        self.model = load_lpips(weights_path, device=device)

    @torch.inference_mode()
    def process(self, images: torch.Tensor, gts: torch.Tensor):
        """images/gts: fp32 [N,C,H,W] in [0, 1], on the metric's device."""
        vals = self.model(images * 2.0 - 1.0, gts * 2.0 - 1.0)
        self.results.extend(float(v) for v in vals.cpu())


def lpips_distance(model: LPIPS, img1, img2) -> torch.Tensor:
    """Per-image LPIPS of NCHW [-1, 1] batches (``pdae_tpu``'s
    ``lpips_distance`` takes the params; here the loaded module)."""
    return model(img1, img2)
