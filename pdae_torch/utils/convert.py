"""Carry weights from a ``pdae_tpu`` flax param tree into the port's modules.

The port's own copy of the flax -> reference-torch maps (the JAX package's
``utils/torch_convert.py::export_*_state_dict``): the result loads into
``pdae_torch.models`` with ``load_state_dict(strict=True)``.

  flax (pdae_tpu)                   torch (reference layout, this port)
  ---------------------------------------------------------------------
  time_embed/dense_0, dense_1       time_embed.0, time_embed.2
  label_emb (Dense | Embed)         label_emb (Linear | Embedding)
  input_blocks_0_0                  input_blocks.0.0 (stem conv)
  <group>_I_J/<sub>                 <group>.I.J.<sub'>
  <group>_J/<sub>                   <group>.J.<sub'>  (middle blocks)
  out_norm, out_conv                out.0, out.2 (and shift_out.*)
  encoder <name>                    encoder.<Sequential index>

Weight layouts: conv [kh,kw,I,O] -> [O,I,kh,kw]; Dense [I,O] -> Linear
[O,I], or -> conv1d [O,I,1] for the attention qkv/proj_out; GroupNorm
scale/bias -> weight/bias.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

_SUB = {
    "in_norm": ("in_layers.0", "norm"),
    "in_conv": ("in_layers.2", "conv2d"),
    "emb_dense": ("emb_layers.1", "linear"),
    "emb_z_dense": ("emb_z_layers.1", "linear"),
    "out_norm": ("out_layers.0", "norm"),
    "out_conv": ("out_layers.3", "conv2d"),
    "skip_conv": ("skip_connection", "conv2d"),
    "norm": ("norm", "norm"),
    "qkv": ("qkv", "conv1d"),
    "proj_out": ("proj_out", "conv1d"),
}

_BLOCK = re.compile(r"^(input_blocks|output_blocks|shift_output_blocks)_(\d+)_(\d+)$")
_MIDDLE = re.compile(r"^(middle_block|shift_middle_block)_(\d+)$")
_HEADS = {"out_norm": ("out.0", "norm"), "out_conv": ("out.2", "conv2d"),
          "shift_out_norm": ("shift_out.0", "norm"),
          "shift_out_conv": ("shift_out.2", "conv2d")}


def _leaf(kind: str, leaf: str, value) -> tuple:
    v = np.asarray(value)
    if kind == "norm":
        return ("weight" if leaf == "scale" else "bias"), v
    if leaf == "bias":
        return "bias", v
    if leaf != "kernel":
        raise KeyError(f"unexpected leaf {leaf!r} in a {kind} layer")
    if kind == "conv2d":
        return "weight", v.transpose(3, 2, 0, 1)
    if kind == "conv1d":
        return "weight", v.T[:, :, None]
    if kind == "linear":
        return "weight", v.T
    raise ValueError(kind)


def _put(sd: Dict, prefix: str, kind: str, leaves: Dict) -> None:
    for leaf, value in leaves.items():
        name, v = _leaf(kind, leaf, value)
        sd[f"{prefix}.{name}"] = v


def _tensors(sd: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def unet_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax UNet/ShiftUNet params -> ``UNet``/``ShiftUNet`` state dict."""
    sd: Dict = {}
    for mod, sub in tree.items():
        if mod == "time_embed":
            _put(sd, "time_embed.0", "linear", sub["dense_0"])
            _put(sd, "time_embed.2", "linear", sub["dense_1"])
        elif mod == "label_emb":
            if "embedding" in sub:
                sd["label_emb.weight"] = np.asarray(sub["embedding"])
            else:
                _put(sd, "label_emb", "linear", sub)
        elif mod == "input_blocks_0_0":
            _put(sd, "input_blocks.0.0", "conv2d", sub)
        elif mod in _HEADS:
            _put(sd, *_HEADS[mod], sub)
        else:
            m = _BLOCK.match(mod) or _MIDDLE.match(mod)
            if m is None:
                raise KeyError(f"unmapped flax module: {mod}")
            prefix = ".".join(m.groups())
            for name, leaves in sub.items():
                torch_sub, kind = _SUB[name]
                _put(sd, f"{prefix}.{torch_sub}", kind, leaves)
    return _tensors(sd)


def encoder_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax SemanticEncoder params -> ``SemanticEncoder`` state dict.

    The Sequential indices follow the build order (conv, then GN and SiLU
    before every later conv, attention after its stage, final GN, SiLU,
    flatten, Linear). The final Linear's input runs over an NHWC flatten in
    flax and an NCHW one here; its permutation is read off the tree's shapes.
    """
    stages = sum(1 for k in tree if re.fullmatch(r"conv_\d+", k))
    sd: Dict = {}
    idx = 0
    for i in range(stages):
        if i > 0:
            _put(sd, f"encoder.{idx}", "norm", tree[f"norm_{i}"])
            idx += 2
        _put(sd, f"encoder.{idx}", "conv2d", tree[f"conv_{i}"])
        idx += 1
        if f"attn_{i}" in tree:
            for name, leaves in tree[f"attn_{i}"].items():
                torch_sub, kind = _SUB[name]
                _put(sd, f"encoder.{idx}.{torch_sub}", kind, leaves)
            idx += 1
    _put(sd, f"encoder.{idx}", "norm", tree["final_norm"])
    idx += 3
    kernel = np.asarray(tree["final_dense"]["kernel"])      # [H*W*C, out]
    c = np.asarray(tree["final_norm"]["scale"]).shape[0]
    side = math.isqrt(kernel.shape[0] // c)
    if side * side * c != kernel.shape[0]:
        raise ValueError(f"final_dense input {kernel.shape[0]} is not a square "
                         f"map of {c} channels")
    w = kernel.T.reshape(-1, side, side, c).transpose(0, 3, 1, 2)
    sd[f"encoder.{idx}.weight"] = w.reshape(w.shape[0], -1)
    sd[f"encoder.{idx}.bias"] = np.asarray(tree["final_dense"]["bias"])
    return _tensors(sd)
