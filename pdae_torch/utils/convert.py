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

``unet_tree``/``encoder_tree`` are the inverse maps (for grads keyed like a
state dict, and round trips); ``train_state_tensors``/``train_state_trees``
carry a whole representation-learning train state (params, EMA, Adam
moments and count) across, as numpy, so both packages can step from the same
state.
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


# --------------------------------------------------------------------- #
# the way back: a state dict (or grads keyed like one) in the flax layout
# --------------------------------------------------------------------- #

_SUB_BACK = {torch_sub: (name, kind) for name, (torch_sub, kind) in _SUB.items()}
_HEADS_BACK = {torch_sub: (name, kind) for name, (torch_sub, kind) in _HEADS.items()}


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _leaf_back(kind: str, leaf: str, value) -> tuple:
    """The inverse of ``_leaf``: (flax leaf name, array in the flax layout)."""
    v = _numpy(value)
    if kind == "norm":
        return ("scale" if leaf == "weight" else "bias"), v
    if leaf == "bias":
        return "bias", v
    if kind == "conv2d":
        return "kernel", v.transpose(2, 3, 1, 0)
    if kind == "conv1d":
        return "kernel", v[:, :, 0].T
    if kind == "linear":
        return "kernel", v.T
    raise ValueError(kind)


def _put_back(tree: Dict, path: tuple, kind: str, leaf: str, value) -> None:
    name, v = _leaf_back(kind, leaf, value)
    node = tree
    for part in path:
        node = node.setdefault(part, {})
    node[name] = np.ascontiguousarray(v)


def unet_tree(sd: Dict) -> Dict:
    """``UNet``/``ShiftUNet`` state dict (or any subset of its keys, or grads
    keyed like it) -> the flax param tree layout: the inverse of
    ``unet_state_dict``."""
    tree: Dict = {}
    for key, value in sd.items():
        parts = key.split(".")
        top, leaf = parts[0], parts[-1]
        if top == "time_embed":
            _put_back(tree, (top, {"0": "dense_0", "2": "dense_1"}[parts[1]]),
                      "linear", leaf, value)
        elif top == "label_emb":
            if f"{top}.bias" in sd:
                _put_back(tree, (top,), "linear", leaf, value)
            else:
                tree.setdefault(top, {})["embedding"] = _numpy(value)
        elif key.startswith("input_blocks.0.0."):
            _put_back(tree, ("input_blocks_0_0",), "conv2d", leaf, value)
        elif ".".join(parts[:2]) in _HEADS_BACK:
            name, kind = _HEADS_BACK[".".join(parts[:2])]
            _put_back(tree, (name,), kind, leaf, value)
        else:
            depth = 2 if top in ("middle_block", "shift_middle_block") else 3
            sub = ".".join(parts[depth:-1])
            if top not in ("input_blocks", "output_blocks", "shift_output_blocks",
                           "middle_block", "shift_middle_block") or sub not in _SUB_BACK:
                raise KeyError(f"unmapped state-dict key: {key}")
            name, kind = _SUB_BACK[sub]
            _put_back(tree, ("_".join(parts[:depth]), name), kind, leaf, value)
    return tree


def encoder_tree(sd: Dict) -> Dict:
    """``SemanticEncoder`` state dict (or grads keyed like it) -> the flax
    param tree layout: the inverse of ``encoder_state_dict``. The whole key
    set is needed, since the Sequential indices are read in order."""
    indices = sorted({int(k.split(".")[1]) for k in sd})
    tree: Dict = {}
    stage = -1
    for idx in indices:
        prefix = f"encoder.{idx}."
        leaves = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if "qkv.weight" in leaves:
            for sub_leaf, value in leaves.items():
                sub, leaf = sub_leaf.rsplit(".", 1)
                name, kind = _SUB_BACK[sub]
                _put_back(tree, (f"attn_{stage}", name), kind, leaf, value)
        elif _numpy(leaves["weight"]).ndim == 4:
            stage += 1
            for leaf, value in leaves.items():
                _put_back(tree, (f"conv_{stage}",), "conv2d", leaf, value)
        elif _numpy(leaves["weight"]).ndim == 1:
            # the norm before conv i is norm_i; the one after the last conv
            # is final_norm, renamed below
            for leaf, value in leaves.items():
                _put_back(tree, (f"norm_{stage + 1}",), "norm", leaf, value)
        else:
            c = tree[f"norm_{stage + 1}"]["scale"].shape[0]
            tree["final_norm"] = tree.pop(f"norm_{stage + 1}")
            w = _numpy(leaves["weight"])                          # [out, C*H*W]
            side = math.isqrt(w.shape[1] // c)
            w = w.reshape(-1, c, side, side).transpose(0, 2, 3, 1)
            tree["final_dense"] = {
                "kernel": np.ascontiguousarray(w.reshape(w.shape[0], -1).T),
                "bias": _numpy(leaves["bias"])}
    return tree


# --------------------------------------------------------------------- #
# a whole train state, so both packages can step from the same point
# --------------------------------------------------------------------- #

def train_state_tensors(state: Dict) -> Dict:
    """A ``pdae_tpu`` representation-learning train state, given as numpy,
    in the port's layout.

    ``state``: ``{"step": int, "params": {"encoder": tree, "shift": tree},
    "ema_params": same}`` and, for Adam/AdamW, ``"mu"``/``"nu"`` (trees like
    ``params``, optax's ``ScaleByAdamState``) and ``"count"``. Every tree
    goes through the relayout of the weights (moments and EMA have the
    weights' shapes). The result feeds ``TrainState.load_converted``."""
    def relayout(tree):
        return {"encoder": encoder_state_dict(tree["encoder"]),
                "shift": unet_state_dict(tree["shift"])}

    out = {"step": int(state["step"]), "params": relayout(state["params"]),
           "ema_params": relayout(state["ema_params"])}
    if "mu" in state:
        out.update(mu=relayout(state["mu"]), nu=relayout(state["nu"]),
                   count=int(state["count"]))
    return out


def train_state_trees(state) -> Dict:
    """The way back: a ``pdae_torch.training.TrainState`` as numpy trees in
    the flax layout, keyed as ``train_state_tensors`` takes them."""
    def back(groups):
        return {"encoder": encoder_tree(groups["encoder"]),
                "shift": unet_tree(groups["shift"])}

    out = {"step": int(state.step), "params": back(state.params),
           "ema_params": back(state.ema_params)}
    moments = state.optimizer.state
    if moments:
        named = {g: {k: moments[p] for k, p in group.items()}
                 for g, group in state.params.items()}
        out["mu"] = back({g: {k: m["exp_avg"] for k, m in group.items()}
                          for g, group in named.items()})
        out["nu"] = back({g: {k: m["exp_avg_sq"] for k, m in group.items()}
                          for g, group in named.items()})
        out["count"] = int(next(iter(moments.values()))["step"])
    return out
