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
  MLPSkipNet time_embed_0, _1       time_embed.0, time_embed.2
  MLPSkipNet layers_<i>/<sub>       layers.<i>.<sub> (linear_emb also as
                                    layers.<i>.cond_layers.1)
  classifier fc                     weight, bias

Weight layouts: conv [kh,kw,I,O] -> [O,I,kh,kw]; Dense [I,O] -> Linear
[O,I], or -> conv1d [O,I,1] for the attention qkv/proj_out; GroupNorm and
LayerNorm scale/bias -> weight/bias.

``unet_tree``/``encoder_tree``/``mlp_skip_net_tree``/``classifier_tree`` are
the inverse maps (for grads keyed like a state dict, and round trips);
``unet_tree``/``unet_state_dict`` map a whole ShiftUNet, trunk plus shift
branch, as a checkpoint's ``decoder`` holds it. ``train_state_tensors``/
``train_state_trees`` carry a whole representation-learning train state
(params, EMA, Adam moments and count) across, as numpy, so both packages can
step from the same state; ``optimizer_tree``/``optimizer_moments`` map Adam's
count and moments to and from a checkpoint's ``optimizer`` subtree in optax's
layout.
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
    out = {}
    for k, v in sd.items():
        v = np.ascontiguousarray(v)
        # arrays restored from a checkpoint are read-only views of its bytes
        out[k] = torch.from_numpy(v if v.flags.writeable else v.copy())
    return out


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


def mlp_skip_net_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax MLPSkipNet params -> ``MLPSkipNet`` state dict, each
    ``linear_emb`` under both of its reference keys."""
    sd: Dict = {}
    for mod, sub in tree.items():
        if mod in ("time_embed_0", "time_embed_1"):
            _put(sd, f"time_embed.{'0' if mod == 'time_embed_0' else '2'}", "linear", sub)
        elif mod.startswith("layers_"):
            i = mod[len("layers_"):]
            for name, leaves in sub.items():
                kind = "norm" if name == "norm" else "linear"
                _put(sd, f"layers.{i}.{name}", kind, leaves)
                if name == "linear_emb":
                    _put(sd, f"layers.{i}.cond_layers.1", kind, leaves)
        else:
            raise KeyError(f"unmapped flax module: {mod}")
    return _tensors(sd)


def classifier_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax LinearClassifier params (``{"fc": ...}``) -> ``LinearClassifier``
    state dict."""
    sd: Dict = {}
    for leaf, value in tree["fc"].items():
        name, v = _leaf("linear", leaf, value)
        sd[name] = v
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


def mlp_skip_net_tree(sd: Dict) -> Dict:
    """``MLPSkipNet`` state dict -> the flax param tree layout: the inverse of
    ``mlp_skip_net_state_dict``. The ``cond_layers.1`` keys are the
    ``linear_emb`` tensors again and must equal them."""
    tree: Dict = {}
    for key, value in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "time_embed":
            _put_back(tree, ({"0": "time_embed_0", "2": "time_embed_1"}[parts[1]],),
                      "linear", leaf, value)
        elif parts[0] == "layers" and parts[2:4] == ["cond_layers", "1"]:
            twin = f"layers.{parts[1]}.linear_emb.{leaf}"
            if not np.array_equal(_numpy(sd[twin]), _numpy(value)):
                raise ValueError(f"{key} differs from {twin}")
        elif parts[0] == "layers" and parts[2] in ("linear", "linear_emb", "norm"):
            _put_back(tree, (f"layers_{parts[1]}", parts[2]),
                      "norm" if parts[2] == "norm" else "linear", leaf, value)
        else:
            raise KeyError(f"unmapped state-dict key: {key}")
    return tree


def classifier_tree(sd: Dict) -> Dict:
    """``LinearClassifier`` state dict -> ``{"fc": {"kernel", "bias"}}``."""
    tree: Dict = {}
    for leaf, value in sd.items():
        _put_back(tree, ("fc",), "linear", leaf, value)
    return tree


# --------------------------------------------------------------------- #
# a whole train state, so both packages can step from the same point
# --------------------------------------------------------------------- #

def _groups_tensors(tree: Dict) -> Dict:
    """``{"encoder": flax tree, "shift": flax tree}`` -> the port's state dicts."""
    return {"encoder": encoder_state_dict(tree["encoder"]),
            "shift": unet_state_dict(tree["shift"])}


def _groups_trees(groups: Dict) -> Dict:
    """``{"encoder": state dict, "shift": state dict}`` -> flax trees."""
    return {"encoder": encoder_tree(groups["encoder"]),
            "shift": unet_tree(groups["shift"])}


def train_state_tensors(state: Dict) -> Dict:
    """A ``pdae_tpu`` representation-learning train state, given as numpy,
    in the port's layout.

    ``state``: ``{"step": int, "params": {"encoder": tree, "shift": tree},
    "ema_params": same}`` and, for Adam/AdamW, ``"mu"``/``"nu"`` (trees like
    ``params``, optax's ``ScaleByAdamState``) and ``"count"``. Every tree
    goes through the relayout of the weights (moments and EMA have the
    weights' shapes). The result feeds ``TrainState.load_converted``."""
    out = {"step": int(state["step"]), "params": _groups_tensors(state["params"]),
           "ema_params": _groups_tensors(state["ema_params"])}
    if "mu" in state:
        out.update(mu=_groups_tensors(state["mu"]), nu=_groups_tensors(state["nu"]),
                   count=int(state["count"]))
    return out


def train_state_trees(state) -> Dict:
    """The way back: a ``pdae_torch.training.TrainState`` as numpy trees in
    the flax layout, keyed as ``train_state_tensors`` takes them."""
    out = {"step": int(state.step), "params": _groups_trees(state.params),
           "ema_params": _groups_trees(state.ema_params)}
    moments = state.optimizer.state
    if moments:
        named = {g: {k: moments[p] for k, p in group.items()}
                 for g, group in state.masters.items()}
        out["mu"] = _groups_trees({g: {k: m["exp_avg"] for k, m in group.items()}
                                   for g, group in named.items()})
        out["nu"] = _groups_trees({g: {k: m["exp_avg_sq"] for k, m in group.items()}
                                   for g, group in named.items()})
        out["count"] = int(next(iter(moments.values()))["step"])
    return out


# --------------------------------------------------------------------- #
# the optimizer subtree of a checkpoint, in optax's layout
# --------------------------------------------------------------------- #

def _optax_layout(optimizer_config: dict, adam):
    """``flax.serialization.to_state_dict`` of the optax state that
    ``make_optimizer(optimizer_config)`` builds, with ``adam`` where its
    ``ScaleByAdamState`` sits and ``{}`` for each empty state:

    * Adam: ``chain(scale_by_adam, scale_by_learning_rate)`` ->
      ``{"0": adam, "1": {}}``;
    * Adam with ``weight_decay > 0``: ``chain(add_decayed_weights, adam)`` ->
      ``{"0": {}, "1": {"0": adam, "1": {}}}``;
    * AdamW: ``chain(scale_by_adam, add_decayed_weights,
      scale_by_learning_rate)`` -> ``{"0": adam, "1": {}, "2": {}}``.
    """
    name = optimizer_config.get("name", "Adam")
    if name == "AdamW":
        return {"0": adam, "1": {}, "2": {}}
    if name != "Adam":
        raise ValueError(f"optimizer_config.name must be 'Adam' or 'AdamW', got {name!r}")
    if float(optimizer_config.get("weight_decay", 0.0)) > 0:
        return {"0": {}, "1": {"0": adam, "1": {}}}
    return {"0": adam, "1": {}}


def optimizer_tree(optimizer_config: dict, count: int, mu: Dict, nu: Dict,
                   to_tree=_groups_trees) -> Dict:
    """The checkpoint's ``optimizer`` subtree in optax's layout from Adam's
    ``count`` and moments ``mu``/``nu``. By default these are keyed as
    ``trainable_params`` (``{"encoder": {name: tensor}, "shift": {...}}``);
    a stage that trains one module passes its state dict's moments and that
    module's ``*_tree`` map as ``to_tree``."""
    return _optax_layout(optimizer_config, {
        "count": np.asarray(int(count), np.int32), "mu": to_tree(mu), "nu": to_tree(nu)})


def optimizer_moments(optimizer_config: dict, tree: Dict,
                      to_tensors=_groups_tensors) -> Dict:
    """The inverse of ``optimizer_tree``: ``{"count": int, "mu": ..., "nu":
    ...}``, the moments mapped by ``to_tensors`` (by default to
    ``{"encoder": state dict, "shift": state dict}``). Raises when ``tree``
    is not the layout of ``optimizer_config``'s optimizer (an AdamW state
    given to an Adam run, a chain where none is configured)."""
    marker = "adam"

    def find(want, got, path):
        if want is marker:
            if isinstance(got, dict) and {"count", "mu", "nu"} <= set(got):
                return got
        elif isinstance(got, dict) and sorted(got) == sorted(want):
            found = [find(want[k], got[k], f"{path}/{k}") for k in want]
            return next((f for f in found if f is not None), None)
        raise ValueError(
            f"the checkpoint's optimizer state at '{path}' is not in the layout of "
            f"{optimizer_config.get('name', 'Adam')} with weight_decay "
            f"{optimizer_config.get('weight_decay', 0.0)}")

    adam = find(_optax_layout(optimizer_config, marker), tree, "optimizer")
    return {"count": int(np.asarray(adam["count"])), "mu": to_tensors(adam["mu"]),
            "nu": to_tensors(adam["nu"])}
