"""Single-file checkpoints in the byte layout of ``pdae_tpu/utils/checkpoint.py``.

A checkpoint is one msgpack'd nested dict with numpy leaves, written by the
port's own codec (``_msgpack.py``) with the bytes flax's
``msgpack_serialize`` gives the same tree, so each package reads the other's
files. The logical keys are the reference's (``step``, ``encoder``,
``ema_encoder``, ``decoder``, ``ema_decoder``, ``optimizer``,
``ema_denoise_fn``, ...), and the trees under them are in the flax layout;
``convert.py`` maps them to and from the port's state dicts.

Writes are atomic: a tmp file in the same directory, then a rename. Cadence
helpers name ``latest.ckpt`` and the ``save-{N}k.ckpt`` snapshots.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Iterable

import numpy as np
import torch

from . import _msgpack


def _atomic_write(path: str, pieces: Iterable) -> None:
    """Write ``pieces`` (bytes-like) to ``path`` through a tmp file and a
    rename, so a reader never sees a torn file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            for piece in pieces:
                f.write(piece)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _to_numpy_tree(tree):
    """Every leaf as a numpy array (tensors from the host), as the JAX
    package's ``np.asarray`` over the tree makes them: a numpy or Python
    scalar becomes a 0-d array. ``None`` stays."""
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return None if tree is None else np.asarray(tree)


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Atomically write a dict of trees (leaves: numpy, tensors, scalars)."""
    _atomic_write(path, _msgpack.pack_pieces(_to_numpy_tree(state)))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw nested dict (numpy leaves) of a single-file checkpoint, or of a
    sharded checkpoint directory (``sharded_checkpoint.py``)."""
    from .sharded_checkpoint import is_sharded_checkpoint, load_sharded_checkpoint
    if is_sharded_checkpoint(path):
        return load_sharded_checkpoint(path)
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def restore_into(template, raw, _path: str = ""):
    """``raw`` shaped onto ``template`` (a nested dict of arrays or tensors),
    as flax's ``from_state_dict`` then a leaf shape check: every key of the
    template must be in ``raw`` (keys only in ``raw`` are dropped), and every
    leaf must have the template's shape. Returns ``raw``'s leaves."""
    if isinstance(template, dict):
        if not isinstance(raw, dict):
            raise ValueError(f"checkpoint subtree at '{_path}' is a leaf but the "
                             "template expects a dict")
        missing = [k for k in template if k not in raw]
        if missing:
            raise ValueError(f"checkpoint lacks keys {missing} at '{_path}'")
        return {k: restore_into(v, raw[k], f"{_path}/{k}") for k, v in template.items()}
    if isinstance(raw, dict):
        raise ValueError(f"checkpoint subtree at '{_path}' is a dict but the "
                         "template expects a leaf")
    if tuple(np.shape(raw)) != tuple(template.shape if hasattr(template, "shape")
                                     else np.shape(template)):
        raise ValueError(f"checkpoint leaf shape mismatch at '{_path}': "
                         f"{np.shape(raw)} vs template {tuple(np.shape(template))}")
    return raw


def merge_partial(template_params, partial_params, _path=""):
    """strict=False-style partial restore: overwrite the subtrees of
    ``template_params`` present in ``partial_params``; keys absent from the
    template are dropped (torch ``strict=False`` drops unexpected keys) and a
    dict-vs-leaf mismatch raises instead of silently unioning."""
    if not isinstance(template_params, dict):
        if isinstance(partial_params, dict):
            raise ValueError(
                f"checkpoint subtree at '{_path}' is a dict but the model "
                f"expects a leaf (structural mismatch)")
        return partial_params
    if not isinstance(partial_params, dict):
        raise ValueError(
            f"checkpoint subtree at '{_path}' is a leaf but the model "
            f"expects a dict (structural mismatch)")
    out = dict(template_params)
    for k, v in partial_params.items():
        if k not in out:
            continue
        out[k] = merge_partial(out[k], v, f"{_path}/{k}")
    return out


def checkpoint_paths(run_path: str):
    ckpt_dir = os.path.join(run_path, "checkpoints")
    return ckpt_dir, os.path.join(ckpt_dir, "latest.ckpt")


def snapshot_path(run_path: str, step: int) -> str:
    return os.path.join(run_path, "checkpoints", f"save-{step // 1000}k.ckpt")
