"""The read side of ``pdae_tpu``'s per-process sharded checkpoints.

A sharded checkpoint is a directory: ``manifest.msgpack`` (each leaf's
``{shape, dtype}`` keyed by its ``/``-joined path, empty subtrees as
``{"empty": True}``, and the shard files of that save) and
``shard-<tag>-<i>-of-<n>.msgpack`` files, each ``{path: {"0": {"start": [...],
"data": array}, ...}}``. ``load_sharded_checkpoint`` assembles the full numpy
tree and checks that the shard files cover every element of every leaf, so a
missing or short shard file fails loudly.

Writing this layout needs several processes (the port's ``parallel`` item);
the port's trainers refuse ``checkpoint_format: sharded`` by name.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict

import numpy as np

from . import _msgpack

_SEP = "/"
_MANIFEST = "manifest.msgpack"


def _read(path: str):
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def _unflatten_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _MANIFEST))


def load_sharded_checkpoint(dir_path: str) -> Dict[str, Any]:
    """The full numpy tree of a checkpoint directory. Raises when a shard file
    the manifest lists is missing, or when the files cover fewer elements of a
    leaf than it has."""
    manifest = _read(os.path.join(dir_path, _MANIFEST))
    leaves, seen = {}, {}
    for path, desc in manifest["leaves"].items():
        if desc.get("empty"):
            leaves[path] = {}
            continue
        if desc["dtype"] == "bfloat16":
            raise TypeError(f"leaf {path!r} is bfloat16, which the port's "
                            "checkpoint codec does not read")
        leaves[path] = np.zeros(tuple(int(s) for s in desc["shape"]),
                                np.dtype(desc["dtype"]))
        seen[path] = set()
    listed = manifest.get("files", {})
    if listed:
        shard_files = [os.path.join(dir_path, f) for f in sorted(listed.values())]
        missing = [os.path.basename(f) for f in shard_files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(f"manifest lists shard files missing on disk: "
                                    f"{missing}")
    else:   # a directory from before the manifest listed its files
        shard_files = sorted(glob.glob(os.path.join(dir_path, "shard-*.msgpack")))
    if not shard_files:
        raise FileNotFoundError(f"no shard files in {dir_path}")
    for fname in shard_files:
        for path, pieces in _read(fname).items():
            if path not in leaves:
                raise ValueError(f"{fname} has leaf {path!r} not in the manifest")
            for piece in pieces.values():
                data = np.asarray(piece["data"])
                start = tuple(int(s) for s in piece["start"])
                idx = tuple(slice(st, st + sz) for st, sz in zip(start, data.shape))
                leaves[path][idx] = data
                seen[path].add((start, data.shape))
    for path, covered in seen.items():
        total = sum(int(np.prod(shp)) for _, shp in covered)
        if total != leaves[path].size:
            raise ValueError(f"leaf {path!r}: shard files cover {total} of "
                             f"{leaves[path].size} elements -- incomplete "
                             "checkpoint directory")
    return _unflatten_dict(leaves)
