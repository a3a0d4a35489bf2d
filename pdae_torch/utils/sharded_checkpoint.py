"""``pdae_tpu``'s per-process sharded checkpoints, both sides: the port's
counterpart of ``pdae_tpu/utils/sharded_checkpoint.py``.

A sharded checkpoint is a directory: ``manifest.msgpack`` (each leaf's
``{shape, dtype}`` keyed by its ``/``-joined path, empty subtrees as
``{"empty": True}``, the world size and the shard files of that save) and
``shard-<tag>-<i>-of-<n>.msgpack`` files, each ``{path: {"0": {"start": [...],
"data": array}, ...}}``: process i's pieces of the leaves, each a block of the
leaf in the flax layout starting at ``start``.

* **Write.** Every process writes the pieces it owns (``write_shard_file``):
  its slices of the leaves FSDP splits (``training/fsdp.py``) and, on process
  0 alone, every leaf that is whole on every process, as JAX's replica 0
  writes them. The primary writes the manifest last (``write_manifest``),
  after every shard file is on disk, and then deletes the shard files no
  manifest lists (``cleanup_stale_shards``). Shard files carry the save's
  tag (a trainer's step), so an in-place re-save keeps the old manifest and
  its files until the new manifest replaces it atomically. The bytes are
  those that ``pdae_tpu`` writes for the same pieces (``utils/_msgpack.py``).
* **Read.** ``load_sharded_checkpoint`` assembles the full numpy tree and
  checks that the shard files cover every element of every leaf, so a
  missing or short shard file fails loudly. A directory of any world size
  reads in any process.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List

import numpy as np

from . import _msgpack
from .checkpoint import _atomic_write

_SEP = "/"
_MANIFEST = "manifest.msgpack"


def _read(path: str):
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def flatten_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"/"-joined path: leaf}`` of a nested dict, empty subtrees kept as
    ``{}`` (optax's empty states)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            if v:
                out.update(flatten_dict(v, key))
            else:
                out[key] = {}
        else:
            out[key] = v
    return out


def _unflatten_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def shard_filename(process_index: int, process_count: int, tag: str = "0") -> str:
    """The shard file of ``process_index`` of a save tagged ``tag``."""
    return f"shard-{tag}-{process_index:05d}-of-{process_count:05d}.msgpack"


def write_shard_file(dir_path: str, pieces: Dict[str, List], tag: str,
                     process_index: int, process_count: int) -> str:
    """Atomically write ``pieces`` (``{path: [{"start", "data"}, ...]}``) as
    the shard file of ``process_index``; returns its path."""
    path = os.path.join(dir_path, shard_filename(process_index, process_count, tag))
    payload = {p: {str(i): {"start": [int(s) for s in piece["start"]],
                            "data": np.asarray(piece["data"])}
                   for i, piece in enumerate(ps)}
               for p, ps in pieces.items() if ps}
    _atomic_write(path, _msgpack.pack_pieces(payload))
    return path


def manifest_skeleton(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's ``{shape, dtype}`` (an empty subtree's ``{"empty":
    True}``), keyed by path. A leaf needs only ``shape`` and ``dtype``."""
    return {p: ({"empty": True} if isinstance(leaf, dict)
                else {"shape": [int(s) for s in np.shape(leaf)],
                      "dtype": str(leaf.dtype if hasattr(leaf, "dtype")
                                   else np.asarray(leaf).dtype)})
            for p, leaf in flatten_dict(tree).items()}


def write_manifest(dir_path: str, skeleton: Dict[str, Any], tag: str,
                   process_count: int) -> str:
    """Write the manifest of the save tagged ``tag`` over ``process_count``
    processes: ``skeleton`` and the save's exact shard files, so the reader
    ignores files of other saves. The primary alone calls it, after every
    shard file is on disk."""
    files = {str(i): shard_filename(i, process_count, tag) for i in range(process_count)}
    path = os.path.join(dir_path, _MANIFEST)
    _atomic_write(path, _msgpack.pack_pieces(
        {"world": int(process_count), "files": files, "leaves": skeleton}))
    return path


def cleanup_stale_shards(dir_path: str) -> None:
    """Delete the shard files the manifest does not list (an earlier save's,
    or another world size's). Safe once the manifest is on disk; one process
    calls it."""
    keep = set(_read(os.path.join(dir_path, _MANIFEST)).get("files", {}).values())
    if not keep:        # a manifest from before the file list: keep all
        return
    for fname in glob.glob(os.path.join(dir_path, "shard-*.msgpack")):
        if os.path.basename(fname) not in keep:
            try:
                os.unlink(fname)
            except FileNotFoundError:
                pass


def save_sharded_checkpoint(dir_path: str, tree: Dict[str, Any], tag: str = "0") -> None:
    """``tree`` as the sharded directory of one process: every leaf whole in
    its shard file, then the manifest, then stale shard files removed."""
    os.makedirs(dir_path, exist_ok=True)
    pieces = {p: [{"start": [0] * np.ndim(leaf), "data": np.asarray(leaf)}]
              for p, leaf in flatten_dict(tree).items() if not isinstance(leaf, dict)}
    write_shard_file(dir_path, pieces, tag, 0, 1)
    write_manifest(dir_path, manifest_skeleton(tree), tag, 1)
    cleanup_stale_shards(dir_path)


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
