"""Inspect and convert checkpoints: the port's counterpart of
``scripts/ckpt_tool.py``, over ``utils/checkpoint.py`` and
``utils/sharded_checkpoint.py``.

    python -m pdae_torch.ckpt_tool info run/checkpoints/latest.ckpt
    python -m pdae_torch.ckpt_tool to-full latest.sharded latest.ckpt
    python -m pdae_torch.ckpt_tool to-sharded latest.ckpt latest.sharded

``info`` prints the format (a single msgpack file, or a sharded directory of
a multi-process run), the step, and for each top-level key (``ema_denoise_fn``,
``ema_encoder``, ...) its leaves, parameters, megabytes and dtypes. ``to-full``
turns a sharded directory into a single file, byte-equal to the JAX tool's,
that any consumer (``python -m pdae_torch.convert --export``) reads without
knowing the sharded layout. ``to-sharded`` splits a file into a sharded
directory of one process (the manifest and ``shard-0-00000-of-00001.msgpack``),
byte-equal to the JAX tool's, for runs that resume under
``checkpoint_format: sharded`` (a resume reads either form).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _leaf_iter(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_iter(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def info(path: str) -> None:
    from .utils import is_sharded_checkpoint, load_checkpoint
    raw = load_checkpoint(path)
    fmt = "sharded" if is_sharded_checkpoint(path) else "full"
    print(f"format: {fmt}")
    if fmt == "sharded":
        files = sorted(glob.glob(os.path.join(path, "shard-*.msgpack")))
        print(f"shard files: {len(files)}")
    step = raw.get("step")
    if step is not None and np.ndim(step) == 0:
        print(f"step: {int(step)}")
    print("keys:")
    for key, sub in raw.items():
        if key == "step":
            continue
        leaves = list(_leaf_iter(sub))
        arrs = [np.asarray(leaf) for _, leaf in leaves if hasattr(leaf, "size")]
        n_params = sum(int(a.size) for a in arrs)
        n_bytes = sum(a.nbytes for a in arrs)
        dtypes = sorted({str(a.dtype) for a in arrs})
        print(f"  {key}: {len(leaves)} leaves, {n_params:,} params, "
              f"{n_bytes / 1e6:.1f} MB, dtypes={','.join(dtypes) or '-'}")


def to_full(src: str, dst: str) -> None:
    from .utils import is_sharded_checkpoint, load_checkpoint, save_checkpoint
    if not is_sharded_checkpoint(src):
        raise SystemExit(f"{src} is not a sharded checkpoint directory")
    save_checkpoint(dst, load_checkpoint(src))
    print(f"wrote {dst}")


def to_sharded(src: str, dst: str) -> None:
    from .utils import load_checkpoint, save_sharded_checkpoint
    if os.path.isdir(src):
        raise SystemExit(f"{src} is already a directory")
    save_sharded_checkpoint(dst, load_checkpoint(src))
    print(f"wrote {dst}/")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="print structure/format of a ckpt")
    pi.add_argument("path")
    pf = sub.add_parser("to-full", help="sharded dir -> single file")
    pf.add_argument("src")
    pf.add_argument("dst")
    ps = sub.add_parser("to-sharded", help="single file -> sharded dir")
    ps.add_argument("src")
    ps.add_argument("dst")
    args = p.parse_args(argv)
    if args.cmd == "info":
        info(args.path)
    elif args.cmd == "to-full":
        to_full(args.src, args.dst)
    else:
        to_sharded(args.src, args.dst)


if __name__ == "__main__":
    main()
