"""Pack an image folder into an LMDB environment that the port's datasets (and
the JAX package's, and the reference's loaders) read: the port's counterpart
of ``scripts/prepare_lmdb.py``, with its flags, defaults and key formats, and
a byte-equal ``data.mdb`` for the same folder.

    python -m pdae_torch.prepare_lmdb IMAGE_DIR OUT_LMDB_DIR \\
        --key-format '256-%05d' [--size 256] [--quality 95] [--limit N]

Key formats by dataset: CELEBA64 'None-%07d', FFHQ/CELEBAHQ '256-%05d',
HORSE/BEDROOM '256-%07d'. Each image (sorted by file name) is converted to
RGB, optionally resized so its shorter side is ``--size`` (Lanczos), and
stored as a JPEG of ``--quality``, one at a time: the writer streams pages to
disk, so memory stays at about one image whatever the folder's size.
"""

from __future__ import annotations

import argparse
import io
import os

EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("image_dir")
    p.add_argument("out_dir")
    p.add_argument("--key-format", default="256-%05d")
    p.add_argument("--size", type=int, default=None,
                   help="optionally resize (shorter side) before packing")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)

    from PIL import Image

    from .data import write_lmdb_stream

    files = sorted(os.path.join(args.image_dir, f) for f in os.listdir(args.image_dir)
                   if os.path.splitext(f)[1].lower() in EXTENSIONS)
    if args.limit:
        files = files[:args.limit]
    if not files:
        raise SystemExit(f"no images found in {args.image_dir}")

    def encoded():
        # the zero-padded key formats come out sorted, as the writer requires
        for i, path in enumerate(files):
            img = Image.open(path).convert("RGB")
            if args.size:
                w, h = img.size
                s = args.size / min(w, h)
                img = img.resize((round(w * s), round(h * s)), Image.LANCZOS)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=args.quality)
            yield (args.key_format % i).encode(), buf.getvalue()
            if (i + 1) % 1000 == 0:
                print(f"{i + 1}/{len(files)}", flush=True)

    out = write_lmdb_stream(args.out_dir, encoded())
    print(f"packed {len(files)} images -> {out}")


if __name__ == "__main__":
    main()
