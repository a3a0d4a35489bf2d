"""Datasets: the LMDB image corpora and a synthetic corpus, the port's copy of
``pdae_tpu/data/datasets.py``.

The same key formats, split offsets, crops, resize, hflip augmentation,
[-1,1] normalisation and per-sample dicts (``x_0`` float32, ``gt`` uint8,
NHWC) as the JAX package, so both give the same batches bit for bit:

  * CELEBA64: keys ``None-%07d``; crop(top=57,left=25,128x128) then resize;
    splits train/valid/test = 162770/19867/19963
  * FFHQ: keys ``256-%05d``, 70000 images
  * CELEBAHQ: keys ``256-%05d``, 30000 images + 40-attribute annotations
    parsed from ``CelebAMask-HQ-attribute-anno.txt``
  * HORSE / BEDROOM: keys ``256-%07d``, 2000340 / 3033042 images
  * MNIST: raw idx files (torchvision's layout), a one-hot condition at
    collate
  * SYNTHETIC: deterministic procedural images for tests and smoke runs

Images decode through PIL, imported when the first image is read (the JAX
package's path when its native decoder is absent; that decoder is not
ported). ``transfer_uint8: true`` keeps ``x_0`` as the raw uint8 pixels, 4x
fewer bytes to move to the device, where ``utils.image.x0_from_transfer``
normalises them bit-equal to the host's float path.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import threading
from typing import Dict, Optional

import numpy as np

from .labels import CELEBAHQ_ID_TO_LABEL, CELEBAHQ_LABEL_TO_ID
from .lmdb_store import Reader, open_lmdb


def _resize_pil(img, size: int):
    from PIL import Image
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return img


def _finalize(img, rng: Optional[np.random.Generator], augmentation: bool,
              as_uint8: bool = False):
    """PIL image -> (x_0 float32 [-1,1] HWC, gt uint8 HWC) with optional
    random hflip. gt rounding matches the reference's
    ``mul(255).add(0.5).clamp``. ``as_uint8`` (``transfer_uint8``) gives
    x_0 as the raw pixels, which equal gt."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if augmentation and rng is not None and rng.random() < 0.5:
        arr = arr[:, ::-1, :]
    if as_uint8:
        return np.ascontiguousarray(arr), np.ascontiguousarray(arr)
    x01 = arr.astype(np.float32) / 255.0
    x_0 = x01 * 2.0 - 1.0
    gt = np.clip(np.floor(x01 * 255.0 + 0.5), 0, 255).astype(np.uint8)
    return x_0, gt


class LMDBImageDataset:
    """Shared LMDB image dataset machinery."""

    key_fmt = "256-%05d"
    length = 0
    crop = None  # (top, left, h, w)

    def __init__(self, config: dict):
        self.config = config
        self.data_path = config["data_path"]
        self.image_size = int(config["image_size"])
        self.image_channel = int(config.get("image_channel", 3))
        self.augmentation = bool(config.get("augmentation", False))
        self.transfer_uint8 = bool(config.get("transfer_uint8", False))
        self._reader: Optional[Reader] = None
        self._reader_lock = threading.Lock()

    def _txn(self) -> Reader:
        # one shared open for the loader's worker threads (readers are
        # stateless mmaps, safe to share)
        if self._reader is None:
            with self._reader_lock:
                if self._reader is None:
                    self._reader = open_lmdb(self.data_path)
        return self._reader

    def __len__(self) -> int:
        return self.length

    def _index_key(self, index: int) -> bytes:
        return (self.key_fmt % index).encode("utf-8")

    def _load_image(self, index: int):
        from PIL import Image
        img_bytes = self._txn().get(self._index_key(index))
        if img_bytes is None:
            raise KeyError(f"missing LMDB key {self._index_key(index)!r}")
        img = Image.open(io.BytesIO(img_bytes))
        img = img.convert("RGB" if self.image_channel == 3 else "L")
        if self.crop is not None:
            top, left, h, w = self.crop
            img = img.crop((left, top, left + w, top + h))
        return _resize_pil(img, self.image_size)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        x_0, gt = _finalize(self._load_image(index), rng, self.augmentation,
                            self.transfer_uint8)
        return {"idx": index, "x_0": x_0, "gt": gt}

    @staticmethod
    def collate_fn(batch) -> Dict[str, np.ndarray]:
        return {
            "idx": np.asarray([b["idx"] for b in batch], np.int32),
            "x_0": np.stack([b["x_0"] for b in batch]),
            "gts": np.stack([b["gt"] for b in batch]),
        }


class CELEBA64(LMDBImageDataset):
    key_fmt = "None-%07d"
    crop = (57, 25, 128, 128)
    SPLITS = {"train": (0, 162770), "valid": (162770, 19867),
              "test": (182637, 19963)}

    def __init__(self, config):
        super().__init__(config)
        self.split = config.get("split", "train")
        if self.split not in self.SPLITS:
            raise NotImplementedError(self.split)
        self._offset, self.length = self.SPLITS[self.split]

    def _index_key(self, index: int) -> bytes:
        return (self.key_fmt % (self._offset + index)).encode("utf-8")


class FFHQ(LMDBImageDataset):
    key_fmt = "256-%05d"
    length = 70000


class CELEBAHQ(LMDBImageDataset):
    key_fmt = "256-%05d"
    length = 30000

    ID_TO_LABEL = list(CELEBAHQ_ID_TO_LABEL)
    LABEL_TO_ID = CELEBAHQ_LABEL_TO_ID

    def __init__(self, config):
        super().__init__(config)
        anno = os.path.join(self.data_path, "CelebAMask-HQ-attribute-anno.txt")
        self._labels = None
        if os.path.exists(anno):
            self._labels = self._parse_annotations(anno)
        elif config.get("require_annotations", True):
            # training a classifier on silent zero labels would "work"
            raise FileNotFoundError(
                f"{anno} not found; set require_annotations: false to load "
                f"images without attribute labels")

    @staticmethod
    def _parse_annotations(path: str) -> np.ndarray:
        """Parse the 40-attribute +1/-1 table."""
        with open(path) as f:
            f.readline()                 # count line
            f.readline()                 # header line
            rows = []
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                rows.append([int(v) for v in parts[1:41]])
        return np.asarray(rows, np.int32)

    def __getitem__(self, index, rng=None):
        out = super().__getitem__(index, rng)
        if self._labels is not None:
            out["label"] = self._labels[index]
        else:
            out["label"] = np.zeros((40,), np.int32)
        return out

    @staticmethod
    def collate_fn(batch):
        out = LMDBImageDataset.collate_fn(batch)
        out["label"] = np.stack([b["label"] for b in batch])
        return out


class HORSE(LMDBImageDataset):
    key_fmt = "256-%07d"
    length = 2000340


class BEDROOM(LMDBImageDataset):
    key_fmt = "256-%07d"
    length = 3033042


class MNIST:
    """MNIST from raw idx files: ``{train,t10k}-{images-idx3,labels-idx1}-ubyte``,
    plain or ``.gz``, under ``data_path`` or ``data_path/MNIST/raw``. Resized
    bilinearly to ``image_size``; collate adds a one-hot condition beside the
    class ids."""

    def __init__(self, config):
        self.config = config
        self.image_size = int(config["image_size"])
        self.train = bool(config.get("train", True))
        self.transfer_uint8 = bool(config.get("transfer_uint8", False))
        prefix = "train" if self.train else "t10k"
        self.images, self.labels = self._load_idx(config["data_path"], prefix)

    @staticmethod
    def _open_maybe_gz(path):
        if os.path.exists(path):
            return open(path, "rb")
        if os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rb")
        return None

    @classmethod
    def _load_idx(cls, base: str, prefix: str):
        for root in (base, os.path.join(base, "MNIST", "raw")):
            fi = cls._open_maybe_gz(os.path.join(root, f"{prefix}-images-idx3-ubyte"))
            fl = cls._open_maybe_gz(os.path.join(root, f"{prefix}-labels-idx1-ubyte"))
            if fi is None or fl is None:
                for f in (fi, fl):
                    if f is not None:
                        f.close()
                continue
            with fi, fl:
                magic, n, rows, cols = struct.unpack(">IIII", fi.read(16))
                if magic != 2051:
                    raise ValueError(f"{prefix} images: idx magic {magic}, not 2051")
                images = np.frombuffer(fi.read(n * rows * cols), np.uint8).reshape(
                    n, rows, cols)
                magic, n_labels = struct.unpack(">II", fl.read(8))
                if magic != 2049:
                    raise ValueError(f"{prefix} labels: idx magic {magic}, not 2049")
                labels = np.frombuffer(fl.read(n_labels), np.uint8)
            return images, labels
        raise FileNotFoundError(f"MNIST idx files not found under {base} (expected "
                                f"{prefix}-images-idx3-ubyte[.gz])")

    def __len__(self):
        return self.images.shape[0]

    def __getitem__(self, index, rng=None):
        from PIL import Image
        img = _resize_pil(Image.fromarray(self.images[index]), self.image_size)
        x_0, gt = _finalize(img, None, False, self.transfer_uint8)
        return {"idx": index, "x_0": x_0, "gt": gt, "label": int(self.labels[index])}

    @staticmethod
    def collate_fn(batch):
        labels = np.asarray([b["label"] for b in batch], np.int32)
        onehot = np.zeros((len(batch), 10), np.float32)
        onehot[np.arange(len(batch)), labels] = 1.0
        return {
            "idx": np.asarray([b["idx"] for b in batch], np.int32),
            "x_0": np.stack([b["x_0"] for b in batch]),
            "gts": np.stack([b["gt"] for b in batch]),
            "label": labels,
            "condition": labels,          # class ids, for the UNet's embedding
            "condition_onehot": onehot,
        }


class SYNTHETIC:
    """Deterministic procedural image dataset for tests and smoke runs. It
    has no augmentation. With ``transfer_uint8`` its x_0 is the quantised
    ``gt`` (its float images are made, not decoded, so this changes them by
    up to half a uint8 step, as in the JAX package)."""

    def __init__(self, config):
        self.image_size = int(config["image_size"])
        self.image_channel = int(config.get("image_channel", 3))
        self.length = int(config.get("length", 256))
        self.num_class = int(config.get("num_class", 10))
        # multilabel=N emits +/-1 attribute vectors of size N (CelebA-HQ
        # style) instead of int class ids
        self.multilabel = int(config.get("multilabel", 0))
        self.transfer_uint8 = bool(config.get("transfer_uint8", False))
        # preload: generate every item once at construction, so a smoke run
        # measures the device and not the procedural generation
        self._cache = None
        if config.get("preload", False):
            self._cache = [self._generate(i) for i in range(self.length)]

    def __len__(self):
        return self.length

    def __getitem__(self, index, rng=None):
        if self._cache is not None:
            return self._cache[index]
        return self._generate(index)

    def _generate(self, index):
        rs = np.random.RandomState(index)
        base = rs.rand(8, 8, self.image_channel).astype(np.float32)
        # smooth upsample to image_size
        reps = self.image_size // 8
        img = np.kron(base, np.ones((reps, reps, 1), np.float32))
        gt = np.clip(np.floor(img * 255.0 + 0.5), 0, 255).astype(np.uint8)
        x_0 = gt if self.transfer_uint8 else img * 2.0 - 1.0
        if self.multilabel:
            label = (rs.randint(0, 2, (self.multilabel,)) * 2 - 1).astype(np.int32)
        else:
            label = index % self.num_class
        return {"idx": index, "x_0": x_0, "gt": gt, "label": label}

    @staticmethod
    def collate_fn(batch):
        labels = np.asarray([b["label"] for b in batch], np.int32)
        return {
            "idx": np.asarray([b["idx"] for b in batch], np.int32),
            "x_0": np.stack([b["x_0"] for b in batch]),
            "gts": np.stack([b["gt"] for b in batch]),
            "label": labels,
            "condition": labels,
        }


REGISTRY = {
    "CELEBA64": CELEBA64,
    "FFHQ": FFHQ,
    "CELEBAHQ": CELEBAHQ,
    "HORSE": HORSE,
    "BEDROOM": BEDROOM,
    "MNIST": MNIST,
    "SYNTHETIC": SYNTHETIC,
}


def build_dataset(config: dict):
    """Registry-string dataset construction."""
    return REGISTRY[config["name"]](config)
