"""The port's data path (``pdae_torch/data``) against ``pdae_tpu``'s on the CPU:
the same index stream from the ``Loader`` (epochs, skips, ``drop_last``, a
rank of a world), the same SYNTHETIC items, the same CELEBA64 items read
from an LMDB that ``pdae_tpu``'s writer made, hflip augmentation included,
and the same items in ``transfer_uint8`` mode and from MNIST idx files.
Every comparison is exact.
"""

import gzip
import io
import os
import struct

import numpy as np
import pytest
import torch

from pdae_torch.data import (CELEBA64, FFHQ, SYNTHETIC, Loader, build_dataset,
                             open_lmdb, prefetch_to_device)
from pdae_tpu.data import datasets as jax_datasets
from pdae_tpu.data import lmdb_store as jax_lmdb
from pdae_tpu.data.pipeline import Loader as JaxLoader

torch.set_num_threads(1)


class _Indices:
    """A dataset whose items are their own index (and the first draw of the
    item's augmentation generator), to read a loader's stream."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"idx": i, "draw": -1.0 if rng is None else float(rng.random())}

    @staticmethod
    def collate_fn(batch):
        return {"idx": np.asarray([b["idx"] for b in batch], np.int32),
                "draw": np.asarray([b["draw"] for b in batch])}


def _stream(loader, start_epoch, skip, batches):
    it = loader.infinite(start_epoch=start_epoch, skip_batches=skip)
    return [next(it) for _ in range(batches)]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_loader_stream_matches_jax(seed, drop_last, rank, world):
    ds = _Indices(23)
    kw = dict(batch_size=4, shuffle=True, seed=seed, drop_last=drop_last, num_workers=2,
              process_index=rank, process_count=world)
    port, ref = Loader(ds, **kw), JaxLoader(ds, **kw)
    assert port.batches_per_epoch() == ref.batches_per_epoch() == len(port)
    bpe = port.batches_per_epoch()
    for epoch in range(3):
        for a, b in zip(port.epoch(epoch), ref.epoch(epoch)):
            np.testing.assert_array_equal(a["idx"], b["idx"])
            np.testing.assert_array_equal(a["draw"], b["draw"])
    # a resume's fast-forward: epoch 1, batch 1 onward, across an epoch end
    for a, b in zip(_stream(port, 1, 1, 2 * bpe), _stream(ref, 1, 1, 2 * bpe)):
        np.testing.assert_array_equal(a["idx"], b["idx"])
        np.testing.assert_array_equal(a["draw"], b["draw"])


def test_loader_refuses_a_batch_above_the_shard():
    with pytest.raises(ValueError, match="smaller than batch_size"):
        Loader(_Indices(3), batch_size=4).batches_per_epoch()


@pytest.mark.parametrize("cfg", [
    {"name": "SYNTHETIC", "image_size": 16, "image_channel": 1, "length": 6},
    {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3, "length": 5, "preload": True},
    {"name": "SYNTHETIC", "image_size": 16, "length": 4, "multilabel": 40},
])
def test_synthetic_items_bitwise(cfg):
    port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
    assert isinstance(port, SYNTHETIC) and len(port) == len(ref)
    items = [port[i] for i in range(len(port))]
    want = [ref[i] for i in range(len(ref))]
    for a, b in zip(items, want):
        for k in ("x_0", "gt", "label"):
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, exp = SYNTHETIC.collate_fn(items), jax_datasets.SYNTHETIC.collate_fn(want)
    assert sorted(got) == sorted(exp)
    for k in got:
        np.testing.assert_array_equal(got[k], exp[k])


def _write_idx(root, prefix, n, seed, compress):
    """MNIST idx files (magic 2051/2049, big-endian headers) of random
    digits, as ``tests/test_mnist_e2e.py`` writes them."""
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28), np.uint8)
    labels = rs.randint(0, 10, (n,), np.uint8)
    suffix = ".gz" if compress else ""
    opener = gzip.open if compress else open
    os.makedirs(root, exist_ok=True)
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("case", ["synthetic_uint8", "celeba64_uint8", "mnist",
                                  "mnist_uint8"])
def test_uint8_and_mnist_items_match_jax(case, tmp_path):
    """``transfer_uint8`` (raw pixels for x_0) and the MNIST idx reader build
    and give ``pdae_tpu``'s items and batches bit for bit: MNIST from
    ``.gz`` files under ``data_path/MNIST/raw`` (train) and plain ones under
    ``data_path`` (test), resized to 32px with a one-hot condition."""
    uint8 = case.endswith("uint8")
    if case.startswith("synthetic"):
        cfgs = [{"name": "SYNTHETIC", "image_size": 16, "length": 4, "multilabel": 40,
                 "transfer_uint8": True}]
    elif case.startswith("celeba64"):
        path, _ = _jpeg_lmdb(tmp_path, "None-%07d", 4)
        cfgs = [{"name": "CELEBA64", "data_path": path, "image_size": 64,
                 "augmentation": True, "transfer_uint8": True, "fast_decode": False}]
    else:
        data = str(tmp_path / "mnist")
        _write_idx(os.path.join(data, "MNIST", "raw"), "train", 6, 0, True)
        _write_idx(data, "t10k", 4, 1, False)
        cfgs = [{"name": "MNIST", "data_path": data, "image_size": 32, "image_channel": 1,
                 "train": train, "transfer_uint8": uint8} for train in (True, False)]
    for cfg in cfgs:
        port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
        assert type(port).__name__ == type(ref).__name__ and len(port) == len(ref)
        n = min(len(port), 4)
        items = [port.__getitem__(i, np.random.default_rng([1234, 0, 0, i]))
                 for i in range(n)]
        want = [ref.__getitem__(i, np.random.default_rng([1234, 0, 0, i]))
                for i in range(n)]
        for a, b in zip(items, want):
            assert a["x_0"].dtype == (np.uint8 if uint8 else np.float32)
            for k in ("x_0", "gt"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        got, exp = type(port).collate_fn(items), type(ref).collate_fn(want)
        assert sorted(got) == sorted(exp)
        for k in got:
            assert got[k].dtype == exp[k].dtype, k
            np.testing.assert_array_equal(got[k], exp[k])


def _jpeg_lmdb(tmp_path, key_fmt, n, offset=0, size=(192, 176)):
    from PIL import Image
    rs = np.random.RandomState(5)
    items = {}
    for i in range(n):
        img = rs.randint(0, 256, size + (3,)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        items[(key_fmt % (offset + i)).encode()] = buf.getvalue()
    path = str(tmp_path / "lmdb")
    jax_lmdb.write_lmdb(path, items)
    return path, items


def test_lmdb_reader_matches_jax(tmp_path):
    path, items = _jpeg_lmdb(tmp_path, "None-%07d", 40)
    port, ref = open_lmdb(path), jax_lmdb.Reader(path)
    assert len(port) == len(ref) == 40
    assert list(port.items()) == list(ref.items()) == sorted(items.items())
    for k, v in items.items():
        assert port.get(k) == v
    assert port.get(b"None-9999999") is None


@pytest.mark.parametrize("augmentation", [False, True])
def test_celeba64_items_bitwise(tmp_path, augmentation):
    path, _ = _jpeg_lmdb(tmp_path, "None-%07d", 6)
    cfg = {"name": "CELEBA64", "data_path": path, "image_size": 64, "image_channel": 3,
           "augmentation": augmentation, "split": "train", "fast_decode": False}
    port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
    assert isinstance(port, CELEBA64) and len(port) == len(ref) == 162770
    flips = 0
    for i in range(6):
        a = port.__getitem__(i, np.random.default_rng([1234, 0, 0, i]))
        b = ref.__getitem__(i, np.random.default_rng([1234, 0, 0, i]))
        assert a["x_0"].shape == (64, 64, 3) and a["x_0"].dtype == np.float32
        np.testing.assert_array_equal(a["x_0"], b["x_0"])
        np.testing.assert_array_equal(a["gt"], b["gt"])
        plain = port[i]
        flips += not np.array_equal(a["gt"], plain["gt"])
    assert (flips > 0) == augmentation


def test_ffhq_keys_and_grayscale(tmp_path):
    path, _ = _jpeg_lmdb(tmp_path, "256-%05d", 3, size=(40, 40))
    cfg = {"name": "FFHQ", "data_path": path, "image_size": 16, "image_channel": 1,
           "fast_decode": False}
    port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
    assert isinstance(port, FFHQ)
    for i in range(3):
        a, b = port[i], ref[i]
        assert a["x_0"].shape == (16, 16, 1)
        np.testing.assert_array_equal(a["x_0"], b["x_0"])
        np.testing.assert_array_equal(a["gt"], b["gt"])


def test_prefetch_moves_the_step_keys_nchw():
    ds = build_dataset({"name": "SYNTHETIC", "image_size": 16, "image_channel": 3,
                        "length": 12})
    loader = Loader(ds, batch_size=4, seed=0, num_workers=1)
    host = list(loader.epoch(0))
    got = list(prefetch_to_device(loader.epoch(0), "cpu", size=2, keys=("x_0",)))
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        assert sorted(g) == ["x_0"]
        assert g["x_0"].shape == (4, 3, 16, 16) and g["x_0"].is_contiguous()
        np.testing.assert_array_equal(g["x_0"].permute(0, 2, 3, 1).numpy(), h["x_0"])


def test_celebahq_labels_match_jax(tmp_path):
    path, _ = _jpeg_lmdb(tmp_path, "256-%05d", 3, size=(32, 32))
    rs = np.random.RandomState(6)
    with open(os.path.join(path, "CelebAMask-HQ-attribute-anno.txt"), "w") as f:
        f.write("3\n" + " ".join(jax_datasets.CELEBAHQ.ID_TO_LABEL) + "\n")
        for i in range(3):
            f.write(f"{i}.jpg " + " ".join(str(v) for v in rs.choice([-1, 1], 40)) + "\n")
    cfg = {"name": "CELEBAHQ", "data_path": path, "image_size": 16, "fast_decode": False}
    port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
    assert port.ID_TO_LABEL == ref.ID_TO_LABEL
    items, want = [port[i] for i in range(3)], [ref[i] for i in range(3)]
    got, exp = type(port).collate_fn(items), type(ref).collate_fn(want)
    assert sorted(got) == sorted(exp)
    for k in got:
        np.testing.assert_array_equal(got[k], exp[k])
    with pytest.raises(FileNotFoundError, match="require_annotations"):
        build_dataset({**cfg, "data_path": str(tmp_path)})
