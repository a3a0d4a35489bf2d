"""The port's native data path against ``pdae_tpu``'s on the CPU: the C++ LMDB
reader, the LMDB writer, the libjpeg decoder and triangle resize, the datasets
at ``fast_decode``'s default, and ``python -m pdae_torch.prepare_lmdb``.

The port builds its own copies of the C++ sources (``pdae_torch/csrc``) with
the JAX package's g++ flags, so the two packages must agree bit for bit: the
same bytes from every reader, the same ``data.mdb`` from both writers and both
packing scripts, the same pixels from both decoders, and the same dataset
items (tolerance 0). Against PIL the native resize stays within 3 uint8
levels, and within 1 on at least 99% of values. A test of the native code
skips where its library cannot be built here (no g++ or libjpeg).
"""

import importlib.util
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

from pdae_torch.data import (CELEBA64, NativeReader, Reader, build_dataset, open_lmdb,
                             write_lmdb, write_lmdb_stream)
from pdae_torch.data import lmdb_store, native_image
from pdae_torch.utils import _host_build
from pdae_tpu.data import datasets as jax_datasets
from pdae_tpu.data import lmdb_store as jax_lmdb
from pdae_tpu.data import native_image as jax_native_image

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELEBA_HW = (218, 178)          # CelebA's aligned images, height x width


def _need_reader():
    if lmdb_store.native_lib() is None:
        pytest.skip("the native LMDB reader does not build here: "
                    + _host_build.last_line("lmdb_reader.cpp"))


def _need_decoder():
    if not native_image.available() or not jax_native_image.available():
        pytest.skip("the native JPEG decoder does not build here: "
                    + _host_build.last_line("image_decode.cpp"))


def _jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _png(img: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _photo(rs, hw=CELEBA_HW) -> np.ndarray:
    """A smooth image with noise, closer to a photo than uniform noise (so
    the JPEG keeps detail at every frequency the resize filters)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = [128 + 100 * np.sin(xx / rs.uniform(5, 30) + rs.uniform(0, 6))
            * np.cos(yy / rs.uniform(5, 30)) for _ in range(3)]
    img = np.stack(base, -1) + rs.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the LMDB reader ----------------------------------------------------------- #

def _items(kind: str) -> dict:
    if kind == "multilevel_overflow":
        # branch pages and values too big for a page
        return {f"{i:06d}".encode(): bytes([i % 256]) * (10000 if i % 7 == 0 else 40)
                for i in range(2000)}
    if kind == "long_keys":
        # a low branching factor: more than one branch level
        return {(f"{i:07d}".encode() * 60): bytes([i % 251]) * 20 for i in range(3000)}
    rs = np.random.RandomState(int(kind[-1]))
    items = {}
    for i in range(int(rs.randint(200, 800))):
        key = bytes(rs.randint(0, 256, int(rs.choice([1, 4, 16, 100])), np.uint8))
        vlen = int(rs.choice([0, 1, 37, 500, 4000, 4096, 4097, 20000]))
        items[key + f"#{i}".encode()] = bytes(rs.randint(0, 256, vlen, np.uint8))
    return items


@pytest.mark.parametrize("kind", ["multilevel_overflow", "long_keys", "fuzz0", "fuzz1",
                                  "fuzz2"])
def test_native_reader_matches_both_readers(tmp_path, kind):
    _need_reader()
    items = _items(kind)
    path = str(tmp_path / "db")
    jax_lmdb.write_lmdb(path, items)
    native, pure, ref = NativeReader(path), Reader(path), jax_lmdb.NativeReader(path)
    assert len(native) == len(pure) == len(ref) == len(items)
    for k, v in items.items():
        got = native.get(k)
        assert got == v == pure.get(k) == ref.get(k), k
    for miss in (b"\x00" * 101, b"", b"zzzz-missing", next(iter(items)) + b"\x00"):
        assert native.get(miss) is None is pure.get(miss) is ref.get(miss)
    assert dict(pure.items()) == items
    assert list(native.items()) == list(pure.items())
    for r in (native, pure, ref):
        r.close()
    native.close()                            # a second close is a no-op


def _outcome(reader, key, error=lmdb_store.LMDBError):
    try:
        return ("value", reader.get(key))
    except error:
        return ("error", None)


def test_native_reader_truncated_file_raises_as_jax(tmp_path):
    """A truncated ``data.mdb`` (a partial copy): each probe gives the JAX
    reader's outcome, a hit is still right, and some probes cannot resolve."""
    _need_reader()
    items = {f"k{i:05d}".encode(): b"v" * (3000 if i % 5 == 0 else 80) for i in range(2000)}
    path = str(tmp_path / "full")
    write_lmdb(path, items)
    data = open(os.path.join(path, "data.mdb"), "rb").read()
    cut = tmp_path / "cut"
    cut.mkdir()
    (cut / "data.mdb").write_bytes(data[:len(data) // 3])
    native, ref = NativeReader(str(cut)), jax_lmdb.NativeReader(str(cut))
    unresolved = 0
    for i in range(0, 2000, 25):
        k = f"k{i:05d}".encode()
        kind, value = _outcome(native, k)
        assert (kind, value) == _outcome(ref, k, jax_lmdb.LMDBError), k
        assert value is None or value == items[k]
        unresolved += value is None
    assert unresolved > 0
    native.close()
    ref.close()
    # a file too short for its meta pages does not open
    (cut / "data.mdb").write_bytes(data[:100])
    with pytest.raises(lmdb_store.LMDBError, match="open failed"):
        NativeReader(str(cut))


def test_native_reader_corruption_matches_jax(tmp_path):
    """Byte flips anywhere in the file: each probe gives the JAX reader's
    outcome (a value, a miss, or ``LMDBError``) and never crashes."""
    _need_reader()
    items = {f"k{i:05d}".encode(): b"v" * (6000 if i % 4 == 0 else 120) for i in range(800)}
    base = str(tmp_path / "base")
    write_lmdb(base, items)
    data = bytearray(open(os.path.join(base, "data.mdb"), "rb").read())
    rs = np.random.RandomState(0)
    probes = [f"k{i:05d}".encode() for i in rs.randint(0, 800, 20)]
    opened = 0
    for trial in range(40):
        corrupted = bytearray(data)
        for _ in range(rs.randint(1, 6)):
            corrupted[rs.randint(0, len(corrupted))] = rs.randint(0, 256)
        d = tmp_path / f"fuzz{trial}"
        d.mkdir()
        (d / "data.mdb").write_bytes(bytes(corrupted))
        try:
            ref = jax_lmdb.NativeReader(str(d))
        except jax_lmdb.LMDBError:
            with pytest.raises(lmdb_store.LMDBError):
                NativeReader(str(d))
            continue
        native = NativeReader(str(d))
        opened += 1
        for k in probes:
            assert _outcome(native, k) == _outcome(ref, k, jax_lmdb.LMDBError), (trial, k)
        native.close()
        ref.close()
    assert opened > 0


def test_native_get_copies_the_value(tmp_path):
    """``get`` copies out of the map: the bytes outlive the next call, the
    reader and its file."""
    _need_reader()
    items = {b"a": b"1" * 5000, b"b": b"2" * 10}
    path = str(tmp_path / "db")
    write_lmdb(path, items)
    reader = NativeReader(path)
    first = reader.get(b"a")
    second = reader.get(b"b")
    reader.close()
    os.unlink(os.path.join(path, "data.mdb"))
    assert first == items[b"a"] and second == items[b"b"]


def test_open_lmdb_picks_the_native_reader_and_falls_back(tmp_path, monkeypatch):
    _need_reader()
    path = str(tmp_path / "db")
    write_lmdb(path, {b"k": b"v"})
    assert type(open_lmdb(path)) is NativeReader
    assert type(open_lmdb(path, prefer_native=False)) is Reader
    assert type(open_lmdb(os.path.join(path, "data.mdb"))) is NativeReader
    monkeypatch.setattr(lmdb_store, "native_lib", lambda: None)
    reader = open_lmdb(path)
    assert type(reader) is Reader and reader.get(b"k") == b"v"
    with pytest.raises(lmdb_store.LMDBError, match="unavailable"):
        NativeReader(path)


# -- the writer ---------------------------------------------------------------- #

@pytest.mark.parametrize("kind,psize", [("multilevel_overflow", 4096), ("long_keys", 4096),
                                        ("fuzz0", 4096), ("fuzz1", 8192),
                                        ("multilevel_overflow", 1024), ("empty", 4096)])
def test_writer_byte_equal_to_jax(tmp_path, kind, psize):
    items = {} if kind == "empty" else _items(kind)
    want = jax_lmdb.write_lmdb(str(tmp_path / "jax"), items, psize=psize)
    got = write_lmdb(str(tmp_path / "port"), items, psize=psize)
    streamed = write_lmdb_stream(str(tmp_path / "stream"), iter(sorted(items.items())),
                                 psize=psize)
    assert got == os.path.join(str(tmp_path / "port"), "data.mdb")
    want_bytes = open(want, "rb").read()
    assert open(got, "rb").read() == want_bytes == open(streamed, "rb").read()
    reader = Reader(str(tmp_path / "port"))
    assert len(reader) == len(items) and dict(reader.items()) == items


def test_writer_file_layout_and_refusals(tmp_path):
    items = {b"a": b"1", b"b": b"2" * 9000}
    flat = write_lmdb(str(tmp_path / "sub" / "flat.mdb"), items, subdir=False)
    want = jax_lmdb.write_lmdb(str(tmp_path / "jax.mdb"), items, subdir=False)
    assert flat == str(tmp_path / "sub" / "flat.mdb")
    assert open(flat, "rb").read() == open(want, "rb").read()
    assert Reader(flat).get(b"b") == items[b"b"]
    with pytest.raises(ValueError, match="sorted"):
        write_lmdb_stream(str(tmp_path / "bad"), iter([(b"b", b"1"), (b"a", b"2")]))
    # a failed stream leaves no data.mdb behind
    assert not os.path.exists(tmp_path / "bad" / "data.mdb")


# -- the decoder ----------------------------------------------------------------- #

@pytest.mark.parametrize("hw,quality,size,crop", [
    (CELEBA_HW, 95, 64, (57, 25, 128, 128)),       # CELEBA64
    ((256, 256), 90, 128, None),                    # CELEBAHQ / FFHQ at 128
    ((40, 40), 75, 64, None),                       # an upsample
    ((64, 64), 95, 64, None),                       # no resize
])
def test_decoder_bit_equal_to_jax(hw, quality, size, crop):
    _need_decoder()
    rs = np.random.RandomState(hw[0] + quality)
    data = _jpeg(_photo(rs, hw), quality)
    got, want = native_image.decode_jpeg(data), jax_native_image.decode_jpeg(data)
    assert got.shape == hw + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native_image.resize_triangle(got, size),
                                  jax_native_image.resize_triangle(want, size))
    a = native_image.load_jpeg_resized(data, size, crop=crop)
    assert a.shape == (size, size, 3)
    np.testing.assert_array_equal(a, jax_native_image.load_jpeg_resized(data, size, crop=crop))


def test_decoder_gives_none_for_other_input():
    _need_decoder()
    png = _png(np.zeros((8, 8, 3), np.uint8))
    for data in (png, b"", b"\xff\xd8", b"\xff\xd8\xff" + b"\x00" * 64):
        assert native_image.decode_jpeg(data) is None
        assert native_image.load_jpeg_resized(data, 16) is None
        assert jax_native_image.decode_jpeg(data) is None


def test_native_within_pil():
    """At the CELEBA64 crop the native decode and resize are within 3 levels
    of PIL's, and within 1 on at least 99% of values."""
    _need_decoder()
    from PIL import Image
    rs = np.random.RandomState(11)
    for i in range(4):
        data = _jpeg(_photo(rs), 95)
        native = native_image.load_jpeg_resized(data, 64, crop=CELEBA64.crop).astype(int)
        top, left, h, w = CELEBA64.crop
        pil = Image.open(io.BytesIO(data)).convert("RGB").crop((left, top, left + w, top + h))
        pil = np.asarray(pil.resize((64, 64), Image.BILINEAR)).astype(int)
        diff = np.abs(native - pil)
        assert diff.max() <= 3, i
        assert (diff <= 1).mean() >= 0.99, i


# -- the datasets at fast_decode's default --------------------------------------- #

def _celeba_lmdb(tmp_path, key_fmt="None-%07d", n=6, offset=0, hw=CELEBA_HW, png=()):
    rs = np.random.RandomState(3)
    items = {}
    for i in range(n):
        img = _photo(rs, hw)
        items[(key_fmt % (offset + i)).encode()] = _png(img) if i in png else _jpeg(img)
    path = str(tmp_path / "lmdb")
    write_lmdb(path, items)
    return path


@pytest.mark.parametrize("case", [
    {"name": "CELEBA64", "image_size": 64},
    {"name": "CELEBA64", "image_size": 64, "transfer_uint8": True},
    {"name": "CELEBA64", "image_size": 64, "augmentation": True},
    {"name": "CELEBA64", "image_size": 64, "split": "valid"},
    {"name": "CELEBAHQ", "image_size": 128, "require_annotations": False},
    {"name": "CELEBAHQ", "image_size": 128, "require_annotations": False,
     "transfer_uint8": True},
], ids=["celeba64", "celeba64_uint8", "celeba64_flip", "celeba64_valid", "celebahq",
        "celebahq_uint8"])
def test_items_bitwise_at_the_default_fast_decode(tmp_path, case):
    """The repaired fault: at ``fast_decode``'s default both packages decode
    through the native library and give the same items, where the PIL path
    differs from them by a level."""
    _need_decoder()
    _need_reader()
    celeba = case["name"] == "CELEBA64"
    offset = CELEBA64.SPLITS[case.get("split", "train")][0] if celeba else 0
    path = _celeba_lmdb(tmp_path, "None-%07d" if celeba else "256-%05d", offset=offset,
                        hw=CELEBA_HW if celeba else (256, 256))
    cfg = {**case, "data_path": path, "image_channel": 3}
    port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
    assert port.fast_decode and type(port._txn()) is NativeReader
    pil = build_dataset({**cfg, "fast_decode": False})
    moved = 0
    for i in range(6):
        rng = (np.random.default_rng([1234, 0, 0, i]), np.random.default_rng([1234, 0, 0, i]))
        a, b = port.__getitem__(i, rng[0]), ref.__getitem__(i, rng[1])
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["gt"].shape == (case["image_size"],) * 2 + (3,)
        moved += not np.array_equal(a["gt"], pil.__getitem__(
            i, np.random.default_rng([1234, 0, 0, i]))["gt"])
    assert moved > 0


def test_png_and_grayscale_items_go_through_pil(tmp_path):
    """A PNG in a 3-channel LMDB and every item of a 1-channel dataset decode
    through PIL in both packages, whatever ``fast_decode`` says."""
    path = _celeba_lmdb(tmp_path, "256-%05d", n=4, hw=(48, 48), png=(1, 3))
    for channels in (3, 1):
        cfg = {"name": "FFHQ", "data_path": path, "image_size": 32,
               "image_channel": channels}
        port, ref = build_dataset(cfg), jax_datasets.build_dataset(cfg)
        pil = build_dataset({**cfg, "fast_decode": False})
        for i in range(4):
            a, b = port[i], ref[i]
            assert a["x_0"].shape == (32, 32, channels)
            np.testing.assert_array_equal(a["x_0"], b["x_0"])
            np.testing.assert_array_equal(a["gt"], b["gt"])
            if channels == 1 or i in (1, 3):
                np.testing.assert_array_equal(a["gt"], pil[i]["gt"])


def test_items_fall_back_to_pil_without_the_library(tmp_path, monkeypatch):
    path = _celeba_lmdb(tmp_path, n=3)
    cfg = {"name": "CELEBA64", "data_path": path, "image_size": 64}
    pil = [build_dataset({**cfg, "fast_decode": False})[i] for i in range(3)]
    monkeypatch.setattr(native_image, "_lib", lambda: None)
    monkeypatch.setattr(lmdb_store, "native_lib", lambda: None)
    ds = build_dataset(cfg)
    assert not native_image.available() and type(ds._txn()) is Reader
    for i in range(3):
        np.testing.assert_array_equal(ds[i]["x_0"], pil[i]["x_0"])


# -- prepare_lmdb ------------------------------------------------------------------ #

@pytest.mark.parametrize("flags", [["--key-format", "None-%07d"],
                                   ["--key-format", "256-%05d", "--size", "24",
                                    "--quality", "80", "--limit", "5"]])
def test_prepare_lmdb_byte_equal_to_the_jax_script(tmp_path, flags, capsys):
    from PIL import Image

    from pdae_torch import prepare_lmdb
    folder = tmp_path / "images"
    folder.mkdir()
    rs = np.random.RandomState(4)
    for i, ext in enumerate([".png", ".jpg", ".JPEG", ".bmp", ".webp", ".png", ".jpg"]):
        Image.fromarray(_photo(rs, (30 + 3 * i, 41 - 2 * i))).save(folder / f"{i:03d}{ext}")
    (folder / "notes.txt").write_text("not an image")
    _script("prepare_lmdb").main([str(folder), str(tmp_path / "jax"), *flags])
    prepare_lmdb.main([str(folder), str(tmp_path / "port"), *flags])
    out = capsys.readouterr().out
    n = 5 if "--limit" in flags else 7
    assert out.count(f"packed {n} images") == 2
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert ((tmp_path / "port" / "data.mdb").read_bytes()
            == (tmp_path / "jax" / "data.mdb").read_bytes())
    reader = open_lmdb(str(tmp_path / "port"))
    assert len(reader) == n
    with pytest.raises(SystemExit, match="no images"):
        prepare_lmdb.main([str(tmp_path / "port"), str(tmp_path / "none")])


# -- the host-code build ------------------------------------------------------------- #

def test_host_build_names_races_and_reports(tmp_path, monkeypatch):
    _need_reader()
    path = _host_build.library_path("lmdb_reader.cpp")
    assert os.path.dirname(path) == _host_build.BUILD_DIR
    assert path != _host_build.library_path("image_decode.cpp")
    # a fresh build directory and cache: eight threads ask at once, one
    # build runs, all get the same library, no temporary file is left
    monkeypatch.setattr(_host_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_host_build, "_libs", {})
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: got.append(lmdb_store.native_lib()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and got[0] is not None and all(g is got[0] for g in got)
    assert os.listdir(tmp_path / "build") == [os.path.basename(
        _host_build.library_path("lmdb_reader.cpp"))]
    # a source that does not compile: None, and the compiler's output kept
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_host_build, "CSRC", str(csrc))
    monkeypatch.setitem(_host_build.LIBS, "broken.cpp", ())
    assert _host_build.load("broken.cpp", lambda lib: None) is None
    assert "error" in _host_build.build_logs["broken.cpp"]
    assert _host_build.last_line("broken.cpp")
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]


def test_resize_refuses_a_non_rgb_array():
    _need_decoder()
    with pytest.raises(ValueError, match="RGB"):
        native_image.resize_triangle(np.zeros((8, 8), np.uint8), 4)
