"""The port's checkpoint files against ``pdae_tpu``'s on the CPU.

The codec (``pdae_torch/utils/_msgpack.py``) must write flax's
``msgpack_serialize`` bytes for the same tree, chunked form included, and
each package must read the other's files equal. Also: a sharded directory
written by ``pdae_tpu``, ``merge_partial``, ``restore_into``, the optimizer
subtree in optax's layout for Adam, Adam with weight decay and AdamW, the
whole ShiftUNet tree, the PNG grid, the config helpers and the seeds.
Every comparison is exact.
"""

import glob
import json
import os

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdae_torch.utils import _msgpack
from pdae_torch.utils import checkpoint as port_ckpt
from pdae_torch.utils import config as port_config
from pdae_torch.utils import convert, image as port_image, rng as port_rng
from pdae_torch.utils.sharded_checkpoint import (is_sharded_checkpoint,
                                                 load_sharded_checkpoint)
from pdae_tpu.utils import checkpoint as jax_ckpt
from pdae_tpu.utils import config as jax_config
from pdae_tpu.utils import image as jax_image

torch.set_num_threads(1)


def _trees():
    rs = np.random.RandomState(0)
    return {
        "nested": {"params": {"conv": {"kernel": rs.randn(3, 3, 2, 4).astype(np.float32),
                                       "bias": rs.randn(4).astype(np.float32)},
                              "dense": {"kernel": rs.randn(5, 3).astype(np.float32)}},
                   "step": np.asarray(7, np.int32)},
        "dtypes": {"f32_0d": np.asarray(1.5, np.float32), "i32_0d": np.asarray(-3, np.int32),
                   "u8": rs.randint(0, 256, (2, 3, 4)).astype(np.uint8),
                   "bool6": rs.rand(6) > 0.5,     # a 16-byte ext body: fixext16
                   "bool0": np.asarray(True), "i32": np.arange(300, dtype=np.int32),
                   "empty_arr": np.zeros((0, 3), np.float32)},
        "scalars": {"np_f32": np.float32(2.5), "np_i32": np.int32(-9), "np_bool": np.bool_(False),
                    "np_f64": np.float64(0.25), "py_int": 70000, "py_neg": -40000,
                    "py_big": 2 ** 40, "py_float": 0.125, "py_bool": True, "none": None,
                    "text": "x" * 40},
        "empty": {"0": {"count": np.asarray(3, np.int32), "mu": {"w": np.ones(2, np.float32)}},
                  "1": {}, "2": {"inner": {}}},
        "order": {k: np.asarray(i, np.int32) for i, k in
                  enumerate(["b", "a", "10", "2", "_x", "B", "shift", "encoder"])},
        "wide_map": {f"k{i}": np.float32(i) for i in range(20)},
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (list(a), list(b))
        for k in a:
            _assert_trees_equal(a[k], b[k])
        return
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(_trees()))
def test_codec_bytes_equal_flax(name):
    tree = _trees()[name]
    want = flax_ser.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == want
    _assert_trees_equal(_msgpack.unpackb(want), flax_ser.msgpack_restore(want))


@pytest.mark.parametrize("name", sorted(_trees()))
def test_each_package_restores_the_others_file(tmp_path, name):
    # a file's leaves are arrays: save_checkpoint makes every scalar a 0-d
    # array, and a str would become a string array, which flax cannot read
    tree = {k: v for k, v in _trees()[name].items() if k != "text"}
    port_file, jax_file = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    port_ckpt.save_checkpoint(port_file, tree)
    jax_ckpt.save_checkpoint(jax_file, tree)
    assert open(port_file, "rb").read() == open(jax_file, "rb").read()
    _assert_trees_equal(port_ckpt.load_checkpoint(jax_file), jax_ckpt.load_checkpoint(jax_file))
    _assert_trees_equal(jax_ckpt.load_checkpoint(port_file), port_ckpt.load_checkpoint(port_file))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_save_takes_tensors_as_numpy(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    path = str(tmp_path / "t.ckpt")
    port_ckpt.save_checkpoint(path, {"w": t, "step": np.asarray(1, np.int32)})
    np.testing.assert_array_equal(jax_ckpt.load_checkpoint(path)["w"], t.numpy())


def test_chunked_arrays(tmp_path, monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    tree = {"big": rs.randn(7, 11).astype(np.float32),       # 308 bytes: 5 chunks
            "many": rs.randint(0, 9, (200,)).astype(np.int32),  # 800 bytes: 13 chunks
            "small": rs.randn(3).astype(np.float32),
            "sub": {"big": rs.rand(70) > 0.5, "x": np.asarray(2, np.int32)}}
    want = flax_ser.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == want
    restored = _msgpack.unpackb(want)
    _assert_trees_equal({k: restored[k] for k in tree}, flax_ser.msgpack_restore(want))
    for k in ("big", "many", "small"):
        np.testing.assert_array_equal(restored[k], tree[k])
    np.testing.assert_array_equal(restored["sub"]["big"], tree["sub"]["big"])
    path = str(tmp_path / "c.ckpt")
    port_ckpt.save_checkpoint(path, tree)
    np.testing.assert_array_equal(jax_ckpt.load_checkpoint(path)["many"], tree["many"])


def test_bfloat16_and_complex_raise_by_name():
    with pytest.raises(TypeError, match="bfloat16"):
        _msgpack.packb({"w": np.zeros(2, jnp.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        _msgpack.unpackb(flax_ser.msgpack_serialize({"w": np.zeros(2, jnp.bfloat16)}))
    with pytest.raises(TypeError, match="complex"):
        _msgpack.packb({"w": np.zeros(2, np.complex64)})
    with pytest.raises(TypeError, match="cannot be serialized"):
        _msgpack.packb({"w": np.asarray("abc")})
    with pytest.raises(TypeError, match="tuple"):
        _msgpack.packb({"w": (1, 2)})


# -- the sharded directory of pdae_tpu ------------------------------------ #

def _sharded_dir(tmp_path):
    from pdae_tpu.parallel import make_mesh, shard_tree_fsdp
    from pdae_tpu.utils import save_sharded_checkpoint
    rs = np.random.RandomState(2)
    tree = {"params": {"conv": {"kernel": rs.randn(3, 3, 8, 16).astype(np.float32),
                                "bias": rs.randn(16).astype(np.float32)},
                       "dense": {"kernel": rs.randn(64, 32).astype(np.float32)}},
            "step": np.asarray(7, np.int32), "opt": {"0": {}, "1": {}}}
    placed = {"params": shard_tree_fsdp(make_mesh(), tree["params"], min_size=16),
              "step": tree["step"], "opt": tree["opt"]}
    d = str(tmp_path / "ckpt.sharded")
    save_sharded_checkpoint(d, placed)
    return d, tree


def test_sharded_directory_loads_equal(tmp_path):
    d, tree = _sharded_dir(tmp_path)
    assert is_sharded_checkpoint(d)
    got = load_sharded_checkpoint(d)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["params"], tree["params"])
    assert int(got["step"]) == 7 and got["opt"] == {"0": {}, "1": {}}
    # load_checkpoint dispatches on the directory form
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           port_ckpt.load_checkpoint(d)["params"], tree["params"])


def test_sharded_directory_with_a_shard_missing_fails(tmp_path):
    d, _ = _sharded_dir(tmp_path)
    [f] = glob.glob(os.path.join(d, "shard-*.msgpack"))
    os.unlink(f)
    with pytest.raises(FileNotFoundError, match="missing"):
        load_sharded_checkpoint(d)


def test_sharded_directory_with_a_short_shard_fails(tmp_path):
    d, _ = _sharded_dir(tmp_path)
    [f] = glob.glob(os.path.join(d, "shard-*.msgpack"))
    content = flax_ser.msgpack_restore(open(f, "rb").read())
    pieces = content["params/dense/kernel"]
    content["params/dense/kernel"] = {k: v for k, v in list(pieces.items())[:-1]}
    with open(f, "wb") as fh:
        fh.write(flax_ser.msgpack_serialize(content))
    with pytest.raises(ValueError, match="incomplete"):
        load_sharded_checkpoint(d)


# -- merge_partial and restore_into ---------------------------------------- #

def _a(*v):
    return np.asarray(v, np.float32)


MERGE_CASES = {
    "overwrite_matching": ({"a": {"w": _a(1)}, "b": {"w": _a(2)}}, {"a": {"w": _a(9)}}),
    "drop_unexpected": ({"a": {"w": _a(1)}}, {"a": {"w": _a(3), "extra": _a(4)}, "zz": _a(5)}),
    "keep_absent": ({"a": {"w": _a(1), "v": _a(7)}, "s": {"w": _a(2)}}, {"a": {"w": _a(0)}}),
    "empty_partial": ({"a": {"w": _a(1)}}, {}),
    "leaf_for_dict": ({"a": {"w": _a(1)}}, {"a": _a(3)}),
    "dict_for_leaf": ({"a": {"w": _a(1)}}, {"a": {"w": {"x": _a(3)}}}),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_partial_matches_jax(case):
    template, partial = MERGE_CASES[case]
    try:
        want = jax_ckpt.merge_partial(template, partial)
    except ValueError as e:
        with pytest.raises(ValueError, match="structural mismatch") as got:
            port_ckpt.merge_partial(template, partial)
        assert str(got.value) == str(e)
        return
    got = port_ckpt.merge_partial(template, partial)
    _assert_trees_equal(got, want)


def test_restore_into_checks_keys_and_shapes():
    template = {"a": {"w": np.zeros((2, 3), np.float32)}, "b": np.zeros(4, np.float32)}
    raw = {"a": {"w": np.ones((2, 3), np.float32)}, "b": np.ones(4, np.float32),
           "extra": np.ones(1, np.float32)}
    got = port_ckpt.restore_into(template, raw)
    _assert_trees_equal(got, {k: raw[k] for k in template})
    _assert_trees_equal(jax_ckpt.restore_into(template, raw), got)
    with pytest.raises(ValueError, match="shape mismatch"):
        port_ckpt.restore_into(template, {**raw, "b": np.ones(5, np.float32)})
    with pytest.raises(ValueError, match="lacks keys"):
        port_ckpt.restore_into(template, {"a": raw["a"]})


def test_checkpoint_paths_match_jax():
    assert port_ckpt.checkpoint_paths("/r") == jax_ckpt.checkpoint_paths("/r")
    for step in (0, 999, 1000, 12345):
        assert port_ckpt.snapshot_path("/r", step) == jax_ckpt.snapshot_path("/r", step)


# -- the optimizer subtree and the decoder tree ----------------------------- #

@pytest.fixture(scope="module")
def flax_groups():
    """Flax trees of the tiny encoder and ShiftUNet: {"encoder", "shift"},
    and the trunk."""
    from _torch_parity import TINY_DPM, init_flax
    from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
    from pdae_tpu.models import ShiftUNet as JaxShiftUNet
    from pdae_tpu.training.partition import split_shift_unet
    x = jnp.zeros((1, 16, 16, 3))
    enc = init_flax(JaxSemanticEncoder(16, channels=(8, 16), attn_after_stage=2), x, seed=0)
    dec = init_flax(JaxShiftUNet(latent_dim=16, **TINY_DPM), x, jnp.zeros((1,), jnp.int32),
                    jnp.zeros((1, 16)), seed=1)
    shift, trunk = split_shift_unet(dec)
    return {"encoder": enc, "shift": shift}, trunk


OPTIMIZERS = {"adam": {"lr": 1e-3}, "adam_wd": {"lr": 1e-3, "weight_decay": 0.01},
              "adamw": {"lr": 1e-3, "name": "AdamW", "weight_decay": 0.01}}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_subtree_matches_optax(flax_groups, name):
    from pdae_tpu.training.state import make_optimizer as jax_make_optimizer
    cfg = OPTIMIZERS[name]
    groups, _ = flax_groups
    tx = jax_make_optimizer(cfg)
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(jnp.asarray, groups)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rs.randn(*p.shape), jnp.float32),
                                   params)
    opt_state = tx.init(params)
    for _ in range(2):
        _, opt_state = tx.update(grads, opt_state, params)
    want = jax.tree_util.tree_map(np.asarray, flax_ser.to_state_dict(opt_state))
    moments = convert.optimizer_moments(cfg, want)
    assert moments["count"] == 2
    got = convert.optimizer_tree(cfg, moments["count"], moments["mu"], moments["nu"])
    assert _msgpack.packb(got) == flax_ser.msgpack_serialize(want)
    # and flax rebuilds the optax state from it
    restored = flax_ser.from_state_dict(opt_state, got)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # another optimizer's layout is refused
    other = OPTIMIZERS["adamw" if name != "adamw" else "adam"]
    with pytest.raises(ValueError, match="not in the layout"):
        convert.optimizer_moments(other, want)


def test_decoder_tree_round_trip(flax_groups):
    from _torch_parity import TINY_DPM
    from pdae_torch.models import ShiftUNet
    groups, trunk = flax_groups
    tree = {**trunk, **groups["shift"]}
    decoder = ShiftUNet(latent_dim=16, **TINY_DPM)
    decoder.load_state_dict(convert.unet_state_dict(tree), strict=True)
    back = convert.unet_tree(decoder.state_dict())
    assert sorted(back) == sorted(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


# -- PNG grid, config, seeds ---------------------------------------------- #

@pytest.mark.parametrize("channels", [1, 3])
def test_png_grid_reads_back_as_make_grid(tmp_path, channels):
    from PIL import Image
    rs = np.random.RandomState(channels)
    imgs = rs.randint(0, 256, (5, 6, 7, channels)).astype(np.uint8)
    gts = rs.randint(0, 256, (5, 6, 7, channels)).astype(np.uint8)
    np.testing.assert_array_equal(port_image.make_grid(imgs), jax_image.make_grid(imgs))
    path = str(tmp_path / "g.png")
    grid = port_image.save_image_grid(imgs, path, gts=gts)
    read = np.asarray(Image.open(path))
    want = grid[..., 0] if channels == 1 else grid
    np.testing.assert_array_equal(read, want)
    # the same pixels as the JAX package's PIL-written grid
    jax_path = str(tmp_path / "j.png")
    jax_image.save_image_grid(imgs, jax_path, gts=gts)
    np.testing.assert_array_equal(read, np.asarray(Image.open(jax_path)))


def test_config_helpers_match_jax(tmp_path):
    cfg = {"runner_config": {"display_steps": 2}, "optimizer_config": {"adam_betas": "(0.9, 0.99)"},
           "train_dataset_config": {"name": "SYNTHETIC", "image_size": 16},
           "eval_dataset_config": {"length": 4}, "empty": None}
    sets = ["runner_config.display_steps=5", "empty.x=[1, 2]", "name=abc"]
    a = port_config.apply_overrides(json.loads(json.dumps(cfg)), sets)
    b = jax_config.apply_overrides(json.loads(json.dumps(cfg)), sets)
    assert a == b
    assert port_config.overlay_eval_dataset_config(a) == jax_config.overlay_eval_dataset_config(b)
    assert port_config.parse_adam_betas("(0.9, 0.99)") == jax_config.parse_adam_betas("(0.9, 0.99)")
    # the port's snapshot is JSON text that both loaders read
    path = str(tmp_path / "config.yml")
    port_config.save_yaml(a, path)
    assert json.load(open(path)) == a
    assert jax_config.load_yaml(path) == a == port_config.load_yaml(path)
    # a YAML file goes through PyYAML
    yml = str(tmp_path / "c.yml")
    jax_config.save_yaml(a, yml)
    assert port_config.load_yaml(yml) == a


def test_stream_seeds_are_pure_and_distinct():
    seeds = {(s, st, k): port_rng.stream_seed(s, st, k)
             for s in (0, 1) for st in (port_rng.INIT, port_rng.TRAIN, port_rng.EVAL)
             for k in range(4)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(0 <= v < 2 ** 63 for v in seeds.values())
    assert port_rng.stream_seed(0, port_rng.TRAIN, 3) == seeds[(0, port_rng.TRAIN, 3)]
    g1 = port_rng.generator(0, port_rng.TRAIN, 3, "cpu")
    g2 = port_rng.generator(0, port_rng.TRAIN, 3, "cpu")
    assert torch.equal(torch.randn(5, generator=g1), torch.randn(5, generator=g2))


def test_artifacts_read_jax_files(tmp_path):
    from pdae_torch.training.artifacts import (load_latent_stats, load_pdae,
                                               resolve_model_config)
    rs = np.random.RandomState(4)
    stats = {"mean": rs.randn(16).astype(np.float32), "std": rs.rand(16).astype(np.float32)}
    path = str(tmp_path / "latents.ckpt")
    jax_ckpt.save_checkpoint(path, stats)
    mean, std = load_latent_stats(path)
    assert mean.dtype == torch.float32
    np.testing.assert_array_equal(mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(std.numpy(), stats["std"])
    tree = {"ema_encoder": {"w": rs.randn(3).astype(np.float32)},
            "ema_decoder": {"v": rs.randn(2).astype(np.float32)}, "step": np.int32(1)}
    jax_ckpt.save_checkpoint(str(tmp_path / "pdae.ckpt"), tree)
    cfg, enc, dec = load_pdae({"k": 1}, str(tmp_path / "pdae.ckpt"))
    assert cfg == {"k": 1}
    np.testing.assert_array_equal(enc["w"], tree["ema_encoder"]["w"])
    np.testing.assert_array_equal(dec["v"], tree["ema_decoder"]["v"])
    run_cfg = str(tmp_path / "config.yml")
    jax_config.save_yaml({"denoise_fn_config": {"base_channel": 8}}, run_cfg)
    assert resolve_model_config(run_cfg) == {"base_channel": 8}
    assert resolve_model_config({"base_channel": 4}) == {"base_channel": 4}
