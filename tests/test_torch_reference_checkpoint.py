"""The port's converters of the reference's ``.pt`` checkpoints
(``python -m pdae_torch.convert``, ``utils/reference_checkpoint.py``) and its
``python -m pdae_torch.ckpt_tool`` against the JAX package's scripts on the
CPU.

Seeded flax params of each ``pdae_tpu`` model (a class-conditional UNet, a
ShiftUNet, the 64px and 128px encoders of 4 and 5 stages, MLPSkipNet and the
classifier) are exported to reference ``.pt`` files with ``pdae_tpu``'s
``export_reference_checkpoint``, beside ``optimizer`` and ``scaler`` entries
as the reference's trainers save them; seeded InceptionV3 and AlexNet LPIPS
weights go out as torchvision and lpips-package state dicts. Then:

* each conversion's file is byte-equal to ``scripts/convert_torch_checkpoint.py``'s
  for the same flags;
* ``--export`` gives the JAX script's state dicts, key for key, dtype for
  dtype and bit for bit, and converting them back gives the same file;
* the converted weights load into the port's modules with ``strict=True`` and
  give the JAX forward within fp32 rtol 1e-4 / atol 1e-5;
* ``ckpt_tool info`` prints what the JAX tool prints, ``to-full`` writes its
  bytes, and ``to-sharded`` is refused with the ROADMAP item that lifts it.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_metric_weights import seeded_inception, seeded_lpips
from _torch_parity import TINY_DPM, init_flax, nchw, nhwc
from pdae_tpu.metrics.lpips import _CHANNELS
from pdae_tpu.models import LinearClassifier as JaxLinearClassifier
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_tpu.utils import save_sharded_checkpoint as jax_save_sharded
from pdae_tpu.utils.torch_convert import (export_reference_checkpoint as
                                          jax_export_reference_checkpoint)
from pdae_torch import ckpt_tool, convert
from pdae_torch.models import (MLPSkipNet, ShiftUNet, UNet, build_classifier,
                               encoder_for_resolution)
from pdae_torch.utils import (classifier_state_dict, encoder_state_dict, load_checkpoint,
                              mlp_skip_net_state_dict, unet_state_dict)
from pdae_torch.utils.reference_checkpoint import (convert_reference_checkpoint,
                                                   export_reference_checkpoint)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
LATENT, CLASSES = 16, 5
CLASS_DPM = dict(TINY_DPM, num_class=10)
TINY_MLP = dict(input_channel=LATENT, model_channel=64, num_layers=4)
LPIPS_CONV_KEYS = ["0", "3", "6", "8", "10"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_tree(exported):
    """``pdae_tpu``'s exported dict as torch tensors, as its script saves it."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))
    return {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict) else
                t(v) if isinstance(v, np.ndarray) else v) for k, v in exported.items()}


def _trainer_extras():
    """What the reference's trainers save beside the models: not portable."""
    return {"optimizer": {"state": {0: {"step": torch.tensor(3.0),
                                        "exp_avg": torch.ones(4)}},
                          "param_groups": [{"lr": 1e-4, "params": [0]}]},
            "scaler": {"scale": 65536.0, "growth_factor": 2.0, "_growth_tracker": 0}}


@pytest.fixture(scope="module")
def models():
    """Seeded flax params of every model, with the JAX forward of each on
    seeded inputs: ``name -> (params, inputs, want)``."""
    rs = np.random.RandomState(0)
    out = {}

    def add(name, model, inputs, seed):
        params = init_flax(model, *[jnp.asarray(a) for a in inputs], seed=seed)
        want = model.apply({"params": params}, *[jnp.asarray(a) for a in inputs])
        out[name] = (params, inputs, jax.tree_util.tree_map(np.asarray, want))

    x16 = rs.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3, 700], np.int32)
    z = rs.randn(2, LATENT).astype(np.float32)
    add("unet", JaxUNet(**CLASS_DPM), (x16, t, np.array([1, 7], np.int32)), 1)
    add("shift_unet", JaxShiftUNet(latent_dim=LATENT, **TINY_DPM), (x16, t, z), 2)
    add("encoder64", jax_encoder_for_resolution(64, LATENT),
        (rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32),), 3)
    add("encoder128", jax_encoder_for_resolution(128, LATENT),
        (rs.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32),), 4)
    add("mlp", JaxMLPSkipNet(**TINY_MLP), (z, t), 5)
    add("classifier", JaxLinearClassifier(num_classes=CLASSES), (z,), 6)
    return out


@pytest.fixture(scope="module")
def files(models, tmp_path_factory):
    """The reference ``.pt`` files: ``name -> path``."""
    root = tmp_path_factory.mktemp("reference")
    p = {k: v[0] for k, v in models.items()}
    rs = np.random.RandomState(9)
    trees = {
        "dpm": ({"step": np.asarray(12, np.int32), "denoise_fn": p["unet"],
                 "ema_denoise_fn": p["unet"]}, 4),
        "pdae64": ({"step": np.asarray(30, np.int32), "encoder": p["encoder64"],
                    "ema_encoder": p["encoder64"], "decoder": p["shift_unet"],
                    "ema_decoder": p["shift_unet"]}, 4),
        "pdae128": ({"ema_encoder": p["encoder128"], "ema_decoder": p["shift_unet"]}, 5),
        "latent": ({"step": np.asarray(5, np.int32), "latent_denoise_fn": p["mlp"],
                    "ema_latent_denoise_fn": p["mlp"]}, 4),
        "classifier": ({"classifier": p["classifier"], "ema_classifier": p["classifier"]}, 4),
    }
    paths = {}
    for name, (tree, stages) in trees.items():
        data = {**_torch_tree(jax_export_reference_checkpoint(tree, stages)),
                **_trainer_extras()}
        paths[name] = str(root / f"{name}.pt")
        torch.save(data, paths[name])
    paths["stats"] = str(root / "stats.pt")
    torch.save({"mean": torch.from_numpy(rs.randn(1, LATENT).astype(np.float32)),
                "std": torch.from_numpy(rs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32))},
               paths["stats"])
    flat = seeded_inception()
    sd = {k: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if k.endswith(".conv.weight")
                              else v) for k, v in flat.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
               for k in flat if k.endswith("running_mean")})
    sd.update({"fc.weight": torch.zeros(8, 2048), "fc.bias": torch.zeros(8),
               "AuxLogits.conv0.conv.weight": torch.zeros(4, 768, 1, 1)})
    paths["inception"] = str(root / "pt_inception.pth")
    torch.save(sd, paths["inception"])
    flat = seeded_lpips()
    convs = {}
    for i, idx in enumerate(LPIPS_CONV_KEYS):
        convs[f"{idx}.weight"] = torch.from_numpy(flat[f"conv{i}_w"].transpose(3, 2, 0, 1).copy())
        convs[f"{idx}.bias"] = torch.from_numpy(flat[f"conv{i}_b"])
    package = {"scaling_layer.shift": torch.zeros(1, 3, 1, 1),
               "scaling_layer.scale": torch.ones(1, 3, 1, 1)}
    for i, idx in enumerate(LPIPS_CONV_KEYS):
        for leaf in ("weight", "bias"):
            package[f"net.slice{i + 1}.{idx}.{leaf}"] = convs[f"{idx}.{leaf}"]
    for i, c in enumerate(_CHANNELS):
        package[f"lin{i}.model.1.weight"] = torch.from_numpy(flat[f"lin{i}_w"]).view(1, c, 1, 1)
    paths["lpips"] = str(root / "alex.pth")
    torch.save(package, paths["lpips"])
    paths["alexnet"] = str(root / "alexnet.pth")
    torch.save({**{f"features.{k}": v for k, v in convs.items()},
                "classifier.1.weight": torch.zeros(4, 9216)}, paths["alexnet"])
    return paths


CASES = {"dpm": [], "pdae64": [], "pdae128": ["--encoder-stages", "5"], "latent": [],
         "classifier": [], "stats": ["--stats"], "inception": ["--inception"],
         "lpips": ["--lpips"], "alexnet": ["--lpips"]}


@pytest.fixture(scope="module")
def converted(files, tmp_path_factory):
    """Every case converted by both scripts: ``name -> (port path, jax path)``."""
    root = tmp_path_factory.mktemp("converted")
    jax_convert = _script("convert_torch_checkpoint")
    out = {}
    for name, flags in CASES.items():
        port, ref = str(root / f"{name}.ckpt"), str(root / f"{name}.jax.ckpt")
        convert.main([files[name], port, *flags])
        jax_convert.main([files[name], ref, *flags])
        out[name] = (port, ref)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_convert_byte_equal_to_the_jax_script(converted, name):
    port, ref = converted[name]
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["dpm", "pdae64", "pdae128", "latent", "classifier",
                                  "stats"])
def test_export_equal_to_the_jax_script(converted, tmp_path, name):
    flags = CASES[name][:2] if name == "pdae128" else []
    port_pt, ref_pt = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    convert.main([converted[name][0], port_pt, "--export", *flags])
    _script("convert_torch_checkpoint").main([converted[name][0], ref_pt, "--export", *flags])
    got = torch.load(port_pt, map_location="cpu", weights_only=True)
    want = torch.load(ref_pt, map_location="cpu", weights_only=True)
    assert sorted(got) == sorted(want)
    for key, sub in want.items():
        if not isinstance(sub, dict):
            assert type(got[key]) is type(sub), key
            assert torch.equal(got[key], sub) if torch.is_tensor(sub) else got[key] == sub
            continue
        assert sorted(got[key]) == sorted(sub), key
        for k, v in sub.items():
            assert got[key][k].dtype == v.dtype, (key, k)
            assert torch.equal(got[key][k], v), (key, k)
    # and back: the round trip gives the converted file's bytes
    back = str(tmp_path / "back.ckpt")
    convert.main([port_pt, back, *(["--stats"] if name == "stats" else flags)])
    with open(back, "rb") as a, open(converted[name][0], "rb") as b:
        assert a.read() == b.read()


def _port_forward(name, raw, inputs):
    if name == "unet":
        model, sd = UNet(**CLASS_DPM), unet_state_dict(raw["ema_denoise_fn"])
    elif name == "shift_unet":
        model, sd = ShiftUNet(latent_dim=LATENT, **TINY_DPM), unet_state_dict(raw["ema_decoder"])
    elif name.startswith("encoder"):
        size = int(name[len("encoder"):])
        model, sd = encoder_for_resolution(size, LATENT), encoder_state_dict(raw["ema_encoder"])
    elif name == "mlp":
        model, sd = MLPSkipNet(**TINY_MLP), mlp_skip_net_state_dict(raw["ema_latent_denoise_fn"])
    else:
        model, sd = build_classifier(CLASSES, LATENT), classifier_state_dict(
            raw["ema_classifier"])
    model.load_state_dict(sd, strict=True)
    model.eval()
    args = [nchw(a) if a.ndim == 4 else torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        out = model(*args)
    return tuple(nhwc(o) if o.dim() == 4 else o.numpy()
                 for o in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("name,case", [("unet", "dpm"), ("shift_unet", "pdae64"),
                                       ("encoder64", "pdae64"), ("encoder128", "pdae128"),
                                       ("mlp", "latent"), ("classifier", "classifier")])
def test_converted_weights_give_the_jax_forward(models, converted, name, case):
    _, inputs, want = models[name]
    got = _port_forward(name, load_checkpoint(converted[case][0]), inputs)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, **TOL)


def test_trainer_entries_skipped_and_stages_checked(files, models):
    data = torch.load(files["pdae64"], map_location="cpu", weights_only=False)
    assert {"optimizer", "scaler"} <= set(data)
    out = convert_reference_checkpoint(data)
    assert sorted(out) == ["decoder", "ema_decoder", "ema_encoder", "encoder", "step"]
    assert out["step"].dtype == np.int32 and int(out["step"]) == 30
    # a 4-stage encoder is not taken for the 128px one, either way
    with pytest.raises(ValueError, match="4 encoder stages, not 5"):
        convert_reference_checkpoint(data, num_encoder_stages=5)
    with pytest.raises(ValueError, match="5 encoder stages, not 4"):
        export_reference_checkpoint({"ema_encoder": models["encoder128"][0]})
    # a classifier saved as a module's state dict (``fc.weight``)
    w = torch.randn(CLASSES, LATENT)
    tree = convert_reference_checkpoint({"ema_classifier": {"fc.weight": w,
                                                            "fc.bias": torch.zeros(CLASSES)}})
    np.testing.assert_array_equal(tree["ema_classifier"]["fc"]["kernel"], w.numpy().T)


@pytest.fixture(scope="module")
def sharded(converted, tmp_path_factory):
    """The 64px PDAE's converted tree as a sharded directory, written by
    ``pdae_tpu`` (the port reads this layout and does not write it)."""
    path = str(tmp_path_factory.mktemp("sharded") / "pdae64.sharded")
    jax_save_sharded(path, load_checkpoint(converted["pdae64"][0]))
    return path


@pytest.mark.parametrize("form", ["full", "sharded"])
def test_ckpt_tool_info_as_the_jax_tool(converted, sharded, form, capsys):
    path = converted["pdae64"][0] if form == "full" else sharded
    ckpt_tool.main(["info", path])
    got = capsys.readouterr().out
    _script("ckpt_tool").main(["info", path])
    want = capsys.readouterr().out
    assert got == want
    assert f"format: {form}" in got and "step: 30" in got and "ema_encoder:" in got


def test_ckpt_tool_to_full_byte_equal_and_to_sharded_refused(converted, sharded, tmp_path):
    port, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    ckpt_tool.main(["to-full", sharded, port])
    _script("ckpt_tool").main(["to-full", sharded, ref])
    with open(port, "rb") as a, open(ref, "rb") as b:
        got = a.read()
        assert got == b.read()
    with open(converted["pdae64"][0], "rb") as f:
        assert got == f.read()
    with pytest.raises(SystemExit, match="not a sharded"):
        ckpt_tool.main(["to-full", port, str(tmp_path / "x.ckpt")])
    # to-sharded, no longer refused: byte-equal to the JAX tool's directory
    # (the manifest and shard-0-00000-of-00001.msgpack), and to-full of it
    # byte-equal to the file it came from
    ours, theirs = tmp_path / "port.sharded", tmp_path / "jax.sharded"
    ckpt_tool.main(["to-sharded", port, str(ours)])
    _script("ckpt_tool").main(["to-sharded", port, str(theirs)])
    names = sorted(os.listdir(theirs))
    assert names == ["manifest.msgpack", "shard-0-00000-of-00001.msgpack"]
    assert sorted(os.listdir(ours)) == names
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    back = str(tmp_path / "back.ckpt")
    ckpt_tool.main(["to-full", str(ours), back])
    with open(back, "rb") as f:
        assert f.read() == got
    with pytest.raises(SystemExit, match="already a directory"):
        ckpt_tool.main(["to-sharded", str(ours), str(tmp_path / "y.sharded")])


def test_the_port_names_its_own_converter(tmp_path):
    from pdae_torch.metrics import inception_feature_fn
    with pytest.raises(FileNotFoundError, match="python -m pdae_torch.convert"):
        inception_feature_fn(str(tmp_path / "missing.ckpt"), "cpu")
