"""The port's metric backbones and FID against ``pdae_tpu``'s on the CPU:
AlexNet LPIPS, InceptionV3 pool3, their weight loaders, the FID functions,
and the two samplers that use them, on seeded weights at the backbones' full
published widths (the pretrained files are not in the repository).

Tolerances:

* LPIPS distances within rtol 1e-4 and atol 1e-5 times the largest value;
  Inception features within the same, relative to the largest |feature|;
  the bilinear resize to 299 within 1e-4 (fp32 sums in another order);
* the FID functions and ``FIDMetric`` within 1e-12 relative (both are numpy
  and scipy float64 on the same inputs);
* the samplers as ``tests/test_torch_samplers.py`` holds them: the metrics
  of the port's reconstructions within the metrics' agreement plus what the
  reconstructions' difference moves JAX's own metric by; the generated
  images within one uint8 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdae_tpu.metrics as jax_metrics_pkg
import pdae_tpu.sampling.samplers as jax_samplers
import pdae_torch.metrics as port_metrics_pkg
import pdae_torch.sampling.samplers as port_samplers
from _torch_sampler_files import read_png, sampler_files, within_one_level
from pdae_tpu.metrics import FIDMetric as JaxFIDMetric
from pdae_tpu.metrics import LPIPSMetric as JaxLPIPSMetric
from pdae_tpu.metrics import activation_statistics as jax_activation_statistics
from pdae_tpu.metrics import frechet_distance as jax_frechet_distance
from pdae_tpu.metrics import lpips_distance as jax_lpips_distance
from pdae_tpu.metrics.fid import chunked_features as jax_chunked_features
from pdae_tpu.metrics.inception import convert_inception_state_dict, inception_pool3
from pdae_tpu.metrics.lpips import _CHANNELS
from pdae_tpu.sampling import SAMPLERS as JAX_SAMPLERS
from pdae_tpu.utils import save_checkpoint as jax_save_checkpoint
from pdae_tpu.utils.image import make_grid as jax_make_grid
from pdae_torch.metrics import (FIDMetric, activation_statistics, frechet_distance,
                                inception_feature_fn, save_stats)
from pdae_torch.metrics.fid import chunked_features
from pdae_torch.metrics.inception import (InceptionV3, inception_state_dict, load_inception,
                                          load_inception_feature_fn, resize_to_fid)
from pdae_torch.metrics.lpips import LPIPS, LPIPSMetric, load_lpips, lpips_state_dict
from pdae_torch.sampling import SAMPLERS, BaseSampler
from _torch_metric_weights import seeded_inception, seeded_lpips
from test_inception import inception_weight_spec

torch.set_num_threads(1)

BACKBONE_RTOL, BACKBONE_ATOL = 1e-4, 1e-5      # atol times the largest value
FID_RTOL = 1e-12
LPIPS_CONV_KEYS = ["net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8",
                   "net.slice5.10"]


def torchvision_inception(flat):
    """The flat weights as a torchvision state dict (OIHW), with the keys the
    loader drops (``fc.*``, ``AuxLogits.*``) and the BN counters."""
    sd = {k: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if k.endswith(".conv.weight")
                              else v) for k, v in flat.items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
               for k in flat if k.endswith("running_mean")})
    sd.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
               "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)})
    return sd


def lpips_package(flat):
    """The flat weights keyed as the lpips package keys them, with its
    scaling layer."""
    sd = {"scaling_layer.shift": torch.tensor([-.030, -.088, -.188]).view(1, 3, 1, 1),
          "scaling_layer.scale": torch.tensor([.458, .448, .450]).view(1, 3, 1, 1)}
    for i, key in enumerate(LPIPS_CONV_KEYS):
        sd[f"{key}.weight"] = torch.from_numpy(flat[f"conv{i}_w"].transpose(3, 2, 0, 1).copy())
        sd[f"{key}.bias"] = torch.from_numpy(flat[f"conv{i}_b"])
    for i, c in enumerate(_CHANNELS):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(flat[f"lin{i}_w"]).view(1, c, 1, 1)
    return sd


@pytest.fixture(scope="module")
def inception_weights():
    return seeded_inception()


@pytest.fixture(scope="module")
def jax_inception(inception_weights):
    """``inception_pool3`` jitted once for the module, over the seeded weights."""
    params = {k: jnp.asarray(v) for k, v in inception_weights.items()}
    fn = jax.jit(inception_pool3)
    return lambda x: np.asarray(fn(params, jnp.asarray(x)))


@pytest.fixture(scope="module")
def port_inception(inception_weights):
    return load_inception(torchvision_inception(inception_weights), device="cpu")


def _close_to_largest(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=BACKBONE_RTOL, atol=BACKBONE_ATOL * scale)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# -- LPIPS --------------------------------------------------------------------- #

def test_lpips_matches_jax_at_full_width():
    flat = seeded_lpips()
    rs = np.random.RandomState(1)
    a = (rs.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.3 * rs.randn(2, 64, 64, 3), -1, 1).astype(np.float32)
    want = np.asarray(jax_lpips_distance({k: jnp.asarray(v) for k, v in flat.items()},
                                         jnp.asarray(a), jnp.asarray(b)))
    model = load_lpips(lpips_package(flat), device="cpu")
    with torch.inference_mode():
        got = model(_nchw(a), _nchw(b)).numpy()
        same = model(_nchw(a), _nchw(a)).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    _close_to_largest(got, want)
    np.testing.assert_array_equal(same, 0.0)


def test_lpips_metric_maps_unit_images_as_jax(tmp_path):
    flat = seeded_lpips(2)
    jax_save_checkpoint(str(tmp_path / "lpips.ckpt"), flat)
    rs = np.random.RandomState(3)
    a = rs.rand(3, 48, 48, 3).astype(np.float32)
    b = rs.rand(3, 48, 48, 3).astype(np.float32)
    port, jax_metric = LPIPSMetric(str(tmp_path / "lpips.ckpt"), "cpu"), \
        JaxLPIPSMetric(str(tmp_path / "lpips.ckpt"))
    port.process(_nchw(a), _nchw(b))
    jax_metric.process(a, b)
    _close_to_largest(np.asarray(port.results), np.asarray(jax_metric.results))


# -- InceptionV3 ----------------------------------------------------------------- #

@pytest.mark.parametrize("hw", [(64, 64), (320, 320), (48, 400), (512, 300)])
def test_resize_to_299_matches_jax_image_resize(hw):
    """Up (64), down (320, antialiased) and one axis each way."""
    x = np.random.RandomState(sum(hw)).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = resize_to_fid(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [64, 320])
def test_inception_pool3_matches_jax_at_full_width(size, jax_inception, port_inception):
    x = np.random.RandomState(size).randint(0, 256, (2, size, size, 3), np.uint8)
    want = jax_inception(x)
    with torch.inference_mode():
        got = port_inception(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    # the seeded weights give features that depend on the image
    assert np.abs(want[0] - want[1]).max() > 1e-3 * np.abs(want).max()
    _close_to_largest(got, want)


# -- the weight loaders ----------------------------------------------------------- #

def test_inception_loads_pdae_tpu_flat_files_torchvision_dicts_and_pth(
        tmp_path, inception_weights, port_inception):
    """The converter's flat file (HWIO), a torchvision dict (fc, AuxLogits
    and BN counters included) and a ``.pth`` of one: the same state,
    ``strict=True``."""
    tv = torchvision_inception(inception_weights)
    jax_save_checkpoint(str(tmp_path / "inception.ckpt"), convert_inception_state_dict(tv))
    torch.save(tv, tmp_path / "pt_inception.pth")
    want = {k: v for k, v in port_inception.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    for source in (str(tmp_path / "inception.ckpt"), tv, str(tmp_path / "pt_inception.pth")):
        got = load_inception(source, device="cpu").state_dict()
        assert not any(k.startswith(("fc.", "AuxLogits.")) for k in inception_state_dict(source))
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    x = np.random.RandomState(4).randint(0, 256, (2, 40, 40, 3), np.uint8)
    features = load_inception_feature_fn(str(tmp_path / "inception.ckpt"), "cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(features(x), port_inception(torch.from_numpy(x)).numpy())


def test_inception_keys_are_the_torchvision_table_and_strict():
    spec = inception_weight_spec()
    sd = InceptionV3().state_dict()
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(spec)
    for k, shape in spec.items():
        want = ((shape[3], shape[2], shape[0], shape[1]) if k.endswith(".conv.weight")
                else shape)
        assert tuple(sd[k].shape) == want, k
    partial = torchvision_inception(seeded_inception())
    del partial["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(RuntimeError, match="Missing key.*Mixed_7c.branch_pool.conv.weight"):
        load_inception(partial, device="cpu")


def test_lpips_loads_flat_files_lpips_package_and_torchvision_alexnet(tmp_path):
    flat = seeded_lpips(5)
    jax_save_checkpoint(str(tmp_path / "lpips.ckpt"), flat)
    package = lpips_package(flat)
    torch.save(package, tmp_path / "alex_lpips.pth")
    # torchvision's AlexNet (convs at features.0/3/6/8/10, its classifier
    # dropped) merged with the lpips package's alex.pth (the lins only)
    alexnet = {f"features.{key.rsplit('.', 1)[1]}.{p}": package[f"{key}.{p}"]
               for key in LPIPS_CONV_KEYS for p in ("weight", "bias")}
    alexnet["classifier.1.weight"] = torch.zeros(4096, 9216)
    lins = {k: v for k, v in package.items() if k.startswith("lin")}
    want = LPIPS().state_dict()
    assert set(want) == {f"{k}.{p}" for k in LPIPS_CONV_KEYS for p in ("weight", "bias")} | \
        {f"lin{i}.model.1.weight" for i in range(5)}
    for sources in ((str(tmp_path / "lpips.ckpt"),), (package,),
                    (str(tmp_path / "alex_lpips.pth"),), (alexnet, lins)):
        sd = lpips_state_dict(*sources)
        assert set(sd) == set(want) and not any(k.startswith("scaling_layer") for k in sd)
        got = load_lpips(*sources, device="cpu").state_dict()
        for k, v in package.items():
            if k in want:
                torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key.*lin0.model.1.weight"):
        load_lpips(alexnet, device="cpu")


# -- FID ---------------------------------------------------------------------------- #

def _features(n, d, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d) @ rs.randn(d, d) * 0.3 + rs.randn(d)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-300))


def test_fid_functions_equal_jax():
    f1, f2 = _features(200, 16, 0), _features(150, 16, 1) + 0.2
    mu1, s1 = activation_statistics(f1)
    mu2, s2 = activation_statistics(f2)
    for got, want in zip((mu1, s1), jax_activation_statistics(f1)):
        assert got.dtype == np.float64 and _rel(got, want) <= FID_RTOL
    fid = frechet_distance(mu1, s1, mu2, s2)
    assert fid > 0 and _rel(fid, jax_frechet_distance(mu1, s1, mu2, s2)) <= FID_RTOL
    assert abs(frechet_distance(mu1, s1, mu1, s1)) < 1e-8


def test_frechet_distance_rank_deficient_retry_and_imaginary_check_as_jax():
    """A singular product takes the eps retry in both; a non-negligible
    imaginary part raises in both."""
    f = _features(5, 12, 2)                        # 5 rows: rank 4 of 12
    mu, s = activation_statistics(f)
    mu2, s2 = activation_statistics(_features(300, 12, 3))
    for args in ((mu, s, mu2, s2), (mu2, s2, mu2, s2)):
        try:
            want = jax_frechet_distance(*args)
        except ValueError as e:
            with pytest.raises(ValueError, match="imaginary"):
                frechet_distance(*args)
            assert "imaginary" in str(e)
            continue
        assert _rel(frechet_distance(*args), want) <= FID_RTOL
    bad = np.diag([-1.0, 1.0])                     # sqrtm has an imaginary diagonal
    for fn in (frechet_distance, jax_frechet_distance):
        with pytest.raises(ValueError, match="imaginary"):
            fn(np.zeros(2), bad, np.zeros(2), np.eye(2))


@pytest.mark.parametrize("n", [5, 64, 130])        # below, at and above the chunk
def test_chunked_features_equal_jax(n):
    rs = np.random.RandomState(n)
    images = rs.randint(0, 256, (n, 4, 4, 3), np.uint8)
    proj = rs.randn(48, 6)
    calls = []

    def feature_fn(x):
        calls.append(len(x))
        return x.reshape(len(x), -1).astype(np.float64) @ proj

    got = chunked_features(feature_fn, images)
    port_calls, calls[:] = list(calls), []
    want = jax_chunked_features(feature_fn, images)
    assert got.shape == (n, 6) and _rel(got, want) <= FID_RTOL
    assert port_calls == calls == [64] * (-(-n // 64))
    with pytest.raises(ValueError, match="no images"):
        chunked_features(feature_fn, images[:0])


def test_fid_metric_and_stats_file_equal_jax(tmp_path):
    rs = np.random.RandomState(7)
    proj = rs.randn(48, 5)

    def feature_fn(x):
        return x.reshape(len(x), -1).astype(np.float64) @ proj / 255.0

    ref = rs.randint(0, 256, (70, 4, 4, 3), np.uint8)
    gen = [rs.randint(0, 200, (n, 4, 4, 3), np.uint8) for n in (30, 41)]
    port, jax_metric = FIDMetric(feature_fn), JaxFIDMetric(feature_fn)
    for m in (port, jax_metric):
        m.set_target_from_images(ref)
        for g in gen:
            m.process(g)
        m.all_gather_results()
    assert len(port.features) == 2
    assert _rel(port.compute_metrics(), jax_metric.compute_metrics()) <= FID_RTOL
    save_stats(str(tmp_path / "s" / "ref.npz"), chunked_features(feature_fn, ref))
    from_file = FIDMetric.from_stats_file(feature_fn, str(tmp_path / "s" / "ref.npz"))
    jax_from_file = JaxFIDMetric.from_stats_file(feature_fn, str(tmp_path / "s" / "ref.npz"))
    for m in (from_file, jax_from_file):
        for g in gen:
            m.process(g)
    assert _rel(from_file.compute_metrics(), jax_from_file.compute_metrics()) <= FID_RTOL
    with pytest.raises(ValueError, match="target statistics not set"):
        m = FIDMetric(feature_fn)
        m.process(gen[0])
        m.compute_metrics()


def test_inception_feature_fn_names_the_missing_file(tmp_path):
    missing = str(tmp_path / "pt_inception.ckpt")
    with pytest.raises(FileNotFoundError, match="pt_inception.ckpt"):
        inception_feature_fn(missing, "cpu")
    with pytest.raises(FileNotFoundError, match="None"):
        inception_feature_fn(None, "cpu")


# -- the samplers with their metrics ---------------------------------------------- #

@pytest.fixture(scope="module")
def files32(tmp_path_factory):
    """The sampler test stack at 32px: AlexNet LPIPS needs at least 31px."""
    root = tmp_path_factory.mktemp("stack32")
    jax_save_checkpoint(str(root / "lpips.ckpt"), seeded_lpips(9))
    with sampler_files(root, size=32) as f:
        f.path["lpips.ckpt"] = str(root / "lpips.ckpt")
        yield f


def test_autoencoding_eval_with_lpips_matches_jax(files32, monkeypatch):
    """SSIM, MSE and LPIPS of 5 images in batches of 2 (the last padded):
    each of the port's metrics within |port(p) - jax(p)| + |jax(p) - jax(j)|
    of JAX's, the first term the metric's own agreement on the port's
    reconstructions p (checked here), the second what the reconstructions'
    difference moves JAX's metric by."""
    seen = {"jax": [], "port": []}

    class JaxRecording(jax_samplers.SSIMMetric):
        def process(self, images, gts):
            seen["jax"].append((np.asarray(images), np.asarray(gts)))
            super().process(images, gts)

    class PortRecording(port_samplers.SSIMMetric):
        def process(self, images, gts):
            seen["port"].append(tuple(a.permute(0, 2, 3, 1).numpy() for a in (images, gts)))
            super().process(images, gts)

    monkeypatch.setattr(jax_samplers, "SSIMMetric", JaxRecording)
    monkeypatch.setattr(port_samplers, "SSIMMetric", PortRecording)
    config = dict(files32.config, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5",
                  batch_size=2, max_samples=5, lpips_weights=files32.path["lpips.ckpt"])
    want = JAX_SAMPLERS["autoencoding_eval"](config).start()
    got = SAMPLERS["autoencoding_eval"](config, device="cpu").start()
    assert sorted(got) == sorted(want) == ["lpips", "mse", "ssim"]
    assert np.isfinite(got["lpips"]) and got["lpips"] > 0
    j, p = ({k: np.concatenate([s[i] for s in seen[who]]) for i, k in enumerate("ab")}
            for who in ("jax", "port"))
    assert p["a"].shape == (5, 32, 32, 3)
    np.testing.assert_allclose(2 * p["a"] - 1, 2 * j["a"] - 1, rtol=0, atol=1e-2)

    # the metrics in the samplers' batches of 2 (a conv's sums depend on the
    # batch it runs in)
    def jax_lpips(x):
        m = JaxLPIPSMetric(files32.path["lpips.ckpt"])
        for i in range(0, 5, 2):
            m.process(x["a"][i:i + 2], x["b"][i:i + 2])
        return m.compute_metrics()

    def port_lpips(x):
        m = LPIPSMetric(files32.path["lpips.ckpt"], "cpu")
        for i in range(0, 5, 2):
            m.process(_nchw(x["a"][i:i + 2]), _nchw(x["b"][i:i + 2]))
        return m.compute_metrics()

    jax_on_port = jax_lpips(p)
    agreement = abs(port_lpips(p) - jax_on_port)
    assert agreement <= BACKBONE_RTOL * abs(jax_on_port) + BACKBONE_ATOL
    assert abs(got["lpips"] - want["lpips"]) <= agreement + abs(jax_on_port - want["lpips"]) \
        + 1e-12
    assert abs(jax_lpips(j) - want["lpips"]) <= 1e-12


def _jax_draws(monkeypatch, seed, size, batch):
    """Make the port's draws those of ``pdae_tpu``'s ``UnconditionalSample``
    at rank 0: salt ``2 * done`` its x_T, ``2 * done + 1`` its z_T."""
    def draw(self, shape, salt, uniform=False):
        done = salt // 2
        k1, k2 = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), done), 0))
        if salt % 2:
            return torch.from_numpy(np.array(jax.random.normal(k1, tuple(shape))))
        x_T = np.asarray(jax.random.normal(k2, (batch, size, size, 3)))
        return torch.from_numpy(np.ascontiguousarray(x_T.transpose(0, 3, 1, 2)))

    monkeypatch.setattr(BaseSampler, "draw", draw)


@pytest.mark.parametrize("target", ["reference", "stats_path"])
def test_unconditional_sample_with_fid_matches_jax(files32, tmp_path, monkeypatch, target):
    """Both samplers on the same draws (the port's ``draw`` replaced by the
    JAX sampler's keys), with a cheap projection in place of InceptionV3
    (which the tests above hold to JAX), against the dataset's first 6
    images or a stats file of theirs: the grids within one level, the port's
    FID equal to ``pdae_tpu``'s FID of the port's own images, and within
    1e-3 relative of the JAX sampler's."""
    proj = np.random.RandomState(11).randn(32 * 32 * 3, 4) / 32.0

    def features(images):
        return images.reshape(len(images), -1).astype(np.float64) @ proj

    fed = []

    def feature_fn(path, device=None):
        assert path == "inception.ckpt"

        def recording(images):
            fed.append(np.asarray(images))
            return features(images)
        return recording

    monkeypatch.setattr(jax_metrics_pkg, "inception_feature_fn", feature_fn)
    monkeypatch.setattr(port_metrics_pkg, "inception_feature_fn", feature_fn)
    ds = port_samplers.SamplerContext(files32.config, "cpu").dataset()
    gts = np.stack([ds[i]["gt"] for i in range(6)])
    fid_cfg = {"inception_path": "inception.ckpt", "num_reference": 6}
    if target == "stats_path":
        save_stats(str(tmp_path / "ref.npz"), features(gts))
        fid_cfg["stats_path"] = str(tmp_path / "ref.npz")
    _jax_draws(monkeypatch, 0, 32, 3)
    config = dict(files32.config, num_samples=6, batch_size=3, latent_ddim_style="ddim5",
                  decoder_ddim_style="ddim5", fid=fid_cfg)
    want_png, want_fid = JAX_SAMPLERS["unconditional_sample"](
        dict(config, output_path=str(tmp_path / "jax.png"))).start()
    got_png, got_fid = SAMPLERS["unconditional_sample"](
        dict(config, output_path=str(tmp_path / "port.png")), device="cpu").start()
    within_one_level(read_png(got_png), read_png(want_png))
    generated = fed[-1][:6]              # the port's last chunk, its padding dropped
    np.testing.assert_array_equal(jax_make_grid(generated), read_png(got_png))
    jax_on_port = JaxFIDMetric(features)
    if target == "stats_path":
        jax_on_port = JaxFIDMetric.from_stats_file(features, fid_cfg["stats_path"])
    else:
        jax_on_port.set_target_from_images(gts)
    jax_on_port.process(generated)
    assert np.isfinite(got_fid) and got_fid > 0
    assert _rel(got_fid, jax_on_port.compute_metrics()) <= FID_RTOL
    assert abs(got_fid - want_fid) <= 1e-3 * abs(want_fid)


def test_unconditional_sample_without_fid_returns_the_path(files32, tmp_path):
    config = dict(files32.config, num_samples=2, latent_ddim_style="ddim2",
                  decoder_ddim_style="ddim2", output_path=str(tmp_path / "u.png"))
    assert SAMPLERS["unconditional_sample"](config, device="cpu").start() == \
        str(tmp_path / "u.png")
    assert read_png(tmp_path / "u.png").shape == (36, 70, 3)
