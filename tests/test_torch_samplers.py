"""The port's sampler suite against ``pdae_tpu``'s on the CPU, on checkpoint
files that ``pdae_tpu`` writes (``tests/_torch_sampler_files.py``).

Tolerances:

* the eval's reconstructions within 1e-2 in [-1, 1], as
  ``tests/test_torch_serving.py`` holds autoencodes: the DDIM encode
  multiplies a model-level difference by up to sqrt(1 / abar_t);
* the PNGs of ``interpolation``, ``manipulation`` and the rows of
  ``autoencoding_example``, ``test_dpms``, ``denoise_one_step`` and
  ``unconditional_sample`` within one uint8 level;
* the latent stats within rtol 1e-4, the gap curves within rtol 1e-4.

The samplers that draw noise are held to the JAX ``GaussianDiffusion``
method fed the same draws: the port's ``BaseSampler.draw`` is replaced by
numpy arrays seeded by the draw's salt, and the JAX method gets the same
arrays (``noise=``, ``x_T=``, ``z_T=``); the JAX ``GaussianDiffusion`` is
built outside ``jax.jit``, and only its method is jitted.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdae_tpu.sampling.samplers as jax_samplers
import pdae_torch.sampling.context as port_context
import pdae_torch.sampling.samplers as port_samplers
from _torch_sampler_files import (DATASET, DIFFUSION, LATENT, SIZE, STEPS, jax_fns,
                                  read_png, sampler_files, within_one_level)
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.metrics import mse as jax_mse
from pdae_tpu.metrics import ssim as jax_ssim
from pdae_tpu.sampling import SAMPLERS as JAX_SAMPLERS
from pdae_tpu.utils import load_checkpoint as jax_load_checkpoint
from pdae_tpu.utils.image import make_grid as jax_make_grid
from pdae_tpu.utils.image import paste_rows as jax_paste_rows
from pdae_tpu.utils.image import to_uint8 as jax_to_uint8
from pdae_torch.metrics import mse, ssim
from pdae_torch.sampling import SAMPLERS, BaseSampler
from pdae_torch.utils import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    with sampler_files(tmp_path_factory.mktemp("stack")) as f:
        yield f

def _run_both(name, config, tmp_path, png):
    """The JAX sampler, then the port's on the CPU, each writing ``png`` in
    its own directory; returns (jax result, port result, jax PNG, port PNG)."""
    out = {}
    for who, samplers, kwargs in (("jax", JAX_SAMPLERS, {}), ("port", SAMPLERS,
                                                               {"device": "cpu"})):
        cfg = dict(config, output_path=str(tmp_path / who / png))
        out[who] = samplers[name](cfg, **kwargs).start()
    return (out["jax"], out["port"], read_png(tmp_path / "jax" / png),
            read_png(tmp_path / "port" / png))

# -- the registry and the metrics' sampler --------------------------------- #

def test_the_registry_has_the_nine_jax_samplers():
    assert sorted(SAMPLERS) == sorted(JAX_SAMPLERS)
    assert len(SAMPLERS) == 9


def test_autoencoding_eval_matches_jax(files, tmp_path, monkeypatch):
    """Reconstructions within 1e-2; the port's metrics on the JAX
    reconstructions within 1e-6 of JAX's; and the end metrics within the
    bound those two give: |port(p) - jax(j)| <= |port(p) - jax(p)| +
    |jax(p) - jax(j)|, the first term the metrics' agreement (1e-6, checked
    here on p) and the second what the reconstructions' difference moves
    JAX's own metric by."""
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
    # 5 images in batches of 4: the last batch is padded
    config = dict(files.config, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5",
                  batch_size=4, max_samples=5)
    want = JAX_SAMPLERS["autoencoding_eval"](config).start()
    got = SAMPLERS["autoencoding_eval"](config, device="cpu").start()
    assert sorted(got) == ["mse", "ssim"]
    j, p = ({k: np.concatenate([s[i] for s in seen[who]]) for i, k in enumerate("ab")}
            for who in ("jax", "port"))
    assert j["a"].shape == p["a"].shape == (5, SIZE, SIZE, 3)
    np.testing.assert_array_equal(p["b"], j["b"])
    np.testing.assert_allclose(2 * p["a"] - 1, 2 * j["a"] - 1, rtol=0, atol=1e-2)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    def port_metrics(x):
        return {"ssim": float(ssim(nchw(x["a"]), nchw(x["b"]), size_average=False).double()
                              .mean()),
                "mse": float(mse(x["a"], x["b"]).mean())}

    def jax_metrics(x):
        return {"ssim": float(np.asarray(jax_ssim(jnp.asarray(x["a"]), jnp.asarray(x["b"]),
                                                  size_average=False), np.float64).mean()),
                "mse": float(jax_mse(x["a"], x["b"]).mean())}

    on_jax, jax_on_port = port_metrics(j), jax_metrics(p)
    for k in ("ssim", "mse"):
        assert abs(on_jax[k] - want[k]) <= 1e-6, k
        assert abs(port_metrics(p)[k] - jax_on_port[k]) <= 1e-6, k
        assert abs(got[k] - want[k]) <= 1e-6 + abs(jax_on_port[k] - want[k]), k


def test_infer_latents_files_cross_between_the_packages(files, tmp_path):
    config = dict(files.config, batch_size=4, max_samples=6)
    out = {}
    for who, samplers, kwargs in (("jax", JAX_SAMPLERS, {}), ("port", SAMPLERS,
                                                               {"device": "cpu"})):
        out[who] = samplers["infer_latents"](
            dict(config, output_path=str(tmp_path / f"{who}.ckpt")), **kwargs).start()
    jax_file, port_file = jax_load_checkpoint(out["port"]), load_checkpoint(out["jax"])
    for k in ("mean", "std"):
        assert np.asarray(jax_file[k]).shape == (LATENT,)
        np.testing.assert_allclose(jax_file[k], port_file[k], rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(jax_file[k], load_checkpoint(out["port"])[k])
        np.testing.assert_array_equal(port_file[k], jax_load_checkpoint(out["jax"])[k])


def test_infer_latents_default_path_is_the_dataset_name(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert SAMPLERS["infer_latents"](dict(files.config, max_samples=2),
                                     device="cpu").start() == "./synthetic.ckpt"
    assert load_checkpoint(tmp_path / "synthetic.ckpt")["std"].shape == (LATENT,)


# -- the deterministic samplers --------------------------------------------- #

@pytest.mark.parametrize("name,extra,png", [
    ("interpolation", {"image_index_1": 0, "image_index_2": 1, "ddim_style": "ddim5",
                       "alphas": [0.0, 0.4, 1.0]}, "interp.png"),
    ("manipulation", {"image_index": 2, "encode_ddim_style": "ddim5",
                      "decode_ddim_style": "ddim5", "attribute": "Smiling"}, "manip.png"),
])
def test_deterministic_sampler_matches_jax(files, tmp_path, name, extra, png):
    _, out, want, got = _run_both(name, dict(files.config, **extra), tmp_path, png)
    assert out.endswith(png)
    within_one_level(got, want)


# -- the samplers that draw noise ------------------------------------------- #

def _numpy_draws(monkeypatch):
    """Replace the port's draws with numpy arrays seeded by the salt; the
    arrays drawn, NHWC where they are images, by salt."""
    drawn = {}

    def draw(self, shape, salt, uniform=False):
        rs = np.random.RandomState(1000 + salt)
        a = (rs.uniform(size=shape) if uniform else rs.randn(*shape)).astype(np.float32)
        drawn[salt] = a.transpose(0, 2, 3, 1) if a.ndim == 4 else a
        return torch.from_numpy(a)

    monkeypatch.setattr(BaseSampler, "draw", draw)
    return drawn


def _tiles(png, n, h=SIZE, pad=2):
    """The n tiles of one row of a ``make_grid`` image."""
    return [png[pad:pad + h, pad + i * (h + pad):pad + i * (h + pad) + h] for i in range(n)]


def _grid(images, nrow=None):
    return jax_make_grid(jax_to_uint8(np.asarray(images)), nrow=nrow).astype(int)


def test_autoencoding_example_matches_jax(files, tmp_path, monkeypatch):
    """The deterministic autoencode against the JAX sampler's; the DDIM and
    DDPM rows against the JAX methods fed the port's draws."""
    config = dict(files.config, image_index=3, encoder_ddim_style="ddim5",
                  decoder_ddim_style="ddim5")
    drawn = _numpy_draws(monkeypatch)
    _, _, jax_png, port_png = _run_both("autoencoding_example", config, tmp_path, "ex.png")
    assert port_png.shape == jax_png.shape == (SIZE + 4, 12 * (SIZE + 2) + 2, 3)
    got, want = _tiles(port_png, 12), _tiles(jax_png, 12)
    for i in (0, 1):                      # the image and its autoencode
        within_one_level(got[i], want[i])
    f, gd = jax_fns(files), JaxGaussianDiffusion(DIFFUSION)
    x_0 = jnp.tile(jnp.asarray(port_context.build_dataset(DATASET)[3]["x_0"])[None],
                   (5, 1, 1, 1))
    ddim = jax.jit(lambda x, x_T: gd.representation_learning_ddim_sample(
        "ddim5", f.enc, f.dec, x, x_T))(x_0, drawn[0])
    ddpm = jax.jit(lambda x, x_T, noise: gd.representation_learning_ddpm_sample(
        None, f.enc, f.dec, x, x_T, noise=noise))(
        x_0, drawn[1], jnp.stack([drawn[2 + s] for s in range(STEPS)]))
    assert sorted(drawn) == list(range(2 + STEPS))
    for i, image in enumerate(np.concatenate([jax_to_uint8(np.asarray(ddim)),
                                              jax_to_uint8(np.asarray(ddpm))])):
        within_one_level(got[2 + i], image)


def test_test_dpms_matches_jax_on_the_same_draws(files, tmp_path, monkeypatch):
    drawn = _numpy_draws(monkeypatch)
    config = {"config_path": files.path["dpm.yml"], "checkpoint_path": files.path["dpm.ckpt"],
              "image_size": SIZE, "image_channel": 3, "num_samples": 5, "ddim_style": "ddim5",
              "output_path": str(tmp_path / "dpms.png")}
    assert SAMPLERS["test_dpms"](config, device="cpu").start() == config["output_path"]
    gd, f = JaxGaussianDiffusion(DIFFUSION), jax_fns(files)
    want = jax.jit(lambda x_T: gd.test_pretrained_dpms("ddim5", f.unet, x_T))(drawn[0])
    within_one_level(read_png(config["output_path"]), _grid(want, nrow=3))


def test_denoise_one_step_matches_jax_on_the_same_draws(files, tmp_path, monkeypatch):
    drawn = _numpy_draws(monkeypatch)
    timesteps = [3, 9, 17]
    config = dict(files.config, image_index=4, timestep_list=timesteps,
                  output_path=str(tmp_path / "port.png"))
    SAMPLERS["denoise_one_step"](config, device="cpu").start()
    f = jax_fns(files)
    data = port_context.build_dataset(DATASET)[4]
    x_0 = jnp.tile(jnp.asarray(data["x_0"])[None], (3, 1, 1, 1))
    gd = JaxGaussianDiffusion(DIFFUSION)
    pred, ae_pred = jax.jit(lambda x, noise: gd.representation_learning_denoise_one_step(
        None, f.enc, f.dec, x, timesteps, noise=noise))(x_0, drawn[0])
    jax_paste_rows([np.concatenate([data["gt"][None], jax_to_uint8(np.asarray(a))])
                    for a in (pred, ae_pred)], str(tmp_path / "jax.png"))
    within_one_level(read_png(tmp_path / "port.png"), read_png(tmp_path / "jax.png"))


def test_gap_measure_matches_jax_on_the_same_draws(files, tmp_path, monkeypatch):
    """Two full batches of 2 (5 requested: the full-batch rule takes 4); the
    curves within rtol 1e-4 of the JAX method fed the same uniform noise."""
    drawn = _numpy_draws(monkeypatch)
    config = dict(files.config, batch_size=2, num_samples=5,
                  output_path=str(tmp_path / "gap.png"))
    gap, ae_gap = SAMPLERS["gap_measure"](config, device="cpu").start()
    assert gap.shape == ae_gap.shape == (STEPS,)
    assert os.path.getsize(tmp_path / "gap.png") > 0
    f, gd = jax_fns(files), JaxGaussianDiffusion(DIFFUSION)
    ds = port_context.build_dataset(DATASET)
    gaps = jax.jit(lambda x, noise: gd.representation_learning_gap_measure(
        None, f.enc, f.dec, x, noise=noise))
    want = []
    for start in (0, 2):
        x_0 = jnp.asarray(np.stack([ds[i]["x_0"] for i in (start, start + 1)]))
        noise = jnp.stack([drawn[start * STEPS + s] for s in range(STEPS)])
        want.append([np.asarray(g) for g in gaps(x_0, noise)])
    assert sorted(drawn) == list(range(STEPS)) + list(range(2 * STEPS, 3 * STEPS))
    np.testing.assert_allclose(gap, np.mean([w[0] for w in want], axis=0), rtol=1e-4)
    np.testing.assert_allclose(ae_gap, np.mean([w[1] for w in want], axis=0), rtol=1e-4)


def test_gap_measure_without_matplotlib_writes_the_curves(files, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    config = dict(files.config, batch_size=2, num_samples=2,
                  diffusion_config={"timesteps": 4, "betas_type": "linear"},
                  output_path=str(tmp_path / "gap.png"))
    gap, ae_gap = SAMPLERS["gap_measure"](config, device="cpu").start()
    saved = np.load(tmp_path / "gap.png.npz")
    np.testing.assert_array_equal(saved["gap"], gap)
    np.testing.assert_array_equal(saved["ae_gap"], ae_gap)
    assert gap.shape == (4,) and not os.path.exists(tmp_path / "gap.png")


def test_unconditional_sample_matches_jax_on_the_same_draws(files, tmp_path, monkeypatch):
    """3 samples in batches of 2: the last batch is drawn whole and trimmed."""
    drawn = _numpy_draws(monkeypatch)
    config = dict(files.config, num_samples=3, batch_size=2, latent_ddim_style="ddim5",
                  decoder_ddim_style="ddim5", output_path=str(tmp_path / "uncond.png"))
    SAMPLERS["unconditional_sample"](config, device="cpu").start()
    assert sorted(drawn) == [0, 1, 4, 5]
    f, gd = jax_fns(files), JaxGaussianDiffusion(DIFFUSION)
    generate = jax.jit(lambda x_T, z_T: gd.latent_diffusion_sample(
        None, "ddim5", "ddim5", f.latent, f.dec, x_T, jnp.asarray(files.stats["mean"]),
        jnp.asarray(files.stats["std"]), latent_dim=LATENT, z_T=z_T))
    images = [np.asarray(generate(drawn[2 * done], drawn[2 * done + 1]))[:b]
              for done, b in ((0, 2), (2, 1))]
    within_one_level(read_png(tmp_path / "uncond.png"), _grid(np.concatenate(images)))


@pytest.mark.parametrize("name,extra", [
    ("test_dpms", {"num_samples": 2, "ddim_style": "ddim2"}),
    ("autoencoding_example", {"image_index": 0, "encoder_ddim_style": "ddim2",
                              "decoder_ddim_style": "ddim2",
                              "diffusion_config": {"timesteps": 4, "betas_type": "linear"}}),
    ("denoise_one_step", {"image_index": 0, "timestep_list": [5, 15]}),
    ("gap_measure", {"batch_size": 2, "num_samples": 2,
                     "diffusion_config": {"timesteps": 4, "betas_type": "linear"}}),
    ("unconditional_sample", {"num_samples": 2, "latent_ddim_style": "ddim2",
                              "decoder_ddim_style": "ddim2"}),
])
def test_the_seed_decides_the_draws(files, tmp_path, name, extra):
    """Two runs with one seed write the same bytes (or curves), two seeds
    differ."""
    config = dict(files.config, image_size=SIZE, image_channel=3, **extra)
    if name == "test_dpms":
        config.update(config_path=files.path["dpm.yml"], checkpoint_path=files.path["dpm.ckpt"])

    def run(seed, tag):
        out = SAMPLERS[name](dict(config, seed=seed, output_path=str(tmp_path / tag)),
                             device="cpu").start()
        if name == "gap_measure":
            return np.concatenate(out).tobytes()
        with open(out, "rb") as f:
            return f.read()

    first = run(0, "a.png")
    assert run(0, "b.png") == first
    assert run(1, "c.png") != first
