"""The port's service built from checkpoint files (``PDAEService.from_config``)
and its two CLIs, ``python -m pdae_torch.sample`` and ``python -m
pdae_torch.serve``, on the CPU, on checkpoint files that ``pdae_tpu`` writes
(``tests/_torch_sampler_files.py``).

``from_config`` against ``pdae_tpu.serving.PDAEService`` on the same files:
``encode`` within rtol 1e-4, ``autoencode`` and ``manipulate`` within one
uint8 level (the DDIM encode amplifies a model-level difference, as
``tests/test_torch_serving.py`` says); against the port's in-memory
constructor on the same trees, bit for bit.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_sampler_files import (DIFFUSION, LATENT, LATENT_DPM, SIZE, SMALL_DPM,
                                  read_png, sampler_files, within_one_level)
from pdae_tpu import ops as jax_ops
from pdae_tpu.serving import PDAEService as JaxPDAEService
from pdae_torch import sample, serve
from pdae_torch.sampling import SAMPLERS
from pdae_torch.serving import PDAEService
from pdae_torch.utils import (classifier_state_dict, encoder_state_dict, load_checkpoint,
                              mlp_skip_net_state_dict, unet_state_dict)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    with sampler_files(tmp_path_factory.mktemp("stack")) as f:
        yield f

# -- the service built from files ------------------------------------------ #

@pytest.fixture(scope="module")
def services(files):
    config = dict(files.config, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5",
                  latent_ddim_style="ddim3", encode_ddim_style="ddim5",
                  decode_ddim_style="ddim5")
    return config, PDAEService.from_config(config, device="cpu")


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3), np.uint8)


def test_from_config_serves_the_jax_files_as_the_jax_service(files, services):
    config, port = services
    try:
        jax_service = JaxPDAEService(config)
        images = _images(3)
        np.testing.assert_allclose(port.encode(images), jax_service.encode(images),
                                   rtol=1e-4, atol=1e-5)
        within_one_level(port.autoencode(images), jax_service.autoencode(images))
        within_one_level(port.manipulate(images, attribute="Smiling"),
                         jax_service.manipulate(images, attribute="Smiling"))
    finally:
        # the JAX service pins pdae_tpu's fused-upsample mode for the whole
        # process: put back the default that later tests expect
        jax_ops.set_fused_upsample(None)


def test_from_config_equals_the_in_memory_service_bit_for_bit(files, services):
    config, port = services
    raw = load_checkpoint(files.path["pdae.ckpt"])
    in_memory = PDAEService(
        {**config, "trained_ddpm_config": SMALL_DPM, "diffusion_config": DIFFUSION,
         "encoder_config": {"model": "TinyEncoder", "latent_dim": LATENT},
         "decoder_config": {"latent_dim": LATENT}, "image_size": SIZE,
         "latent_config": LATENT_DPM},
        encoder_state_dict(raw["ema_encoder"]), unet_state_dict(raw["ema_decoder"]),
        device="cpu",
        latent_state=mlp_skip_net_state_dict(
            load_checkpoint(files.path["latent.ckpt"])["ema_latent_denoise_fn"]),
        latent_stats=(files.stats["mean"], files.stats["std"]),
        classifier_state=classifier_state_dict(
            load_checkpoint(files.path["classifier.ckpt"])["ema_classifier"]))
    images = _images(2, seed=1)
    for op in (lambda s: s.encode(images), lambda s: s.autoencode(images),
               lambda s: s.generate(2, seed=0), lambda s: s.manipulate(images, scale=0.3),
               lambda s: s.autoencode(images, "dpm3", "dpm3")):
        np.testing.assert_array_equal(op(port), op(in_memory))


def test_from_config_builds_the_latent_models_at_the_first_op_that_needs_them(files):
    config = dict(files.config, latent_ddim_style="ddim2", decoder_ddim_style="ddim2")
    service = PDAEService.from_config(config, device="cpu")
    assert service._latent_model is None and service._stats is None
    assert service._clf_weight is None
    assert service.generate(1).shape == (1, SIZE, SIZE, 3)
    assert service._latent_model is not None and service._clf_weight is None
    for key, artifact in (("latent_config_path", "latent_config"),
                          ("latent_checkpoint_path", "latent_state"),
                          ("inferred_latents_path", "latent_stats")):
        partial = {k: v for k, v in config.items() if k != key}
        service = PDAEService.from_config(partial, device="cpu")
        service.encode(_images(1))
        with pytest.raises(ValueError, match=f"generate needs {artifact}"):
            service.generate(1)
    partial = {k: v for k, v in config.items() if k != "classifier_checkpoint_path"}
    with pytest.raises(ValueError, match="manipulate needs classifier_state"):
        PDAEService.from_config(partial, device="cpu").manipulate(_images(1))


def test_from_config_refuses_what_the_port_does_not_serve(files):
    # tp and sp serve over a process group they divide (tests/test_torch_tp.py,
    # tests/test_torch_sp.py), never together
    with pytest.raises(ValueError, match="tp_size and sp_size are mutually exclusive"):
        PDAEService.from_config(dict(files.config, tp_size=2, sp_size=2), device="cpu")
    with pytest.raises(ValueError, match="sp_size=2 must divide the device count 1"):
        PDAEService.from_config(dict(files.config, sp_size=2), device="cpu")
    with pytest.raises(ValueError, match="model_size=2 must divide the device count 1"):
        PDAEService.from_config(dict(files.config, tp_size=2), device="cpu")
    with pytest.raises(ValueError, match="fused_upsample"):
        PDAEService.from_config(dict(files.config, fused_upsample="sideways"), device="cpu")
    for mode in ("on", "off", "auto"):
        PDAEService.from_config(dict(files.config, fused_upsample=mode), device="cpu")


def test_no_card_and_no_device_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDAEService.from_config(files.config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SAMPLERS["interpolation"](files.config)


# -- the CLIs ---------------------------------------------------------------- #

def test_sample_cli_runs_a_sampler_and_takes_overrides(files, tmp_path, capsys):
    config_path = tmp_path / "sampler.yml"
    config_path.write_text(json.dumps(files.config))
    out = tmp_path / "cli" / "one_step.png"
    result = sample.main(["--sampler", "denoise_one_step", "--config", str(config_path),
                          "--device", "cpu", "--set", "image_index=1",
                          "--set", f"output_path={out}", "--set", "timestep_list=[2, 12]"])
    assert result == str(out) and os.path.exists(out)
    assert read_png(out).shape == (2 * (SIZE + 4), 3 * (SIZE + 2) + 2, 3)
    assert "denoise_one_step: done" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown sampler"):
        sample.main(["--sampler", "nope", "--config", str(config_path), "--device", "cpu"])


def test_sample_cli_defaults_to_the_card(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config_path = tmp_path / "sampler.yml"
    config_path.write_text(json.dumps(files.config))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(["--sampler", "interpolation", "--config", str(config_path)])


def _b64(image) -> str:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_answers_over_http(files):
    config = dict(files.config, encoder_ddim_style="ddim2", decoder_ddim_style="ddim2")
    server, batcher = serve.make_server(config, "127.0.0.1", 0, 3.0, "cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True, "ops": ["encode", "autoencode",
                                                                  "generate", "manipulate"]}
        images = _images(2, seed=3)
        out = _post(url + "/autoencode", {"images": [_b64(im) for im in images]})
        got = np.stack([serve._png_to_array(b) for b in out["images"]])
        np.testing.assert_array_equal(got, batcher.service.autoencode(images))
        z = _post(url + "/encode", {"images": [_b64(images[0])]})["z"]
        assert np.asarray(z).shape == (1, LATENT)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/generate", {"num_samples": 999})
        assert err.value.code == 400
        assert "max_batch" in json.loads(err.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/nowhere", {})
        assert err.value.code == 404 and json.loads(err.value.read())["error"] == "not found"
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("flag", ["--tp-size", "--sp-size"])
def test_serve_refuses_parallelism_by_name(flag, tmp_path):
    """``--tp-size`` and ``--sp-size`` are taken (they serve under torchrun,
    ``tests/test_torch_tp.py``, ``tests/test_torch_sp.py``): here each gets
    as far as reading the config; both together raise ``pdae_tpu``'s
    ``ValueError`` before the config is read."""
    with pytest.raises(FileNotFoundError):
        serve.main(["--config", str(tmp_path / "missing.yml"), flag, "2"])
    with pytest.raises(ValueError, match="tp_size and sp_size are mutually exclusive"):
        serve.main(["--config", str(tmp_path / "missing.yml"), "--tp-size", "2",
                    "--sp-size", "2"])
