"""The port's ``PDAEService`` against the JAX package's autoencoding on the CPU,
and the rules the port keeps: NHWC in and out, power-of-two buckets, no
silent CPU fallback, no JAX anywhere in ``pdae_torch`` or ``chip_smoke.py``.

The stack is the tiny ShiftUNet (``TINY_DPM``) at 64px with the full-width
64px encoder, on perturbed flax weights carried over by
``pdae_torch.utils.convert``. The convs sum in another order in the two
frameworks, and the DDIM encode amplifies that: reconstructions agree with
JAX's within 1e-2 in [-1, 1] floats (mean under 2e-4), and so at most one
uint8 level apart.

The ops of the latent and manipulation stages (``generate``,
``manipulate``) and the ``CoalescingBatcher`` are held to the service's
rules on a second, cheaper stack (``SMALL_DPM``: attention at 16x16 alone)
with seeded port weights; their numerics are held to the JAX package's in
``tests/test_torch_latent.py``.
"""

import ast
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_tpu.utils.image import from_uint8 as jax_from_uint8
from pdae_tpu.utils.image import to_uint8 as jax_to_uint8
from pdae_torch import serving
from pdae_torch.models import MLPSkipNet, ShiftUNet, build_classifier, encoder_for_resolution
from pdae_torch.serving import CoalescingBatcher, PDAEService
from pdae_torch.utils import (encoder_state_dict, from_uint8, to_uint8,
                              unet_state_dict)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT, SIZE = 16, 64
CONFIG = {
    "trained_ddpm_config": TINY_DPM,
    "decoder_config": {"latent_dim": LATENT},
    "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
    "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
    "image_size": SIZE, "max_batch": 4,
    "encoder_ddim_style": "ddim5", "decoder_ddim_style": "ddim5",
}


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3), np.uint8)


@pytest.fixture(scope="module")
def stack():
    x = jnp.zeros((1, SIZE, SIZE, 3))
    encoder = jax_encoder_for_resolution(SIZE, LATENT)
    decoder = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    enc_params = init_flax(encoder, x, seed=0)
    dec_params = init_flax(decoder, x, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, LATENT)), seed=1)
    service = PDAEService(CONFIG, encoder_state_dict(enc_params),
                          unet_state_dict(dec_params), device="cpu")
    return encoder, decoder, enc_params, dec_params, service


def test_autoencode_matches_jax(stack):
    encoder, decoder, enc_params, dec_params, service = stack
    images = _images(3)
    gd = JaxGaussianDiffusion(CONFIG["diffusion_config"])
    autoencode = jax.jit(lambda x: gd.representation_learning_autoencoding(
        "ddim5", "ddim5", lambda xx: encoder.apply({"params": enc_params}, xx),
        lambda xx, tt, zz: decoder.apply({"params": dec_params}, xx, tt, zz), x))
    want = np.asarray(autoencode(jnp_f32(images.astype(np.float32) / 255.0 * 2.0 - 1.0)))

    x, n = service._to_model_input(images)
    with torch.no_grad():
        got = service.gd.representation_learning_autoencoding(
            "ddim5", "ddim5", service.encoder, service.decoder, x)
    got = service._to_nhwc(got, n)
    # the DDIM encode multiplies a model difference by up to
    # sqrt(1 / abar_t) ~ 158 at t = 999 before the x_0 clamp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.abs(got - want).mean() < 2e-4

    recon = service.autoencode(images)
    assert recon.shape == images.shape and recon.dtype == np.uint8
    assert np.abs(recon.astype(int) - jax_to_uint8(want).astype(int)).max() <= 1


def test_encode_matches_jax(stack):
    encoder, _, enc_params, _, service = stack
    images = _images(2, seed=1)
    want = np.asarray(encoder.apply({"params": enc_params}, jnp_f32(
        images.astype(np.float32) / 255.0 * 2.0 - 1.0)))
    np.testing.assert_allclose(service.encode(images), want, rtol=1e-4, atol=1e-5)


def test_bucket_padding_and_trimming(stack):
    service = stack[-1]
    assert [serving._bucket(n, 4) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert serving._bucket(5, 64) == 8
    images = _images(3, seed=2)
    x, n = service._to_model_input(images)
    assert (n, tuple(x.shape)) == (3, (4, 3, SIZE, SIZE))
    torch.testing.assert_close(x[3], x[0])              # padded with the first image
    z = service.encode(images)
    assert z.shape == (3, LATENT)
    np.testing.assert_allclose(service.encode(images[1:2])[0], z[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="max_batch"):
        service.encode(_images(5))
    with pytest.raises(ValueError, match="empty"):
        service.encode(_images(0))


def test_decode_trims_and_takes_latents(stack):
    service = stack[-1]
    z = np.random.RandomState(3).randn(3, LATENT).astype(np.float32)
    x_T = np.random.RandomState(4).randn(3, SIZE, SIZE, 3).astype(np.float32)
    out = service.decode(z, x_T)
    assert out.shape == (3, SIZE, SIZE, 3) and out.dtype == np.uint8
    with pytest.raises(ValueError, match="latents"):
        service.decode(z[:2], x_T)


def test_service_states_tf32_off(stack):
    service = stack[-1]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    PDAEService(CONFIG, service.encoder.state_dict(), service.decoder.state_dict(),
                device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_no_card_and_no_device_raises(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    service = stack[-1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDAEService(CONFIG, service.encoder.state_dict(), service.decoder.state_dict())


def test_uint8_conversions_match_jax():
    rs = np.random.RandomState(5)
    x = rs.uniform(-1.2, 1.2, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), jax_to_uint8(x))
    u = rs.randint(0, 256, (2, 4, 4, 3), np.uint8)
    np.testing.assert_array_equal(from_uint8(u), jax_from_uint8(u))


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pdae_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "pdae_tpu")
    files = _port_sources()
    assert len(files) > 10 and os.path.exists(files[0])
    for module in ("sampling/context.py", "sampling/samplers.py", "metrics/ssim.py",
                   "metrics/mse.py", "metrics/base.py", "sample.py", "serve.py",
                   "training/resident.py", "training/stage.py", "training/regular.py",
                   "training/latent.py", "training/manipulation.py"):
        assert os.path.join(REPO, "pdae_torch", module) in files, module
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


# -- generate, manipulate and the batcher on a cheaper stack --------------- #

SMALL_DPM = dict(TINY_DPM, base_channel=16, attention_resolutions=(4,))
LATENT_CONFIG = {"model": "CELEBA64LatentDenoiseFn", "input_channel": LATENT,
                 "model_channel": 64, "num_layers": 4}
SMALL_CONFIG = {
    "trained_ddpm_config": SMALL_DPM,
    "decoder_config": {"latent_dim": LATENT},
    "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
    "latent_config": LATENT_CONFIG,
    "image_size": SIZE, "max_batch": 4,
    "encoder_ddim_style": "ddim2", "decoder_ddim_style": "ddim2",
    "latent_ddim_style": "ddim3",
    "encode_ddim_style": "ddim2", "decode_ddim_style": "ddim2",
}


def _small_artifacts(seed=0, zero_row=None):
    torch.manual_seed(seed)
    rs = np.random.RandomState(seed)
    decoder = ShiftUNet(latent_dim=LATENT, **SMALL_DPM)
    with torch.no_grad():                # no zero-init branch stays silent
        for p in decoder.parameters():
            if not p.any():
                p.normal_(std=0.02)
    classifier = build_classifier(40, LATENT)
    if zero_row is not None:
        with torch.no_grad():
            classifier.weight[zero_row] = 0.0
    stats = ((0.1 * rs.randn(1, LATENT)).astype(np.float32),
             rs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32))
    return (encoder_for_resolution(SIZE, LATENT).state_dict(), decoder.state_dict(),
            dict(latent_state=MLPSkipNet(LATENT, 64, 4).state_dict(), latent_stats=stats,
                 classifier_state=classifier.state_dict()))


@pytest.fixture(scope="module")
def small():
    enc, dec, artifacts = _small_artifacts()
    return PDAEService(SMALL_CONFIG, enc, dec, device="cpu", **artifacts)


def test_generate_is_deterministic_per_seed_and_padding_free(small):
    a = small.generate(2, seed=7)
    assert a.shape == (2, SIZE, SIZE, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, small.generate(2, seed=7))
    assert not np.array_equal(a, small.generate(2, seed=8))
    # 3 pads to the bucket of 4: the draws and so the images are the same
    np.testing.assert_array_equal(small.generate(3, seed=7), small.generate(4, seed=7)[:3])
    with pytest.raises(ValueError, match="max_batch"):
        small.generate(5)
    with pytest.raises(ValueError, match="empty"):
        small.generate(0)


def test_manipulate_by_attribute_or_class_id(small):
    images = _images(2, seed=3)
    by_name = small.manipulate(images, attribute="Smiling", scale=0.3)
    assert by_name.shape == images.shape and by_name.dtype == np.uint8
    np.testing.assert_array_equal(by_name, small.manipulate(images, class_id=31, scale=0.3))
    assert not np.array_equal(by_name, small.manipulate(images, class_id=31, scale=0.0))
    with pytest.raises(ValueError, match="unknown attribute"):
        small.manipulate(images, attribute="Grumpy")
    with pytest.raises(ValueError, match="class_id"):
        small.manipulate(images, class_id=40)


def test_a_zero_classifier_row_edits_nothing():
    """The norm's 1e-12 floor: a zero row is a zero edit, not NaN (a NaN
    would raise in the service before it became pixels)."""
    enc, dec, artifacts = _small_artifacts(zero_row=31)
    service = PDAEService(SMALL_CONFIG, enc, dec, device="cpu", **artifacts)
    images = _images(1, seed=4)
    np.testing.assert_array_equal(service.manipulate(images, class_id=31, scale=0.3),
                                  service.manipulate(images, class_id=31, scale=0.0))


def test_a_missing_artifact_raises():
    enc, dec, _ = _small_artifacts()
    config = dict(SMALL_CONFIG)
    del config["latent_config"]
    service = PDAEService(config, enc, dec, device="cpu")
    with pytest.raises(ValueError, match="generate needs latent_config, latent_state, "
                                         "latent_stats"):
        service.generate(1)
    with pytest.raises(ValueError, match="manipulate needs classifier_state, latent_stats"):
        service.manipulate(_images(1))
    assert service.encode(_images(1)).shape == (1, LATENT)


@pytest.mark.parametrize("key", ["tp_size", "sp_size"])
def test_tensor_or_spatial_parallelism_raises(key):
    """Tensor and spatial parallelism serve (``tests/test_torch_tp.py``,
    ``tests/test_torch_sp.py``) over a process group whose world their size
    divides, and one process has a world of one; the two together raise
    ``pdae_tpu``'s ``ValueError`` before either is looked at."""
    enc, dec, _ = _small_artifacts()
    want = {"tp_size": "model_size=2", "sp_size": "sp_size=2"}[key]
    with pytest.raises(ValueError, match=f"{want} must divide the device count 1"):
        PDAEService(dict(SMALL_CONFIG, **{key: 2}), enc, dec, device="cpu")
    with pytest.raises(ValueError, match="tp_size and sp_size are mutually exclusive"):
        PDAEService(dict(SMALL_CONFIG, tp_size=2, sp_size=2), enc, dec, device="cpu")
    PDAEService(dict(SMALL_CONFIG, **{key: 1}), enc, dec, device="cpu")


def test_every_op_takes_dpm_styles(small):
    images = _images(2, seed=5)
    for out in (small.autoencode(images, "dpm2", "dpm2"),
                small.manipulate(images, encode_style="dpm2", decode_style="dpm2"),
                small.generate(2, latent_style="dpm3", decode_style="dpm2"),
                small.decode(np.zeros((2, LATENT), np.float32),
                             np.random.RandomState(0).randn(2, SIZE, SIZE, 3), "dpm2")):
        assert out.shape == images.shape and out.dtype == np.uint8


def test_lazy_builds_run_once(monkeypatch):
    """Threads that reach the first generate at once build the latent
    model once (the build sleeps, so all of them arrive inside it)."""
    enc, dec, artifacts = _small_artifacts()
    service = PDAEService(SMALL_CONFIG, enc, dec, device="cpu", **artifacts)
    builds = []
    real = serving.build_latent_denoise_fn

    def slow_build(config):
        builds.append(config)
        time.sleep(0.2)
        return real(config)

    monkeypatch.setattr(serving, "build_latent_denoise_fn", slow_build)
    got = [None] * 6
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, service._latent()))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and all(g[0] is got[0][0] for g in got)


def test_the_batcher_worker_runs_in_inference_mode(small):
    seen = []
    hook = small.encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.is_inference_mode_enabled()))
    b = CoalescingBatcher(small, window_ms=5.0)
    try:
        out = []
        t = threading.Thread(target=lambda: out.append(b.submit("encode", _images(1))))
        t.start()
        t.join(timeout=60)
        assert out and out[0].shape == (1, LATENT)
    finally:
        b.close()
        hook.remove()
    assert seen == [True]


def test_coalescing_batcher(small):
    """Concurrent submissions coalesce into shared batches: results match
    the direct per-request calls, and the service is called fewer times than
    there were requests."""
    b = CoalescingBatcher(small, window_ms=150.0)
    try:
        reqs = [_images(2, seed=10 + i) for i in range(6)]
        want = [small.encode(r) for r in reqs]
        outs = [None] * len(reqs)
        ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, b.submit("encode", reqs[i]))) for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        for got, exp in zip(outs, want):
            np.testing.assert_allclose(got, exp, atol=1e-5)
        # 12 images in chunks of at most max_batch 4: far fewer calls
        assert b.stats()["calls"] < len(reqs), b.stats()

        # kwargs define the group
        a1 = b.submit("autoencode", _images(1), encode_style="ddim1", decode_style="ddim1")
        assert a1.shape == (1, SIZE, SIZE, 3)
        # an oversized request fails in the worker and re-raises in the caller
        with pytest.raises(ValueError, match="max_batch"):
            b.submit("encode", _images(5))
        np.testing.assert_allclose(b.submit("encode", reqs[0]), want[0], atol=1e-5)
        with pytest.raises(ValueError, match="op must be"):
            b.submit("generate", reqs[0])
        with pytest.raises(TypeError, match="non-hashable"):
            b.submit("encode", reqs[0], attribute=["Male"])
        # uint8 and float inputs never share a batch (dtype in the group key)
        u8 = _images(1, seed=20)
        f32 = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
        outs2 = [None, None]
        ts2 = [threading.Thread(target=lambda i=i, r=r: outs2.__setitem__(
            i, b.submit("encode", r))) for i, r in enumerate((u8, f32))]
        for t in ts2:
            t.start()
        for t in ts2:
            t.join(timeout=60)
        np.testing.assert_allclose(outs2[0], outs2[1], atol=1e-5)
        np.testing.assert_allclose(outs2[0], small.encode(u8), atol=1e-5)
    finally:
        b.close()


def test_batcher_delivers_an_error_to_every_waiter(small):
    b = CoalescingBatcher(small, window_ms=150.0)
    try:
        errors = [None] * 3

        def worker(i):
            try:
                b.submit("autoencode", _images(1, seed=i), encode_style="bogus5")
            except ValueError as e:
                errors[i] = e

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert all(isinstance(e, ValueError) for e in errors), errors
        assert b.stats()["calls"] == 0
    finally:
        b.close()


def test_a_dead_batcher_worker_fails_its_waiters(small, monkeypatch):
    """An interrupt in the worker fails the drained requests, ends the
    worker, and a later submit notices it through the liveness check."""
    class Interrupt(BaseException):
        pass

    def interrupted(op, chunk):
        raise Interrupt()

    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    b = CoalescingBatcher(small, window_ms=5.0)
    monkeypatch.setattr(b, "_run_chunk", interrupted)
    with pytest.raises(RuntimeError, match="interrupted"):
        b.submit("encode", _images(1))
    b._worker.join(timeout=10)
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError, match="worker died"):
        b.submit("encode", _images(1))


def test_batcher_thread_hammer(small):
    """50 concurrent submissions across mixed ops, kwargs and sizes: every
    caller gets its own result back, and no waiter hangs."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b = CoalescingBatcher(small, window_ms=20.0)
    try:
        rs = np.random.RandomState(42)
        jobs = []
        for i in range(50):
            imgs = rs.randint(0, 256, (int(rs.randint(1, 4)), SIZE, SIZE, 3), np.uint8)
            op = "autoencode" if i % 5 == 0 else "encode"
            kwargs = {} if op == "encode" else {"encode_style": "ddim1",
                                                "decode_style": "ddim1"}
            jobs.append((op, imgs, kwargs))
        want = [getattr(small, op)(imgs, **kw) for op, imgs, kw in jobs]
        outs = [None] * len(jobs)
        ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, b.submit(jobs[i][0], jobs[i][1], **jobs[i][2]))) for i in range(len(jobs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        for i, ((op, imgs, kw), got, exp) in enumerate(zip(jobs, outs, want)):
            assert got.shape == exp.shape, (i, op)
            if op == "encode":
                np.testing.assert_allclose(got, exp, atol=1e-4, err_msg=str(i))
            else:
                assert np.abs(got.astype(int) - exp.astype(int)).max() <= 1, i
        assert b.stats()["calls"] < len(jobs)
    finally:
        sys.setswitchinterval(old)
        b.close()
