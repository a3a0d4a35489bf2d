"""The port's latent DPM and manipulation stages against the JAX package's on
the CPU: MLPSkipNet and the linear classifier on the same (perturbed) weights,
their state-dict maps, the latent loops, the loss batches, and
``latent_diffusion_sample`` / ``manipulation_sample`` with z_T and x_T
injected.

Tolerances: MLPSkipNet forward rtol 1e-4 / atol 1e-5 (matmuls sum in another
order); the classifier rtol/atol 1e-5; the latent loops 1e-4 (the unclamped
loop multiplies a model difference by up to sqrt(1 / abar) ~ 55 at the top of
the latent schedule); losses rtol 1e-5. The whole samplers run the shift
decode of the tiny ShiftUNet, whose 5-step trajectories keep one uint8 level:
within 1e-2 in [-1, 1] floats, as ``test_autoencode_matches_jax`` holds the
autoencode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import init_flax, jnp_f32, tiny_shift_decoders
from pdae_tpu.diffusion import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.diffusion import ddim as jax_ddim
from pdae_tpu.diffusion import dpm_solver as jax_dpm
from pdae_tpu.models import LinearClassifier as JaxLinearClassifier
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.utils.image import to_uint8 as jax_to_uint8
from pdae_tpu.utils.torch_convert import (export_classifier_state_dict,
                                          export_mlp_skip_net_state_dict)
from pdae_torch.diffusion import GaussianDiffusion, ddim, dpm_solver
from pdae_torch.models import (MLPSkipNet, SemanticEncoder, build_classifier,
                               build_latent_denoise_fn)
from pdae_torch.utils import (classifier_state_dict, classifier_tree,
                              encoder_state_dict, mlp_skip_net_state_dict,
                              mlp_skip_net_tree, to_uint8)

torch.set_num_threads(1)
LATENT, CLASSES, SIZE = 16, 5, 16
TINY_MLP = dict(input_channel=LATENT, model_channel=64, num_layers=4)
LINEAR = {"timesteps": 1000, "betas_type": "linear"}


@pytest.fixture(scope="module")
def mlp():
    model = JaxMLPSkipNet(**TINY_MLP)
    params = init_flax(model, jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32), seed=7)
    port = MLPSkipNet(**TINY_MLP).eval()
    port.load_state_dict(mlp_skip_net_state_dict(params), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def classifier():
    model = JaxLinearClassifier(num_classes=CLASSES)
    params = init_flax(model, jnp.zeros((1, LATENT)), seed=8)
    port = build_classifier(CLASSES, LATENT).eval()
    port.load_state_dict(classifier_state_dict(params), strict=True)
    return model, params, port


@pytest.fixture(scope="module")
def stack():
    """The tiny 16px encoder and ShiftUNet in both packages (NHWC in and
    out for both), and seeded latent stats."""
    encoder = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2)
    enc_params = init_flax(encoder, jnp.zeros((1, SIZE, SIZE, 3)), seed=9)
    port_encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2,
                                   image_size=SIZE).eval()
    port_encoder.load_state_dict(encoder_state_dict(enc_params), strict=True)
    jax_decoder, port_decoder = tiny_shift_decoders(LATENT)
    rs = np.random.RandomState(10)
    mean = (0.1 * rs.randn(1, LATENT)).astype(np.float32)
    std = rs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32)
    return (lambda x: encoder.apply({"params": enc_params}, x), jax_decoder,
            lambda x: port_encoder(x.permute(0, 3, 1, 2)), port_decoder, mean, std)


# -- the models ------------------------------------------------------------ #

def test_mlp_skip_net_matches_jax(mlp):
    model, params, port = mlp
    rs = np.random.RandomState(0)
    z = rs.randn(4, LATENT).astype(np.float32)
    t = np.array([0, 10, 500, 999], np.int32)
    want = np.asarray(model.apply({"params": params}, jnp_f32(z), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(z), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_mlp_skip_net_state_dict_round_trip(mlp):
    _, params, port = mlp
    sd = mlp_skip_net_state_dict(params)
    want = export_mlp_skip_net_state_dict(params)
    assert sorted(sd) == sorted(want) == sorted(port.state_dict())
    for i in range(TINY_MLP["num_layers"] - 1):
        assert {f"layers.{i}.linear_emb.weight", f"layers.{i}.cond_layers.1.weight"} <= set(sd)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    back = mlp_skip_net_tree(sd)
    flat = jax.tree_util.tree_leaves_with_path
    assert ([p for p, _ in flat(back)] == [p for p, _ in flat(params)])
    for (path, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    sd["layers.0.cond_layers.1.bias"] = sd["layers.0.cond_layers.1.bias"] + 1.0
    with pytest.raises(ValueError, match="differs"):
        mlp_skip_net_tree(sd)


def test_classifier_matches_jax(classifier):
    model, params, port = classifier
    z = np.random.RandomState(1).randn(3, LATENT).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp_f32(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  np.asarray(JaxLinearClassifier.weight({"params": params})))
    sd = classifier_state_dict(params)
    for k, v in export_classifier_state_dict(params).items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    back = classifier_tree(sd)
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back["fc"][leaf], params["fc"][leaf])


def test_latent_denoise_fn_names():
    model = build_latent_denoise_fn({"model": "CELEBA64LatentDenoiseFn", **TINY_MLP})
    assert isinstance(model, MLPSkipNet) and len(model.layers) == 4
    with pytest.raises(KeyError, match="unknown latent"):
        build_latent_denoise_fn({"model": "UNet", **TINY_MLP})


# -- the latent loops ------------------------------------------------------ #

@pytest.mark.parametrize("loop", ["clamped", "unclamped", "dpm"])
def test_latent_loops_match_jax(mlp, loop):
    model, params, port = mlp
    z_T = np.clip(np.random.RandomState(2).randn(3, LATENT), -1, 1).astype(np.float32)
    jax_gd, gd = JaxGaussianDiffusion(LINEAR), GaussianDiffusion(LINEAR)

    def jax_fn(z, t):
        return model.apply({"params": params}, z, t)

    if loop == "dpm":
        jax_run = lambda a: jax_dpm.latent_dpm_solver_sample_loop(
            jax_gd.latent_solver_tables("dpm10"), jax_fn, a)
        run = lambda a: dpm_solver.latent_dpm_solver_sample_loop(
            gd.latent_solver_tables("dpm10"), port, a)
    else:
        jax_loop, port_loop = {
            "clamped": (jax_ddim.latent_ddim_sample_loop, ddim.latent_ddim_sample_loop),
            "unclamped": (jax_ddim.latent_ddim_sample_loop_unclamped,
                          ddim.latent_ddim_sample_loop_unclamped)}[loop]
        jax_run = lambda a: jax_loop(jax_gd.latent_ddim_schedule("ddim10"), jax_fn, a)
        run = lambda a: port_loop(gd.latent_ddim_schedule("ddim10"), port, a)
    want = np.asarray(jax.jit(jax_run)(jnp_f32(z_T)))
    with torch.no_grad():
        got = run(torch.from_numpy(z_T))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_the_unclamped_loop_differs_from_the_clamped_one(mlp):
    port = mlp[2]
    dds = GaussianDiffusion(LINEAR).latent_ddim_schedule("ddim10")
    z_T = torch.from_numpy(np.random.RandomState(3).randn(2, LATENT).astype(np.float32))
    with torch.no_grad():
        a = ddim.latent_ddim_sample_loop(dds, port, z_T)
        b = ddim.latent_ddim_sample_loop_unclamped(dds, port, z_T)
    assert not torch.allclose(a, b)


# -- the loss batches ------------------------------------------------------ #

def test_latent_train_one_batch_matches_jax(mlp, stack):
    model, params, port = mlp
    jax_encoder, _, port_encoder, _, mean, std = stack
    rs = np.random.RandomState(4)
    x_0 = rs.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0, 400, 999], np.int32)
    noise = rs.randn(3, LATENT).astype(np.float32)
    want = JaxGaussianDiffusion(LINEAR).latent_diffusion_train_one_batch(
        None, lambda z, tt: model.apply({"params": params}, z, tt), jax_encoder,
        jnp_f32(x_0), jnp_f32(mean), jnp_f32(std), t=jnp.asarray(t),
        noise=jnp_f32(noise))["prediction_loss"]
    got = GaussianDiffusion(LINEAR).latent_diffusion_train_one_batch(
        None, port, port_encoder, torch.from_numpy(x_0), torch.from_numpy(mean),
        torch.from_numpy(std), t=torch.from_numpy(t),
        noise=torch.from_numpy(noise))["prediction_loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    assert all(p.grad is not None for p in port.parameters())


def test_manipulation_train_one_batch_matches_jax(classifier, stack):
    model, params, port = classifier
    jax_encoder, _, port_encoder, _, mean, std = stack
    rs = np.random.RandomState(5)
    x_0 = rs.uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    label = rs.choice([-1, 1], (4, CLASSES)).astype(np.int32)
    want = JaxGaussianDiffusion(LINEAR).manipulation_train_one_batch(
        lambda z: model.apply({"params": params}, z), jax_encoder, jnp_f32(x_0),
        jnp.asarray(label), jnp_f32(mean), jnp_f32(std))["bce_loss"]
    got = GaussianDiffusion(LINEAR).manipulation_train_one_batch(
        port, port_encoder, torch.from_numpy(x_0), torch.from_numpy(label),
        torch.from_numpy(mean), torch.from_numpy(std))["bce_loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# -- the whole samplers, z_T and x_T injected ------------------------------ #

def _assert_images_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.abs(to_uint8(got).astype(int) - jax_to_uint8(want).astype(int)).max() <= 1


@pytest.mark.parametrize("style", ["ddim5", "dpm5"])
def test_latent_diffusion_sample_matches_jax(mlp, stack, style):
    model, params, port = mlp
    _, jax_decoder, _, port_decoder, mean, std = stack
    rs = np.random.RandomState(6)
    z_T = (1.5 * rs.randn(2, LATENT)).astype(np.float32)     # some outside [-1, 1]
    x_T = rs.randn(2, SIZE, SIZE, 3).astype(np.float32)
    jax_gd = JaxGaussianDiffusion(LINEAR)
    want = np.asarray(jax.jit(lambda a, b: jax_gd.latent_diffusion_sample(
        None, style, style, lambda z, t: model.apply({"params": params}, z, t),
        jax_decoder, a, jnp_f32(mean), jnp_f32(std), latent_dim=LATENT, z_T=b))(
            jnp_f32(x_T), jnp_f32(z_T)))
    with torch.no_grad():
        got = GaussianDiffusion(LINEAR).latent_diffusion_sample(
            None, style, style, port, port_decoder, torch.from_numpy(x_T),
            torch.from_numpy(mean), torch.from_numpy(std), latent_dim=LATENT,
            z_T=torch.from_numpy(z_T))
    _assert_images_close(got.numpy(), want)


@pytest.mark.parametrize("style", ["ddim5", "dpm5"])
def test_manipulation_sample_matches_jax(classifier, stack, style):
    _, params, port = classifier
    jax_encoder, jax_decoder, port_encoder, port_decoder, mean, std = stack
    rs = np.random.RandomState(7)
    x_0 = rs.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    x_T = rs.randn(2, SIZE, SIZE, 3).astype(np.float32)
    weight = JaxLinearClassifier.weight({"params": params})
    jax_gd = JaxGaussianDiffusion(LINEAR)
    want = np.asarray(jax.jit(lambda a, b: jax_gd.manipulation_sample(
        style, weight, jax_encoder, jax_decoder, a, b, jnp_f32(mean), jnp_f32(std),
        3, 0.3))(jnp_f32(x_0), jnp_f32(x_T)))
    with torch.no_grad():
        got = GaussianDiffusion(LINEAR).manipulation_sample(
            style, port.weight, port_encoder, port_decoder, torch.from_numpy(x_0),
            torch.from_numpy(x_T), torch.from_numpy(mean), torch.from_numpy(std), 3, 0.3)
    _assert_images_close(got.numpy(), want)
