"""The port's rematerialisation (``runner_config.remat``,
``pdae_torch.training.steps.remat_wrap``) against ``pdae_tpu``'s on the CPU.

For the representation step (``TINY_DPM``'s ShiftUNet and the two-stage
encoder at 16px, latent 16, b4) and the regular step (a two-level UNet of 8
channels, b4), zero-init layers perturbed, from the same params, ``t`` and
noise:

* the port's three modes (none, ``True``, ``"skips"``) give the same loss and
  the same gradient of every trained tensor, bit for bit, at dropout 0 and at
  dropout 0.1 (the global RNG seeded before the step, as the trainers'
  ``seeded`` seeds it: the recompute must draw the forward's masks);
* each mode at dropout 0 agrees with JAX's step under the same mode (the loss
  through ``pdae_tpu.training.steps.remat_wrap``), within the fp32 tolerances
  of ``tests/test_torch_training.py``: loss rtol 1e-5, each gradient within
  1e-4 * (that tensor's max|JAX|) + 1e-8 + 1e-3 * |JAX|;
* the convolutions run per step (forward hooks on every Conv1d and Conv2d,
  the backward's recompute included) order none < skips < full, as
  ``tests/test_training_regular.py`` orders JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32, nchw
from pdae_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.training import partition as jax_partition
from pdae_tpu.training.steps import remat_wrap as jax_remat_wrap
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.models import SemanticEncoder, ShiftUNet, UNet
from pdae_torch.training import (TrainState, make_optimizer, make_regular_train_step,
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.state import flat_params
from pdae_torch.utils import encoder_state_dict, unet_state_dict

torch.set_num_threads(1)
SIZE, BATCH, LATENT = 16, 4, 16
DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}
UNET = dict(input_channel=3, base_channel=8, channel_multiplier=(1, 2),
            num_residual_blocks_of_a_block=1, attention_resolutions=(2,), num_heads=1,
            head_channel=-1, use_new_attention_order=False)
MODES = {"none": None, "full": True, "skips": "skips"}
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 1e-3)       # (atol times the tensor's max|JAX|, rtol)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (BATCH,)).astype(np.int32)
    noise = rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return x, t, noise


class _Representation:
    """The JAX params, the JAX loss under a remat mode, and the port's step."""

    def __init__(self):
        self.encoder = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2)
        self.decoder = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
        x = jnp.zeros((1, SIZE, SIZE, 3))
        enc = init_flax(self.encoder, x, seed=61)
        dec = init_flax(self.decoder, x, jnp.zeros((1,), jnp.int32), jnp.zeros((1, LATENT)),
                        seed=62)
        shift, self.frozen = jax_partition.split_shift_unet(dec)
        self.params = {"encoder": enc, "shift": shift}
        self.batch = _inputs(63)

    def jax_grads(self, mode):
        gd = JaxGaussianDiffusion(DIFFUSION)
        x, t, noise = self.batch
        dec = jax_remat_wrap(lambda frozen, shift, xx, tt, zz: self.decoder.apply(
            {"params": jax_partition.merge_params(frozen, shift)}, xx, tt, zz), mode)

        def loss(p):
            return gd.representation_learning_train_one_batch(
                None, lambda xx: self.encoder.apply({"params": p["encoder"]}, xx),
                lambda xx, tt, zz: dec(self.frozen, p["shift"], xx, tt, zz), jnp_f32(x),
                t=jnp.asarray(t), noise=jnp_f32(noise))["prediction_loss"]

        value, grads = jax.jit(jax.value_and_grad(loss))(self.params)
        grads = jax.device_get(grads)
        sd = {f"encoder.{k}": v for k, v in encoder_state_dict(grads["encoder"]).items()}
        sd.update({f"shift.{k}": v for k, v in unet_state_dict(grads["shift"]).items()})
        return float(value), sd

    def port(self, mode, dropout):
        encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2,
                                  image_size=SIZE)
        decoder = ShiftUNet(latent_dim=LATENT, **{**TINY_DPM, "dropout": dropout})
        encoder.load_state_dict(encoder_state_dict(self.params["encoder"]), strict=True)
        decoder.load_state_dict(unet_state_dict(
            jax_partition.merge_params(self.frozen, self.params["shift"])), strict=True)
        params = trainable_params(encoder, decoder)
        optimizer = make_optimizer({"name": "Adam", "lr": 1e-3}, flat_params(params))
        step = make_representation_train_step(GaussianDiffusion(DIFFUSION), encoder, decoder,
                                               optimizer, device="cpu", remat=mode)
        x, t, noise = self.batch
        return (TrainState.create(params, optimizer), (encoder, decoder),
                lambda ts: step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise)))


class _Regular:

    def __init__(self):
        self.model = JaxUNet(**UNET, dropout=0.0)
        self.params = init_flax(self.model, jnp.zeros((1, SIZE, SIZE, 3)),
                                jnp.zeros((1,), jnp.int32), seed=64)
        self.batch = _inputs(65)

    def jax_grads(self, mode):
        gd = JaxGaussianDiffusion(DIFFUSION)
        x, t, noise = self.batch
        apply = jax_remat_wrap(lambda p, xx, tt, cc: self.model.apply({"params": p}, xx, tt, cc),
                               mode)

        def loss(p):
            return gd.regular_train_one_batch(
                None, lambda xx, tt, cc: apply(p, xx, tt, cc), jnp_f32(x), None,
                t=jnp.asarray(t), noise=jnp_f32(noise))["prediction_loss"]

        value, grads = jax.jit(jax.value_and_grad(loss))(self.params)
        sd = unet_state_dict(jax.device_get(grads))
        return float(value), {f"model.{k}": v for k, v in sd.items()}

    def port(self, mode, dropout):
        model = UNet(**UNET, dropout=dropout)
        model.load_state_dict(unet_state_dict(self.params), strict=True)
        params = {"model": dict(model.named_parameters())}
        optimizer = make_optimizer({"name": "Adam", "lr": 1e-3}, flat_params(params))
        step = make_regular_train_step(GaussianDiffusion(DIFFUSION), model, optimizer,
                                       device="cpu", remat=mode)
        x, t, noise = self.batch
        return (TrainState.create(params, optimizer), (model,),
                lambda ts: step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise)))


@pytest.fixture(scope="module")
def kinds():
    return {"representation": _Representation(), "regular": _Regular()}


def _port_step(kind, mode, dropout, seed=7):
    """One port step under ``mode``: (loss, {name: grad}, conv forwards)."""
    ts, models, run = kind.port(mode, dropout)
    convs = [0]

    def count(*_):
        convs[0] += 1

    handles = [m.register_forward_hook(count) for model in models for m in model.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        loss = run(ts)
    for h in handles:
        h.remove()
    grads = {f"{g}.{k}": p.grad.clone() for g, named in ts.params.items()
             for k, p in named.items()}
    return loss, grads, convs[0]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("name", ["representation", "regular"])
def test_the_three_modes_give_the_same_loss_and_grads(kinds, name, dropout):
    runs = {m: _port_step(kinds[name], mode, dropout) for m, mode in MODES.items()}
    loss, grads, _ = runs["none"]
    assert all(g.abs().max() > 0 for g in grads.values())
    if dropout:      # the masks are drawn: another seed, another loss
        assert not torch.equal(_port_step(kinds[name], None, dropout, seed=8)[0], loss)
    for m in ("full", "skips"):
        assert torch.equal(runs[m][0], loss), m
        for k, g in grads.items():
            assert torch.equal(runs[m][1][k], g), (m, k)


@pytest.mark.parametrize("name", ["representation", "regular"])
def test_conv_forwards_order_none_skips_full(kinds, name):
    counts = {m: _port_step(kinds[name], mode, 0.0)[2] for m, mode in MODES.items()}
    assert counts["none"] < counts["skips"] < counts["full"], counts


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["representation", "regular"])
def test_each_mode_matches_jax_under_the_same_mode(kinds, name, mode):
    kind = kinds[name]
    want_loss, want = kind.jax_grads(MODES[mode])
    loss, grads, _ = _port_step(kind, MODES[mode], 0.0)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL[1],
                                   atol=GRAD_TOL[0] * float(np.abs(w).max()) + 1e-8,
                                   err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chip_smoke_remat_structure_counts_the_calls(kinds, mode, monkeypatch):
    """``chip_smoke.remat_structure``, the launches the card run holds each
    remat mode's step to, against the GN chains and attention blocks the
    representation step runs here (forward hooks, the recompute included;
    the backward chains counted at the GN backward's plain version)."""
    import chip_smoke
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain
    from pdae_torch.ops import groupnorm_train

    kind = kinds["representation"]
    ts, (encoder, decoder), run = kind.port(MODES[mode], 0.0)
    calls = {"attention": 0, "gn_adagn_silu": 0, "gn_adagn_silu_bwd": 0}

    def hook(mod, args):
        calls["gn_adagn_silu" if isinstance(mod, GNSiluChain) else "attention"] += 1

    handles = [m.register_forward_pre_hook(hook) for model in (encoder, decoder)
               for m in model.modules() if isinstance(m, (GNSiluChain, AttentionBlock))]
    plain_bwd = groupnorm_train.gn_adagn_silu_bwd_plain

    def counted_bwd(*args, **kwargs):
        calls["gn_adagn_silu_bwd"] += 1
        return plain_bwd(*args, **kwargs)

    monkeypatch.setattr(groupnorm_train, "gn_adagn_silu_bwd_plain", counted_bwd)
    run(ts)
    for h in handles:
        h.remove()
    assert calls == chip_smoke.remat_structure(encoder, decoder)[mode]


def test_chip_smoke_ffhq_config_is_the_shipped_one():
    """The precision phase's 128px run: ``configs/ffhq_representation_learning.yml``
    (encoder, decoder, batch, optimizer, diffusion) over the
    ``configs/dpm_ffhq.yml`` trunk."""
    yaml = pytest.importorskip("yaml")
    import os

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def shipped(name):
        with open(os.path.join(root, "configs", name)) as f:
            return yaml.safe_load(f)

    want = shipped("ffhq_representation_learning.yml")
    got = chip_smoke.ffhq_config("dpm.yml", "dpm.ckpt", "bfloat16")
    for key in ("encoder_config", "decoder_config", "optimizer_config", "diffusion_config"):
        assert got[key] == want[key], key
    assert (got["dataloader_config"]["train"]["batch_size"]
            == want["dataloader_config"]["train"]["batch_size"])
    for key in ("image_size", "image_channel", "latent_dim"):
        assert got["train_dataset_config"][key] == want["train_dataset_config"][key]
    assert got["runner_config"]["compute_dtype"] == "bfloat16"
    dpm = shipped("dpm_ffhq.yml")["denoise_fn_config"]
    assert {"model": "UNet", **{k: list(v) if isinstance(v, tuple) else v
                                for k, v in chip_smoke.FFHQ_DPM.items()}} == dpm
