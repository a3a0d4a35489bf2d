"""The port's regular, latent and manipulation train steps against the JAX
package's on the CPU, from the same converted params, with ``t`` and noise
injected and dropout 0.

* Regular: a two-level UNet of 8 channels at 16px RGB, batch 4, unconditional
  and class-conditional, and conditional over two micro-batches (the JAX side
  runs ``training/state.py::accumulate_grads``, the injected noise and ``t``
  carried through its micro-batching beside x and the class).
* Latent: an MLPSkipNet 16 -> 64 (4 layers) over the two-stage encoder of 8
  and 16 channels, AdamW with weight decay 0.01 as ``celeba64_latent.yml``.
* Manipulation: ``Linear(16, 5)`` over the same encoder, through
  ``pdae_tpu.training.steps.make_manipulation_train_step`` itself.

Each runs 3 steps; every loss is held to the JAX one, and after the first and
the last step every parameter and EMA tensor. Tolerances, fp32: loss rtol
1e-4 / atol 1e-5; parameters and EMA atol 1e-5 (an Adam step of lr 1e-3
moves a weight by about 1e-3, so a wrong gradient or a skipped step is far
outside it). EMA decay 0.9, so one step moves the EMA by a tenth of the
weights' move (at the default 0.9999 a skipped EMA update would pass). Adam
eps 1e-5, not 1e-8: some gradients are zero in exact arithmetic (the bias of
a conv that feeds a GroupNorm with one channel per group) and come out as
rounding noise that differs between the frameworks, which eps 1e-8 would turn
into whole steps of +-lr (``tests/test_torch_training.py`` holds the default
eps to optax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import init_flax, jnp_f32, nchw
from pdae_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import LinearClassifier as JaxLinearClassifier
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.training import state as jax_state
from pdae_tpu.training.steps import (make_manipulation_train_step as
                                     jax_manipulation_step)
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.models import MLPSkipNet, SemanticEncoder, UNet, build_classifier
from pdae_torch.training import (TrainState, make_latent_train_step,
                                 make_manipulation_train_step, make_optimizer,
                                 make_regular_train_step)
from pdae_torch.training.state import flat_params
from pdae_torch.utils import (classifier_state_dict, encoder_state_dict,
                              mlp_skip_net_state_dict, unet_state_dict)

torch.set_num_threads(1)
SIZE, CH, BATCH, LATENT, CLASSES, STEPS = 16, 3, 4, 16, 5, 3
DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}
EMA = 0.9
ADAM = {"name": "Adam", "lr": 1e-3, "adam_eps": 1e-5}
ADAMW = {"name": "AdamW", "lr": 1e-3, "adam_eps": 1e-5, "weight_decay": 0.01}
UNET = dict(input_channel=CH, base_channel=8, channel_multiplier=(1, 2),
            num_residual_blocks_of_a_block=1, attention_resolutions=(2,), num_heads=1,
            head_channel=-1, use_new_attention_order=False, dropout=0.0)
MLP = dict(input_channel=LATENT, model_channel=64, num_layers=4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 1e-5


def _x(rs, n=BATCH):
    return rs.uniform(-1, 1, (n, SIZE, SIZE, CH)).astype(np.float32)


def _port_state(model, sd, opt):
    model.load_state_dict(sd, strict=True)
    params = {"model": dict(model.named_parameters())}
    optimizer = make_optimizer(opt, flat_params(params))
    return TrainState.create(params, optimizer), optimizer


def _assert_state_close(ts, jax_state_now, to_sd):
    """The port's params and EMA against the JAX state's, through the
    relayout of ``to_sd`` (extra names of the state dict are skipped)."""
    for mine, theirs in ((ts.params, jax_state_now.params),
                         (ts.ema_params, jax_state_now.ema_params)):
        want = to_sd(jax.device_get(theirs))
        for k, v in mine["model"].items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def encoder():
    """The two-stage 16px encoder in both packages on the same weights, and
    seeded latent stats."""
    model = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2)
    params = init_flax(model, jnp.zeros((1, SIZE, SIZE, CH)), seed=21)
    port = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2, image_size=SIZE)
    port.load_state_dict(encoder_state_dict(params), strict=True)
    port.requires_grad_(False)
    rs = np.random.RandomState(22)
    mean = (0.1 * rs.randn(1, LATENT)).astype(np.float32)
    std = rs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32)
    return model, params, port.eval(), mean, std


@pytest.mark.parametrize("num_class,num_iters", [(None, 1), (CLASSES, 1), (CLASSES, 2)],
                         ids=["unconditional", "conditional", "conditional_two_micro"])
def test_regular_step_matches_jax(num_class, num_iters):
    model = JaxUNet(**UNET, num_class=num_class)
    x = jnp.zeros((1, SIZE, SIZE, CH))
    zero = jnp.zeros((1,), jnp.int32)
    params = init_flax(model, x, zero, None if num_class is None else zero, seed=23)
    tx = jax_state.make_optimizer(ADAM)
    gd = JaxGaussianDiffusion(DIFFUSION)

    def loss_fn(p, packed, cb, _key):
        # x and noise travel on the channel axis, the class and t side by
        # side, so that accumulate_grads cuts them into the same micro-batches
        x_b, noise_b = packed[..., :CH], packed[..., CH:]
        cond = cb[:, 0] if num_class is not None else None
        return gd.regular_train_one_batch(
            None, lambda xx, tt, cc: model.apply({"params": p}, xx, tt, cc), x_b, cond,
            t=cb[:, 1], noise=noise_b)["prediction_loss"]

    @jax.jit
    def jax_step(state, x_0, noise, t, cond):
        loss, grads = jax_state.accumulate_grads(
            loss_fn, state.params, jnp.concatenate([x_0, noise], -1),
            jax.random.PRNGKey(0), num_iters, cond=jnp.stack([cond, t], 1))
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(jnp.add, state.params, updates)
        ema = jax_state.maybe_ema_update(state.step + 1, state.ema_params, new, EMA, 1)
        return state.replace(step=state.step + 1, params=new, ema_params=ema,
                             opt_state=opt_state), loss

    port = UNet(**UNET, num_class=num_class)
    ts, optimizer = _port_state(port, unet_state_dict(params), ADAM)
    step = make_regular_train_step(GaussianDiffusion(DIFFUSION), port, optimizer,
                                   ema_decay=EMA, num_iters=num_iters, device="cpu")
    js = jax_state.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    rs = np.random.RandomState(24)
    for i in range(STEPS):
        x_0, noise = _x(rs), rs.randn(BATCH, SIZE, SIZE, CH).astype(np.float32)
        t = rs.randint(0, 1000, (BATCH,)).astype(np.int32)
        cond = rs.randint(0, CLASSES, (BATCH,)).astype(np.int32)
        js, want = jax_step(js, jnp_f32(x_0), jnp_f32(noise), jnp.asarray(t),
                            jnp.asarray(cond))
        got = step(ts, nchw(x_0), t=torch.from_numpy(t), noise=nchw(noise),
                   condition=None if num_class is None else torch.from_numpy(cond))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
        if i in (0, STEPS - 1):
            _assert_state_close(ts, js, unet_state_dict)
    assert ts.step == STEPS == int(js.step)


def test_regular_step_takes_uint8_pixels():
    """A ``transfer_uint8`` batch steps as its float normalisation does, bit
    for bit."""
    rs = np.random.RandomState(25)
    pixels = rs.randint(0, 256, (BATCH, SIZE, SIZE, CH)).astype(np.uint8)
    t = torch.from_numpy(rs.randint(0, 1000, (BATCH,)).astype(np.int32))
    noise = nchw(rs.randn(BATCH, SIZE, SIZE, CH).astype(np.float32))
    losses, states = [], []
    for x_0 in (nchw(pixels), nchw(pixels.astype(np.float32) / 255.0 * 2.0 - 1.0)):
        torch.manual_seed(0)
        port = UNet(**UNET)
        ts, optimizer = _port_state(port, port.state_dict(), ADAM)
        step = make_regular_train_step(GaussianDiffusion(DIFFUSION), port, optimizer,
                                       device="cpu")
        losses.append(step(ts, x_0, t=t, noise=noise))
        states.append(ts)
    assert torch.equal(losses[0], losses[1])
    for k, v in states[0].params["model"].items():
        assert torch.equal(v, states[1].params["model"][k]), k


def test_latent_step_matches_jax(encoder):
    jax_enc, enc_params, port_enc, mean, std = encoder
    model = JaxMLPSkipNet(**MLP)
    params = init_flax(model, jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32), seed=26)
    tx = jax_state.make_optimizer(ADAMW)
    gd = JaxGaussianDiffusion(DIFFUSION)

    @jax.jit
    def jax_step(state, x_0, t, noise):
        def loss_fn(p):
            return gd.latent_diffusion_train_one_batch(
                None, lambda z, tt: model.apply({"params": p}, z, tt),
                lambda xx: jax_enc.apply({"params": enc_params}, xx), x_0,
                jnp_f32(mean), jnp_f32(std), t=t, noise=noise)["prediction_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        new = jax.tree_util.tree_map(jnp.add, state.params, updates)
        ema = jax_state.maybe_ema_update(state.step + 1, state.ema_params, new, EMA, 1)
        return state.replace(step=state.step + 1, params=new, ema_params=ema,
                             opt_state=opt_state), loss

    port = MLPSkipNet(**MLP)
    ts, optimizer = _port_state(port, mlp_skip_net_state_dict(params), ADAMW)
    step = make_latent_train_step(GaussianDiffusion(DIFFUSION), port, port_enc, optimizer,
                                  torch.from_numpy(mean), torch.from_numpy(std),
                                  ema_decay=EMA, device="cpu")
    js = jax_state.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    rs = np.random.RandomState(27)
    for i in range(STEPS):
        x_0 = _x(rs)
        t = rs.randint(0, 1000, (BATCH,)).astype(np.int32)
        noise = rs.randn(BATCH, LATENT).astype(np.float32)
        js, want = jax_step(js, jnp_f32(x_0), jnp.asarray(t), jnp_f32(noise))
        got = step(ts, nchw(x_0), t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
        if i in (0, STEPS - 1):
            _assert_state_close(ts, js, mlp_skip_net_state_dict)
    assert port.training and not port_enc.training


def test_manipulation_step_matches_jax(encoder):
    """The step draws nothing, so the whole 3-step trajectory is the JAX
    package's own step on the same batches."""
    jax_enc, enc_params, port_enc, mean, std = encoder
    model = JaxLinearClassifier(num_classes=CLASSES)
    params = init_flax(model, jnp.zeros((1, LATENT)), seed=28)
    tx = jax_state.make_optimizer(ADAM)
    jax_step = jax.jit(jax_manipulation_step(
        JaxGaussianDiffusion(DIFFUSION), model, jax_enc, tx, jnp_f32(mean), jnp_f32(std),
        ema_decay=EMA))
    port = build_classifier(CLASSES, LATENT)
    ts, optimizer = _port_state(port, classifier_state_dict(params), ADAM)
    step = make_manipulation_train_step(GaussianDiffusion(DIFFUSION), port, port_enc,
                                        optimizer, torch.from_numpy(mean),
                                        torch.from_numpy(std), ema_decay=EMA,
                                        device="cpu")
    js = jax_state.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    rs = np.random.RandomState(29)
    for _ in range(STEPS):
        x_0 = _x(rs)
        label = rs.choice([-1, 1], (BATCH, CLASSES)).astype(np.int32)
        js, want = jax_step(js, enc_params, jnp_f32(x_0), jnp.asarray(label))
        got = step(ts, nchw(x_0), torch.from_numpy(label))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
        _assert_state_close(ts, js, classifier_state_dict)


def test_attention_block_keeps_each_saved_activation_once():
    """The regular step is the first to take a whole trunk's gradient through
    attention (the plain autograd backward of ``ops.attention_bwd``): one
    AttentionBlock's forward saves the tokens and their norm (GroupNorm,
    qkv conv), q, k and v once (the attention Function, not the qkv output
    beside them), and the attention's output (proj conv): 6 x C x T values
    an image, besides GroupNorm's mean and rstd and the weights."""
    from pdae_torch.models.blocks import AttentionBlock
    b, c, h, w = 2, 32, 4, 4
    block = AttentionBlock(c, num_heads=2)
    params = {p.data_ptr() for p in block.parameters()}
    saved = []

    def pack(t):
        if t.data_ptr() not in params:
            saved.append((t.untyped_storage().data_ptr(), t.numel()))
        return t

    x = torch.randn(b, c, h, w, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = block(x)
    storages = {}
    for ptr, n in saved:
        storages[ptr] = max(storages.get(ptr, 0), n)
    stats = 2 * b * 32                        # GroupNorm(32)'s mean and rstd
    assert sum(storages.values()) == 6 * b * c * h * w + stats
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
