"""The port's compute dtype against ``pdae_tpu``'s on the CPU: bf16 compute over
fp32 parameters (``dtype=`` of the models, ``runner_config.compute_dtype`` of
the trainers).

The bound, for every comparison below. On the same inputs and weights let the
control ``c`` be JAX's own bf16-against-fp32 relative L2 distance
(``|a_bf16 - a_fp32| / |a_fp32|``, over the model's output, the loss, or the
flattened tree of gradients or of one Adam step's updates). Then:

* the port's bf16 result lies within ``3 c`` of JAX's bf16 result, in the same
  relative L2, and ``c <= 5e-2`` (bf16 rounding, not a missing or extra cast,
  sets the size of the difference);
* outputs are fp32, parameters and their gradients stay fp32.

A step's loss is one number: its bf16 rounding is a single draw, which can
come out far below the rounding of the values it averages. So the loss is
held to ``3 c`` with ``c`` the larger of its own control and the control of
the same step's gradient tree.

JAX runs its models as its own tests run them on the CPU: the GN chain's
inline composition (``gn_adagn_silu_inline``) and the reference attention.
Geometries: the tiny UNet (8 channels, a class condition), ``TINY_DPM``'s
ShiftUNet and the two-stage encoder at 16px, the shipped 64px and 128px
encoders at b2, an MLPSkipNet 16 -> 64 of 4 layers; zero-init layers
perturbed. The steps run Adam (AdamW for the latent DPM) with eps 1.0, so that
an update is nearly linear in its gradient and the update trees are held like
the gradient trees (at eps 1e-8 a first Adam step is +-lr wherever a gradient
is not tiny, whatever its rounding). Last, a bf16 run of the port resumes bit
for bit, and a ``pdae_tpu`` run at ``compute_dtype: bfloat16`` writes a
checkpoint whose fp32 params the port's bf16 trainer loads bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TINY_DPM, TRAINER_DPM, TRAINER_DS, TRAINER_OPT,
                           TRAINER_RUNNER, assert_trees_bitwise, init_flax, jnp_f32, nchw,
                           nhwc)
from pdae_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_tpu.training import partition as jax_partition
from pdae_tpu.training import state as jax_state
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.models import (MLPSkipNet, SemanticEncoder, ShiftUNet, UNet,
                               encoder_for_resolution)
from pdae_torch.training import (RegularDiffusionTrainer, TrainState, make_latent_train_step,
                                 make_optimizer, make_regular_train_step,
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.state import flat_params
from pdae_torch.utils import (encoder_state_dict, load_checkpoint, mlp_skip_net_state_dict,
                              unet_state_dict)

torch.set_num_threads(1)
FACTOR, C_MAX = 3.0, 5e-2
SIZE, BATCH, LATENT, CLASSES = 16, 2, 16, 5
DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}
UNET = dict(input_channel=3, base_channel=8, channel_multiplier=(1, 2),
            num_residual_blocks_of_a_block=1, attention_resolutions=(2,), num_heads=1,
            head_channel=-1, use_new_attention_order=False, dropout=0.0)
MLP = dict(input_channel=LATENT, model_channel=64, num_layers=4)
ADAM = {"name": "Adam", "lr": 1e-3, "adam_eps": 1.0}
ADAMW = {"name": "AdamW", "lr": 1e-3, "adam_eps": 1.0, "weight_decay": 0.01}


def _flat(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])


def _rel(a, b) -> float:
    a, b = _flat(a), _flat(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_within_control(port_bf16, jax_bf16, jax_fp32, what, floor=0.0):
    """The bound of the module docstring on lists of arrays in one order;
    ``floor``: a control the own one is raised to (the loss's); returns the
    control."""
    c = _rel(jax_bf16, jax_fp32)
    assert 0.0 < c <= C_MAX, (what, c)
    c = max(c, floor)
    got = _rel(port_bf16, jax_bf16)
    assert got <= FACTOR * c, (what, got, c)
    return c


# ---------------------------------------------------------------- models


def _unet():
    model = JaxUNet(**UNET, num_class=CLASSES)
    zero = jnp.zeros((1,), jnp.int32)
    params = init_flax(model, jnp.zeros((1, SIZE, SIZE, 3)), zero, zero, seed=41)
    rs = np.random.RandomState(42)
    x = rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    cond = np.array([1, 4], np.int32)

    def run_jax(dtype):
        m = JaxUNet(**UNET, num_class=CLASSES, dtype=dtype)
        return [jax.jit(m.apply)({"params": params}, x, t, cond)]

    def run_port():
        port = UNet(**UNET, num_class=CLASSES, dtype=torch.bfloat16)
        port.load_state_dict(unet_state_dict(params), strict=True)
        return port, [port(nchw(x), torch.from_numpy(t), torch.from_numpy(cond))]

    return run_jax, run_port


def _shift_unet():
    model = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    params = init_flax(model, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, LATENT)), seed=43)
    rs = np.random.RandomState(44)
    x = rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    z = rs.randn(BATCH, LATENT).astype(np.float32)

    def run_jax(dtype):
        m = JaxShiftUNet(latent_dim=LATENT, dtype=dtype, **TINY_DPM)
        return list(jax.jit(m.apply)({"params": params}, x, t, z))

    def run_port():
        port = ShiftUNet(latent_dim=LATENT, dtype=torch.bfloat16, **TINY_DPM)
        port.load_state_dict(unet_state_dict(params), strict=True)
        return port, list(port(nchw(x), torch.from_numpy(t), torch.from_numpy(z)))

    return run_jax, run_port


def _encoder(size):
    def build():
        model = jax_encoder_for_resolution(size, 512)
        params = init_flax(model, jnp.zeros((1, size, size, 3)), seed=45 + size)
        x = np.random.RandomState(size).uniform(-1, 1, (BATCH, size, size, 3)).astype(
            np.float32)

        def run_jax(dtype):
            m = jax_encoder_for_resolution(size, 512, dtype=dtype)
            return [jax.jit(m.apply)({"params": params}, x)]

        def run_port():
            port = encoder_for_resolution(size, 512, dtype=torch.bfloat16)
            port.load_state_dict(encoder_state_dict(params), strict=True)
            return port, [port(nchw(x))]

        return run_jax, run_port
    return build


def _mlp_skip_net():
    model = JaxMLPSkipNet(**MLP)
    params = init_flax(model, jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32), seed=47)
    rs = np.random.RandomState(48)
    z = rs.randn(4, LATENT).astype(np.float32)
    t = np.array([3, 300, 600, 999], np.int32)

    def run_jax(dtype):
        return [jax.jit(JaxMLPSkipNet(**MLP, dtype=dtype).apply)({"params": params}, z, t)]

    def run_port():
        port = MLPSkipNet(**MLP, dtype=torch.bfloat16)
        port.load_state_dict(mlp_skip_net_state_dict(params), strict=True)
        return port, [port(torch.from_numpy(z), torch.from_numpy(t))]

    return run_jax, run_port


MODELS = {"unet": _unet, "shift_unet": _shift_unet, "encoder64": _encoder(64),
          "encoder128": _encoder(128), "mlp_skip_net": _mlp_skip_net}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_forward_matches_jax_within_its_control(name):
    run_jax, run_port = MODELS[name]()
    want32, want16 = run_jax(jnp.float32), run_jax(jnp.bfloat16)
    assert all(np.asarray(a).dtype == np.float32 for a in want16)
    with torch.no_grad():
        port, got = run_port()
    assert all(g.dtype == torch.float32 for g in got)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = [nhwc(g) if g.dim() == 4 else g.numpy() for g in got]
    assert_within_control(got, want16, want32, name)


def test_fp32_is_the_default_and_leaves_the_graph_as_it_was():
    """A model built without ``dtype`` computes in fp32, and every cast of the
    fp32 path hands back the tensor itself."""
    torch.manual_seed(0)
    model = ShiftUNet(latent_dim=LATENT, **TINY_DPM)
    assert model.dtype == torch.float32
    conv = model.input_blocks[0][0]
    assert conv.compute_dtype == torch.float32
    assert conv.weight.to(conv.compute_dtype) is conv.weight


# ----------------------------------------------------------------- steps


def _encoder_pair(seed):
    model = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2)
    params = init_flax(model, jnp.zeros((1, SIZE, SIZE, 3)), seed=seed)
    return params


def _jax_grads(loss_of, params, dtypes=(jnp.float32, jnp.bfloat16)):
    """loss, grads and one Adam/AdamW update of ``loss_of(dtype)(params)`` at
    each dtype."""
    out = {}
    for dtype in dtypes:
        loss, grads = jax.jit(jax.value_and_grad(loss_of(dtype)))(params)
        out[dtype] = (float(loss), grads)
    return out


def _updates(tx, params, grads):
    updates, _ = tx.update(grads, tx.init(params), params)
    return updates


def _check_step(ts, start, loss, jax_out, tx_config, jax_params, to_sd):
    """The port's loss, gradients (``p.grad``, set by the step) and updates
    against JAX's bf16 ones within their controls; all fp32."""
    tx = jax_state.make_optimizer(tx_config)
    (l32, g32), (l16, g16) = jax_out[jnp.float32], jax_out[jnp.bfloat16]
    params = flat_params(ts.params)
    names = [f"{g}.{k}" for g, named in ts.params.items() for k in named]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params)
    port_grads = dict(zip(names, (p.grad.numpy() for p in params)))
    port_updates = dict(zip(names, ((p - start[n]).detach().numpy()
                                    for n, p in zip(names, params))))
    controls = {}
    for what, mine, want16, want32 in (
            ("grads", port_grads, g16, g32),
            ("updates", port_updates, _updates(tx, jax_params, g16),
             _updates(tx, jax_params, g32))):
        a, b = to_sd(jax.device_get(want16)), to_sd(jax.device_get(want32))
        keys = sorted(a)
        assert sorted(mine) == keys
        controls[what] = assert_within_control(
            [mine[k] for k in keys], [a[k].numpy() for k in keys],
            [b[k].numpy() for k in keys], what)
    assert_within_control([float(loss)], [l16], [l32], "loss", floor=controls["grads"])


def _batch(seed, n=BATCH):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (n,)).astype(np.int32)
    return rs, x, t


def test_representation_step_in_bf16_matches_jax():
    enc_params = _encoder_pair(51)
    decoder = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
    dec_params = init_flax(decoder, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, LATENT)), seed=52)
    shift, frozen = jax_partition.split_shift_unet(dec_params)
    params = {"encoder": enc_params, "shift": shift}
    rs, x, t = _batch(53)
    noise = rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    gd = JaxGaussianDiffusion(DIFFUSION)

    def loss_of(dtype):
        enc = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2, dtype=dtype)
        dec = JaxShiftUNet(latent_dim=LATENT, dtype=dtype, **TINY_DPM)

        def loss(p):
            return gd.representation_learning_train_one_batch(
                None, lambda xx: enc.apply({"params": p["encoder"]}, xx),
                lambda xx, tt, zz: dec.apply(
                    {"params": jax_partition.merge_params(frozen, p["shift"])}, xx, tt, zz),
                jnp_f32(x), t=jnp.asarray(t), noise=jnp_f32(noise))["prediction_loss"]
        return loss

    jax_out = _jax_grads(loss_of, params)
    encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2,
                              image_size=SIZE, dtype=torch.bfloat16)
    port_dec = ShiftUNet(latent_dim=LATENT, dtype=torch.bfloat16, **TINY_DPM)
    encoder.load_state_dict(encoder_state_dict(enc_params), strict=True)
    port_dec.load_state_dict(unet_state_dict(dec_params), strict=True)
    tp = trainable_params(encoder, port_dec)
    optimizer = make_optimizer(ADAM, flat_params(tp))
    ts = TrainState.create(tp, optimizer)
    start = {f"{g}.{k}": p.detach().clone() for g, named in tp.items() for k, p in named.items()}
    step = make_representation_train_step(GaussianDiffusion(DIFFUSION), encoder, port_dec,
                                          optimizer, device="cpu")
    loss = step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise))

    def to_sd(tree):
        sd = {f"encoder.{k}": v for k, v in encoder_state_dict(tree["encoder"]).items()}
        sd.update({f"shift.{k}": v for k, v in unet_state_dict(tree["shift"]).items()})
        return sd

    _check_step(ts, start, loss, jax_out, ADAM, params, to_sd)


def test_regular_step_in_bf16_matches_jax():
    model = JaxUNet(**UNET, num_class=CLASSES)
    zero = jnp.zeros((1,), jnp.int32)
    params = init_flax(model, jnp.zeros((1, SIZE, SIZE, 3)), zero, zero, seed=54)
    rs, x, t = _batch(55)
    noise = rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    cond = rs.randint(0, CLASSES, (BATCH,)).astype(np.int32)
    gd = JaxGaussianDiffusion(DIFFUSION)

    def loss_of(dtype):
        m = JaxUNet(**UNET, num_class=CLASSES, dtype=dtype)

        def loss(p):
            return gd.regular_train_one_batch(
                None, lambda xx, tt, cc: m.apply({"params": p}, xx, tt, cc), jnp_f32(x),
                jnp.asarray(cond), t=jnp.asarray(t), noise=jnp_f32(noise))["prediction_loss"]
        return loss

    jax_out = _jax_grads(loss_of, params)
    port = UNet(**UNET, num_class=CLASSES, dtype=torch.bfloat16)
    port.load_state_dict(unet_state_dict(params), strict=True)
    tp = {"model": dict(port.named_parameters())}
    optimizer = make_optimizer(ADAM, flat_params(tp))
    ts = TrainState.create(tp, optimizer)
    start = {f"model.{k}": p.detach().clone() for k, p in tp["model"].items()}
    step = make_regular_train_step(GaussianDiffusion(DIFFUSION), port, optimizer,
                                   device="cpu")
    loss = step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise),
                condition=torch.from_numpy(cond))

    def to_sd(tree):
        sd = unet_state_dict(tree)
        return {f"model.{k}": v for k, v in sd.items() if k in tp["model"]}

    _check_step(ts, start, loss, jax_out, ADAM, params, to_sd)


def test_latent_step_in_bf16_matches_jax():
    """The MLPSkipNet and the frozen encoder both in bf16, as the latent
    trainer builds them."""
    enc_params = _encoder_pair(56)
    model = JaxMLPSkipNet(**MLP)
    params = init_flax(model, jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32), seed=57)
    rs, x, t = _batch(58, n=4)
    noise = rs.randn(4, LATENT).astype(np.float32)
    mean = (0.1 * rs.randn(1, LATENT)).astype(np.float32)
    std = rs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32)
    gd = JaxGaussianDiffusion(DIFFUSION)

    def loss_of(dtype):
        m = JaxMLPSkipNet(**MLP, dtype=dtype)
        enc = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2, dtype=dtype)

        def loss(p):
            return gd.latent_diffusion_train_one_batch(
                None, lambda z, tt: m.apply({"params": p}, z, tt),
                lambda xx: enc.apply({"params": enc_params}, xx), jnp_f32(x),
                jnp_f32(mean), jnp_f32(std), t=jnp.asarray(t),
                noise=jnp_f32(noise))["prediction_loss"]
        return loss

    jax_out = _jax_grads(loss_of, params)
    encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2,
                              image_size=SIZE, dtype=torch.bfloat16)
    encoder.load_state_dict(encoder_state_dict(enc_params), strict=True)
    encoder.requires_grad_(False)
    port = MLPSkipNet(**MLP, dtype=torch.bfloat16)
    port.load_state_dict(mlp_skip_net_state_dict(params), strict=True)
    tp = {"model": dict(port.named_parameters())}
    optimizer = make_optimizer(ADAMW, flat_params(tp))
    ts = TrainState.create(tp, optimizer)
    start = {f"model.{k}": p.detach().clone() for k, p in tp["model"].items()}
    step = make_latent_train_step(GaussianDiffusion(DIFFUSION), port, encoder.eval(),
                                  optimizer, torch.from_numpy(mean), torch.from_numpy(std),
                                  device="cpu")
    loss = step(ts, nchw(x), t=torch.from_numpy(t), noise=torch.from_numpy(noise))

    def to_sd(tree):
        sd = mlp_skip_net_state_dict(tree)
        return {f"model.{k}": v for k, v in sd.items() if k in tp["model"]}

    _check_step(ts, start, loss, jax_out, ADAMW, params, to_sd)


# --------------------------------------------------------------- trainers


def _regular_cfg(**runner):
    return {"train_dataset_config": dict(TRAINER_DS), "eval_dataset_config": {},
            "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
            "denoise_fn_config": dict(TRAINER_DPM),
            "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                                  "eval": {"num_generations": 2}},
            "optimizer_config": dict(TRAINER_OPT),
            "runner_config": {**TRAINER_RUNNER, "compute_dtype": "bfloat16", **runner}}


def test_bf16_run_resumes_bit_for_bit(tmp_path):
    """3 straight bf16 steps against 2, a resume and 1 more: the same state."""
    cfg = _regular_cfg()
    straight = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "a"),
                                       device="cpu")
    assert straight.model.dtype == torch.bfloat16
    straight.train(max_steps=3)
    first = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "b"), device="cpu")
    first.train(max_steps=2)
    resumed = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "b"),
                                      device="cpu", resume="latest")
    assert resumed.start_step == 2
    resumed.train(max_steps=3)
    assert_trees_bitwise(resumed.state_dict(), straight.state_dict())
    raw = load_checkpoint(str(tmp_path / "b" / "checkpoints" / "latest.ckpt"))
    assert all(np.asarray(a).dtype == np.float32
               for a in jax.tree_util.tree_leaves(raw["denoise_fn"]))


def test_port_bf16_trainer_loads_a_jax_bf16_checkpoint(tmp_path):
    """``pdae_tpu``'s regular trainer at ``compute_dtype: bfloat16`` takes a
    step and saves; the port's bf16 trainer resumes the file with every
    param, EMA and moment bit-equal and fp32, and steps on, finite."""
    from pdae_tpu.training import RegularDiffusionTrainer as JaxRegular
    cfg = _regular_cfg(save_latest_every_steps=1)
    jax_run = JaxRegular(config=copy.deepcopy(cfg), run_path=str(tmp_path / "jax"))
    assert jax_run.model.dtype == jnp.bfloat16
    jax_run.train(max_steps=1)
    path = os.path.join(str(tmp_path / "jax"), "checkpoints", "latest.ckpt")
    raw = load_checkpoint(path)
    port = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "port"),
                                   device="cpu", resume=path)
    assert port.start_step == 1 and port.model.dtype == torch.bfloat16
    state = port.state_dict()
    assert_trees_bitwise({k: state[k] for k in ("denoise_fn", "ema_denoise_fn", "optimizer")},
                         {k: raw[k] for k in ("denoise_fn", "ema_denoise_fn", "optimizer")})
    assert all(p.dtype == torch.float32 for p in port.model.parameters())
    port.train(max_steps=2, save_on_exit=False)
    assert all(torch.isfinite(p).all() for p in port.model.parameters())
