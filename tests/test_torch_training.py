"""The port's representation-learning train step against the JAX package's on
the CPU, from the same converted state, ``t`` and noise.

Geometry: ``TINY_DPM`` ShiftUNet at 16px with a two-stage encoder, latent 16,
batch 4; flax init with the zero-init layers perturbed, so the gradient branch
is not silent. The JAX side is the composition of ``training/steps.py``
(``value_and_grad`` of the same loss, ``tx.update``, ``ema_update``).

Tolerances (fp32, both on the CPU; convolutions and reductions sum in another
order in the two frameworks): loss rtol 1e-5; a gradient within
1e-4 * (that tensor's max|reference|) + 1e-8 + 1e-3 * |reference|, so a tensor
with small gradients is held as tightly as one with large ones (the 1e-8 is
for the few that are zero in exact arithmetic, see below); parameters after
an Adam step of lr 1e-3 within 2e-5; optimizer updates on shared random
gradients rtol 1e-5. The steps run the EMA at decay 0.9, where one step moves
it by a tenth of the parameters' own move (1e-4, far above fp32 rounding of
weights near 1), and the EMA's change since the start is held against the JAX
package's within 2e-6; at the default 0.9999 a step's move would be lost in
that rounding and a step that skipped the EMA would pass.

The steps run Adam with eps 1e-5, not the default 1e-8. Some gradients here
are zero in exact arithmetic (the bias of a conv whose output goes straight
into a GroupNorm with one channel per group) and come out as rounding noise
near 1e-9 that differs between the frameworks; Adam divides by
sqrt(v) + eps, so with the default eps that noise becomes a whole step of
+-lr in both. ``test_optimizer_matches_optax_over_three_updates`` holds the
default and other eps against optax, on shared gradients down to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, jnp_f32, nchw
from pdae_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from pdae_tpu.models import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.training import partition as jax_partition
from pdae_tpu.training import state as jax_state
from pdae_torch.diffusion import GaussianDiffusion
from pdae_torch.models import (FROZEN_PREFIXES, SHIFT_TRAINABLE_PREFIXES,
                               SemanticEncoder, ShiftUNet)
from pdae_torch.training import (TrainState, ema_update, make_optimizer,
                                 make_representation_train_step, maybe_ema_update,
                                 parse_adam_betas, split_shift_unet,
                                 trainable_params)
from pdae_torch.training.state import accumulate_grads, flat_params
from pdae_torch.utils import (encoder_state_dict, train_state_tensors,
                              train_state_trees, unet_state_dict)

torch.set_num_threads(1)
LATENT, SIZE, BATCH = 16, 16, 4
DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}
OPT = {"name": "Adam", "lr": 1e-3, "adam_eps": 1e-5}
EMA_DECAY = 0.9
ZERO_GRAD = 1e-6          # max|gradient| below this: zero in exact arithmetic


def _batch(seed):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = rs.randint(0, 1000, (BATCH,)).astype(np.int32)
    noise = rs.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return x, t, noise


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside an Adam/AdamW (or chained) state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _as_numpy(state):
    adam = _adam_state(state.opt_state)
    get = jax.device_get
    return {"step": int(state.step), "params": get(state.params),
            "ema_params": get(state.ema_params), "mu": get(adam.mu),
            "nu": get(adam.nu), "count": int(adam.count)}


class _Jax:
    """The JAX side: models, params, the loss and one jitted step."""

    def __init__(self):
        self.gd = JaxGaussianDiffusion(DIFFUSION)
        self.encoder = JaxSemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2)
        self.decoder = JaxShiftUNet(latent_dim=LATENT, **TINY_DPM)
        x = jnp.zeros((1, SIZE, SIZE, 3))
        enc = init_flax(self.encoder, x, seed=0)
        dec = init_flax(self.decoder, x, jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, LATENT)), seed=1)
        shift, self.frozen = jax_partition.split_shift_unet(dec)
        self.params = {"encoder": enc, "shift": shift}
        self.tx = jax_state.make_optimizer(OPT)

        def loss_fn(params, x_0, t, noise):
            out = self.gd.representation_learning_train_one_batch(
                None,
                lambda xx: self.encoder.apply({"params": params["encoder"]}, xx),
                lambda xx, tt, zz: self.decoder.apply(
                    {"params": jax_partition.merge_params(self.frozen, params["shift"])},
                    xx, tt, zz),
                x_0, t=t, noise=noise)
            return out["prediction_loss"]

        def step(state, x_0, t, noise):
            loss, grads = jax.value_and_grad(loss_fn)(state.params, x_0, t, noise)
            updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
            params = jax.tree_util.tree_map(jnp.add, state.params, updates)
            ema = jax_state.ema_update(state.ema_params, params, EMA_DECAY)
            return state.replace(step=state.step + 1, params=params, ema_params=ema,
                                 opt_state=opt_state), loss, grads

        self.loss_fn = jax.jit(loss_fn)
        self.step = jax.jit(step)

    def new_state(self):
        return jax_state.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, self.params), self.tx)


@pytest.fixture(scope="module")
def jx():
    return _Jax()


def _port(jx, state=None, num_iters=1):
    """The port's models, state and step, loaded from the JAX params (or from
    a whole JAX train state)."""
    encoder = SemanticEncoder(LATENT, channels=(8, 16), attn_after_stage=2,
                              image_size=SIZE)
    decoder = ShiftUNet(latent_dim=LATENT, **TINY_DPM)
    encoder.load_state_dict(encoder_state_dict(jx.params["encoder"]), strict=True)
    decoder.load_state_dict(
        unet_state_dict(jax_partition.merge_params(jx.frozen, jx.params["shift"])),
        strict=True)
    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer(OPT, flat_params(params))
    ts = TrainState.create(params, optimizer)
    if state is not None:
        ts.load_converted(train_state_tensors(_as_numpy(state)))
    gd = GaussianDiffusion(DIFFUSION)
    step = make_representation_train_step(gd, encoder, decoder, optimizer,
                                          ema_decay=EMA_DECAY, num_iters=num_iters,
                                          device="cpu")
    return encoder, decoder, ts, gd, step


def _assert_groups_close(got_groups, want_trees, atol, rtol=0.0, scaled=False):
    """Port tensors by key against JAX trees carried through the relayout.
    ``scaled``: atol is times that tensor's own max|reference|, plus 1e-8."""
    want = {"encoder": encoder_state_dict(want_trees["encoder"]),
            "shift": unet_state_dict(want_trees["shift"])}
    for group, named in got_groups.items():
        assert sorted(named) == sorted(want[group])
        for key, value in named.items():
            w = want[group][key].numpy()
            a = atol * float(np.abs(w).max()) + 1e-8 if scaled else atol
            np.testing.assert_allclose(value.detach().numpy(), w, rtol=rtol, atol=a,
                                       err_msg=f"{group}.{key}")


def _assert_ema_moved_alike(ts, start, jax_start, jax_state_after):
    """The EMA's change since ``start`` against the JAX package's change."""
    moved = {g: {k: e - start[g][k] for k, e in named.items()}
             for g, named in ts.ema_params.items()}
    want = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                  jax.device_get(jax_state_after.ema_params),
                                  jax.device_get(jax_start))
    _assert_groups_close(moved, want, atol=2e-6)
    sizes = [float(m.abs().max()) for named in moved.values() for m in named.values()]
    assert sum(m > 2e-5 for m in sizes) >= len(sizes) - 7     # ten times the atol


# ---------------------------------------------------------------- (d) loss


def test_q_sample_matches_jax():
    x, t, noise = _batch(0)
    want = JaxGaussianDiffusion(DIFFUSION).q_sample(jnp_f32(x), jnp.asarray(t),
                                                     jnp_f32(noise))
    got = GaussianDiffusion(DIFFUSION).q_sample(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["l1", "l2", "weighted"])
def test_p_loss_matches_jax(kind):
    rs = np.random.RandomState(1)
    a, b = (rs.randn(3, 4, 4, 3).astype(np.float32) for _ in range(2))
    w = rs.rand(3, 1, 1, 1).astype(np.float32) if kind == "weighted" else None
    loss_type = "l1" if kind == "l1" else "l2"
    want = JaxGaussianDiffusion.p_loss(jnp_f32(a), jnp_f32(b),
                                       None if w is None else jnp_f32(w), loss_type)
    got = GaussianDiffusion.p_loss(torch.from_numpy(a), torch.from_numpy(b),
                                   None if w is None else torch.from_numpy(w), loss_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        GaussianDiffusion.p_loss(torch.from_numpy(a), torch.from_numpy(b),
                                 loss_type="huber")


def test_train_one_batch_loss_matches_jax(jx):
    x, t, noise = _batch(2)
    want = jx.loss_fn(jx.params, jnp_f32(x), jnp.asarray(t), jnp_f32(noise))
    encoder, decoder, _, gd, _ = _port(jx)
    with torch.no_grad():
        got = gd.representation_learning_train_one_batch(
            None, encoder, decoder, nchw(x), t=torch.from_numpy(t),
            noise=nchw(noise))["prediction_loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_train_one_batch_draws_from_the_generator(jx):
    encoder, decoder, _, gd, _ = _port(jx)
    x = nchw(_batch(3)[0])
    seen = {}

    def spy_decoder(x_t, t, z):
        seen.update(x_t=x_t, t=t)
        return decoder(x_t, t, z)

    def loss(seed):
        with torch.no_grad():
            return float(gd.representation_learning_train_one_batch(
                torch.Generator().manual_seed(seed), encoder, spy_decoder,
                x)["prediction_loss"])

    first = loss(0)
    assert seen["t"].dtype == torch.int32 and seen["t"].shape == (BATCH,)
    assert 0 <= int(seen["t"].min()) and int(seen["t"].max()) < 1000
    assert seen["x_t"].shape == x.shape
    assert loss(0) == first and loss(1) != first


# ----------------------------------------------------------- (e) optimizer


@pytest.mark.parametrize("config", [
    {"name": "Adam", "lr": 1e-2},
    {"name": "Adam", "lr": 1e-2, "adam_betas": "(0.8, 0.99)", "adam_eps": 1e-6},
    {"name": "Adam", "lr": 1e-2, "weight_decay": 0.1},
    {"name": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
], ids=["adam_defaults", "adam", "adam_l2", "adamw"])
def test_optimizer_matches_optax_over_three_updates(config):
    rs = np.random.RandomState(4)
    p0 = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    # small gradients too: at step 1 sqrt(v) is tiny beside eps
    grads = [{k: (s * rs.randn(*v.shape)).astype(np.float32) for k, v in p0.items()}
             for s in (1.0, 1e-6, 1e-2)]
    tx = jax_state.make_optimizer(config)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    optimizer = make_optimizer(config, tp.values())
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_optimizer_config_parsing():
    assert parse_adam_betas("(0.9, 0.999)") == (0.9, 0.999)
    assert parse_adam_betas([0.5, 0.9]) == (0.5, 0.9)
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="Adam"):
        make_optimizer({"name": "SGD", "lr": 0.1}, p)
    opt = make_optimizer({"lr": 0.1, "adam_betas": "(0.5, 0.9)"}, p)
    assert isinstance(opt, torch.optim.Adam) and not isinstance(opt, torch.optim.AdamW)
    assert opt.defaults["betas"] == (0.5, 0.9) and opt.defaults["weight_decay"] == 0.0


def test_ema_update_matches_jax():
    rs = np.random.RandomState(5)
    e, p = (rs.randn(6, 4).astype(np.float32) for _ in range(2))
    want = jax_state.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.9999)
    ema = {"g": {"w": torch.from_numpy(e.copy())}}
    params = {"g": {"w": torch.nn.Parameter(torch.from_numpy(p.copy()))}}
    ema_update(ema, params, 0.9999)
    np.testing.assert_allclose(ema["g"]["w"].numpy(), np.asarray(want["w"]),
                               rtol=0, atol=1e-7)
    before = ema["g"]["w"].clone()
    maybe_ema_update(3, ema, params, 0.5, every=2)           # not a multiple: kept
    assert torch.equal(ema["g"]["w"], before)
    maybe_ema_update(4, ema, params, 0.5, every=2)
    np.testing.assert_allclose(ema["g"]["w"].numpy(),
                               0.5 * before.numpy() + 0.5 * p, rtol=1e-6)


# ------------------------------------------------------- models and freeze


def test_partition_and_prefixes(jx):
    _, decoder, ts, _, _ = _port(jx)
    named = dict(decoder.named_parameters())
    shift, frozen = split_shift_unet(named)
    assert {k.split(".")[0] for k in shift} == set(SHIFT_TRAINABLE_PREFIXES)
    assert {k.split(".")[0] for k in frozen} == set(FROZEN_PREFIXES)
    assert all(p.requires_grad for p in shift.values())
    assert not any(p.requires_grad for p in frozen.values())
    # the same split as the JAX package's, key for key through the relayout
    assert sorted(shift) == sorted(unet_state_dict(jx.params["shift"]))
    assert sorted(frozen) == sorted(unet_state_dict(jx.frozen))
    assert sorted(ts.params) == ["encoder", "shift"]


def test_trunk_stays_in_eval_mode_whatever_the_caller_asks(jx):
    decoder = ShiftUNet(latent_dim=LATENT, **dict(TINY_DPM, dropout=0.5))
    decoder.train()
    for name in FROZEN_PREFIXES:
        assert not any(m.training for m in getattr(decoder, name).modules()), name
    for name in SHIFT_TRAINABLE_PREFIXES:
        assert all(m.training for m in getattr(decoder, name).modules()), name
    # dropout acts in the shift branch alone: epsilon is repeatable, the
    # gradient is not
    x, t, _ = _batch(6)
    args = (nchw(x), torch.from_numpy(t), torch.randn(BATCH, LATENT))
    for p in decoder.parameters():
        if not p.any():
            torch.nn.init.normal_(p, std=0.05)
    with torch.no_grad():
        eps_1, g_1 = decoder(*args)
        eps_2, g_2 = decoder(*args)
        decoder.eval()
        eps_3, g_3 = decoder(*args)
        _, g_4 = decoder(*args)
    assert torch.equal(eps_1, eps_2) and torch.equal(eps_1, eps_3)
    assert not torch.equal(g_1, g_2) and torch.equal(g_3, g_4)


# ------------------------------------------------------------ (f) the step


def test_one_step_matches_jax(jx):
    x, t, noise = _batch(7)
    state, want_loss, want_grads = jx.step(jx.new_state(), jnp_f32(x), jnp.asarray(t),
                                           jnp_f32(noise))
    _, decoder, ts, _, step = _port(jx)
    start = {g: {k: p.detach().clone() for k, p in named.items()}
             for g, named in ts.params.items()}
    frozen_before = {k: v.clone() for k, v in decoder.state_dict().items()
                     if k not in ts.params["shift"]}
    loss = step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = {g: {k: p.grad for k, p in named.items()} for g, named in ts.params.items()}
    assert all(v is not None for named in grads.values() for v in named.values())
    # no branch is silent: every gradient tensor is live but the few that are
    # zero in exact arithmetic (see the module's docstring), all of them biases
    want = jax.device_get(want_grads)
    sizes = {f"{g}.{k}": float(v.abs().max())
             for g, sd in (("encoder", encoder_state_dict(want["encoder"])),
                           ("shift", unet_state_dict(want["shift"])))
             for k, v in sd.items()}
    dead = [k for k, m in sizes.items() if m < ZERO_GRAD]
    assert len(dead) <= 7 and all(k.endswith(".bias") for k in dead), dead
    assert min(m for k, m in sizes.items() if k not in dead) > 1e-4
    _assert_groups_close(grads, want, atol=1e-4, rtol=1e-3, scaled=True)
    _assert_groups_close(ts.params, jax.device_get(state.params), atol=2e-5)
    _assert_ema_moved_alike(ts, start, jx.params, state)
    assert ts.step == 1
    now = decoder.state_dict()
    assert all(torch.equal(now[k], v) for k, v in frozen_before.items())
    assert len(frozen_before) == len(unet_state_dict(jx.frozen))


def test_three_step_loss_trajectory_matches_jax(jx):
    state = jx.new_state()
    _, _, ts, _, step = _port(jx)
    for i in range(3):
        x, t, noise = _batch(10 + i)
        state, want, _ = jx.step(state, jnp_f32(x), jnp.asarray(t), jnp_f32(noise))
        got = step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise))
        # the parameters drift apart by what test_one_step allows per step
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, err_msg=str(i))
    assert ts.step == 3 == int(state.step)


def test_two_micro_batches_equal_their_mean(jx):
    x, t, noise = _batch(8)
    xt, tt, nt = nchw(x), torch.from_numpy(t), nchw(noise)
    encoder, decoder, ts, gd, _ = _port(jx)
    leaves = flat_params(ts.params)

    def loss_fn(xb, generator, tb, nb):
        return gd.representation_learning_train_one_batch(
            generator, encoder, decoder, xb, t=tb, noise=nb)["prediction_loss"]

    halves = [accumulate_grads(loss_fn, leaves, xt[c], None, 1, t=tt[c], noise=nt[c])
              for c in (slice(0, 2), slice(2, 4))]
    loss, grads = accumulate_grads(loss_fn, leaves, xt, None, 2, t=tt, noise=nt)
    np.testing.assert_allclose(float(loss), (float(halves[0][0]) + float(halves[1][0])) / 2,
                               rtol=1e-6)
    for g, a, b in zip(grads, halves[0][1], halves[1][1]):
        torch.testing.assert_close(g, (a + b) / 2, rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="micro-batches"):
        accumulate_grads(loss_fn, leaves, xt[:3], None, 2, t=tt[:3], noise=nt[:3])
    # and through make_representation_train_step: num_iters=2 is one optimizer step
    _, _, ts2, _, step2 = _port(jx, num_iters=2)
    got = step2(ts2, xt, t=tt, noise=nt)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    assert ts2.step == 1


def test_step_refuses_what_it_cannot_run(jx):
    encoder, decoder, ts, gd, step = _port(jx)
    x = nchw(_batch(9)[0])
    with pytest.raises(ValueError, match="generator"):
        step(ts, x)
    other = make_optimizer(OPT, flat_params(ts.params))
    with pytest.raises(ValueError, match="another optimizer"):
        step(TrainState.create(ts.params, other), x, torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_representation_train_step(gd, encoder, decoder, ts.optimizer)
    loss = step(ts, x, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss)) and ts.step == 1
    assert encoder.training and decoder.training and not decoder.out.training


# ---------------------------------------------------- (g) state conversion


def test_train_state_conversion_round_trip(jx):
    x, t, noise = _batch(11)
    state, _, _ = jx.step(jx.new_state(), jnp_f32(x), jnp.asarray(t), jnp_f32(noise))
    want = _as_numpy(state)
    _, _, ts, _, _ = _port(jx, state=state)
    assert ts.step == 1
    moments = ts.optimizer.state[ts.params["shift"]["label_emb.weight"]]
    assert float(moments["step"]) == 1.0
    back = train_state_trees(ts)
    assert back["step"] == want["step"] and back["count"] == want["count"]
    for name in ("params", "ema_params", "mu", "nu"):
        got_l, want_l = _leaves(back[name]), _leaves(want[name])
        assert sorted(got_l) == sorted(want_l), name
        for k, v in want_l.items():
            np.testing.assert_array_equal(got_l[k], v, err_msg=f"{name}{k}")


def test_both_packages_step_alike_from_a_converted_mid_training_state(jx):
    """Step 2 from the JAX state after step 1 (Adam moments and count carried
    over): the second update uses bias corrections of t = 2 on both sides."""
    x, t, noise = _batch(12)
    state, _, _ = jx.step(jx.new_state(), jnp_f32(x), jnp.asarray(t), jnp_f32(noise))
    _, _, ts, _, step = _port(jx, state=state)
    ema_start = {g: {k: e.clone() for k, e in named.items()}
                 for g, named in ts.ema_params.items()}
    jax_ema_start = state.ema_params
    x, t, noise = _batch(13)
    state, want_loss, _ = jx.step(state, jnp_f32(x), jnp.asarray(t), jnp_f32(noise))
    loss = step(ts, nchw(x), t=torch.from_numpy(t), noise=nchw(noise))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_groups_close(ts.params, jax.device_get(state.params), atol=2e-5)
    _assert_ema_moved_alike(ts, ema_start, jax_ema_start, state)
    assert ts.step == 2
