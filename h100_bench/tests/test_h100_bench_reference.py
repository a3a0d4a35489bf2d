"""The plain reference against the port at the toy sizes on the CPU, on the
same seeded weights and inputs: the models, the loss, the solver loops, the
Adam step, and what the reference works out again of the trainer's data and
draws. (The reference itself imports nothing of the port.)"""

from __future__ import annotations

import ast
import os

import numpy as np
import torch

from h100_bench.geometry import geometry
from h100_bench.reference import data, diffusion
from h100_bench.reference.train import build
from h100_bench.tests.toy import SEED, toy_cell
from h100_bench.weights import make_weights, split

ATOL, RTOL = 1e-5, 1e-4          # fp32, two implementations summing in other orders


def _models():
    _, config = toy_cell("celeba64.autoencode")
    geo = geometry(config)
    w = make_weights(geo, SEED, "cpu")
    from pdae_torch.models import build_decoder, build_encoder
    enc = build_encoder(config["encoder_config"], image_size=64)
    dec = build_decoder(config["decoder_config"], config["denoise_fn_config"])
    enc.load_state_dict(split(w, "encoder."), strict=True)
    dec.load_state_dict(split(w, "decoder."), strict=True)
    return config, (enc.eval(), dec.eval()), build(geo, w, "cpu")


def test_reference_imports_nothing_of_the_program():
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference")
    for name in os.listdir(root):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(root, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) and
                        not node.level else [])
                for m in mods:
                    assert m.split(".")[0] not in ("pdae_torch", "pdae_tpu", "jax", "flax")


def test_models_match():
    _, (enc, dec), (renc, rdec) = _models()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    t = torch.tensor([3, 977], dtype=torch.int32)
    with torch.no_grad():
        z, rz = enc(x), renc(x)
        torch.testing.assert_close(rz, z, atol=ATOL, rtol=RTOL)
        for a, b in zip(rdec(x, t, z), dec(x, t, z)):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_loss_matches():
    _, (enc, dec), (renc, rdec) = _models()
    from pdae_torch.diffusion import GaussianDiffusion
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2)) * 2 - 1
    t, noise = data.train_draws(SEED, 0, x.shape, "cpu")
    with torch.no_grad():
        want = gd.representation_learning_train_one_batch(None, enc, dec, x, t=t,
                                                          noise=noise)["prediction_loss"]
        got = diffusion.representation_loss_sum(diffusion.loss_tables(), renc, rdec, x, t,
                                                noise) / x.numel()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_solver_autoencode_matches():
    """The loops on one pair of models: the models match above, and the
    inversion's first steps (sigma_t / sigma_s of 24 at dpm3) magnify their
    last-bit differences past any tolerance a comparison of the two loops
    on two pairs of models could hold."""
    _, (enc, dec), _ = _models()
    from pdae_torch.diffusion import GaussianDiffusion
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        want = gd.representation_learning_autoencoding("dpm3", "dpm4", enc, dec, x)
        got = diffusion.autoencode(enc, dec, x, 3, 4)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_solver_grid_matches():
    from pdae_torch.diffusion import GaussianDiffusion
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    abar = diffusion.linear_alphas_cumprod()
    for n in (3, 20, 100):
        for encode in (False, True):
            tables = gd.solver_tables(f"dpm{n}", direction="encode" if encode else "decode")
            mine = diffusion.solver_steps(abar, n, encode)
            assert [s[0] for s in mine] == tables.t_model.tolist()
            for i, name in enumerate(("sr", "srm1", "sigma_s", "ratio", "acoef", "c2"), 1):
                assert [s[i] for s in mine] == getattr(tables, name).tolist()


def test_adam_matches_torch():
    """The reference's Adam step, as ``train_readings`` writes it, against
    ``torch.optim.Adam`` over three steps."""
    g = torch.Generator().manual_seed(4)
    p = torch.randn(50, generator=g, requires_grad=True)
    mine = p.detach().clone()
    opt = torch.optim.Adam([p], lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    m, v = torch.zeros(50), torch.zeros(50)
    for n in (1, 2, 3):
        grad = torch.randn(50, generator=g)
        p.grad = grad.clone()
        opt.step()
        m.mul_(0.9).add_(grad, alpha=0.1)
        v.mul_(0.999).addcmul_(grad, grad, value=0.001)
        mine.addcdiv_(m, (v.sqrt() / (1 - 0.999 ** n) ** 0.5).add_(1e-8),
                      value=-1e-4 / (1 - 0.9 ** n))
    torch.testing.assert_close(mine, p.detach(), atol=1e-9, rtol=1e-6)


def test_ema_matches_the_port():
    """The reference's EMA, as ``train_readings`` writes it, against the
    port's ``ema_update`` over three steps: bit-equal."""
    from pdae_torch.training.state import ema_update
    g = torch.Generator().manual_seed(6)
    p = torch.randn(50, generator=g) * 0.03
    ema, mine = {"g": {"p": p.clone()}}, p.clone()
    keep, take = float(np.float32(0.9999)), float(np.float32(1.0) - np.float32(0.9999))
    for _ in range(3):
        p = p + 1e-4 * torch.randn(50, generator=g)
        ema_update(ema, {"g": {"p": p}}, 0.9999)
        mine.mul_(keep).add_(p, alpha=take)
    assert torch.equal(mine, ema["g"]["p"])


def test_trainer_data_and_draws_worked_out_again():
    from pdae_torch.data import Loader, build_dataset
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.utils.rng import TRAIN, stream_seed
    ds = build_dataset({"name": "SYNTHETIC", "image_size": 64, "length": 64})
    loader = Loader(ds, batch_size=4, seed=SEED, num_workers=1)
    batch = next(loader.infinite())
    want = torch.from_numpy(batch["x_0"]).permute(0, 3, 1, 2)
    assert torch.equal(data.train_batch(SEED, 0, 4, 64, 64), want)
    assert data.stream_seed(SEED, 1, 5) == stream_seed(SEED, TRAIN, 5)
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    gen = torch.Generator().manual_seed(stream_seed(SEED, TRAIN, 5))
    t, noise = gd.train_draws(gen, 4, (3, 64, 64), want)
    rt, rnoise = data.train_draws(SEED, 5, (4, 3, 64, 64), "cpu")
    assert torch.equal(t, rt) and torch.equal(noise, rnoise)


def test_uint8_round_trip_matches():
    from pdae_torch.utils.image import to_uint8
    x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(5)) * 2.2 - 1.1
    assert np.array_equal(diffusion.to_uint8(x), to_uint8(x.permute(0, 2, 3, 1).numpy()))
