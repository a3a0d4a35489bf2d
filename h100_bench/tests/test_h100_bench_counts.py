"""The frozen counters against ``torch.utils.flop_counter.FlopCounterMode``
on the same modules at the toy sizes, and at the two configurations'
published widths."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import counts, run
from h100_bench.geometry import geometry
from h100_bench.reference import diffusion
from h100_bench.reference.train import trained_params
from h100_bench.tests.toy import toy_cell
from h100_bench.weights import reference_models


def _measured(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


@pytest.fixture(scope="module")
def geo():
    return geometry(toy_cell("ffhq128.train")[1])


def test_inference_flops(geo):
    enc, dec = reference_models(geo, "cpu")
    x = torch.randn(2, 3, 64, 64)
    t, z = torch.tensor([1, 500], dtype=torch.int32), torch.randn(2, geo["latent_dim"])
    enc_calls, dec_calls = counts.inference_calls(geo, 2)
    with torch.no_grad():
        assert counts.model_flops(enc_calls) == _measured(lambda: enc(x))
        assert counts.model_flops(dec_calls) == _measured(lambda: dec(x, t, z))


def test_train_step_flops(geo):
    enc, dec = reference_models(geo, "cpu")
    leaves = list(trained_params(enc, dec).values())
    x, noise = torch.randn(2, 3, 64, 64), torch.randn(2, 3, 64, 64)
    t = torch.tensor([1, 500], dtype=torch.int32)

    def step():
        loss = diffusion.representation_loss_sum(diffusion.loss_tables(), enc, dec, x, t,
                                                 noise)
        torch.autograd.grad(loss, leaves)
    assert counts.model_flops(counts.train_step_calls(geo, 2)) == _measured(step)


@pytest.mark.parametrize("config, per_image", [
    ("ffhq128", {"enc": 0.6160, "dec": 241.6411, "train": 449.7438}),
    ("celeba64", {"enc": 0.1341, "dec": 104.6480, "train": 196.8928})])
def test_published_widths(config, per_image):
    raw = run.load_json(run.BENCH, "configs", f"{config}.json")
    geo = geometry(raw)
    enc, dec = counts.inference_calls(geo, 1)
    got = {"enc": counts.model_flops(enc), "dec": counts.model_flops(dec),
           "train": counts.model_flops(counts.train_step_calls(geo, 1))}
    for k, v in per_image.items():
        assert got[k] / 1e9 == pytest.approx(v, rel=1e-4)
