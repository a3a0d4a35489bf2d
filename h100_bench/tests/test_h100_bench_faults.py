"""The harness with the timed path broken underneath sees ``correct`` come
out false, once for each fault the cell can have (one chip: no exchange
between chips to leave out). Each fault is planted in the program for the
test's process only, at the toy sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench.tests.toy import run_toy


def _state_unchanged(monkeypatch):
    """Every optimizer step returns the state as it found it."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(monkeypatch):
    """The loss over the first half of the batch."""
    from pdae_torch.diffusion import GaussianDiffusion
    orig = GaussianDiffusion.representation_learning_train_one_batch

    def half(self, generator, encoder, decoder, x_0, *, t=None, noise=None):
        h = x_0.shape[0] // 2
        return orig(self, generator, encoder, decoder, x_0[:h], t=t[:h], noise=noise[:h])
    monkeypatch.setattr(GaussianDiffusion, "representation_learning_train_one_batch", half)


def _ema_skipped(monkeypatch):
    """The EMA never moves (the step without it taken for the step with it)."""
    monkeypatch.setattr("pdae_torch.training.steps.ema_update", lambda *a, **k: None)


def _answer_altered(monkeypatch):
    """One image of each answer comes back with a block of pixels changed."""
    from pdae_torch.serving import PDAEService
    orig = PDAEService.autoencode

    def altered(self, images, *args, **kwargs):
        out = orig(self, images, *args, **kwargs).copy()
        out[0, :8, :8] = 255 - out[0, :8, :8]
        return out
    monkeypatch.setattr(PDAEService, "autoencode", altered)


def _serve_half_batch(monkeypatch):
    """Only the first half of the batch is autoencoded, and its answers stand
    in for the rest."""
    from pdae_torch.serving import PDAEService
    orig = PDAEService.autoencode

    def half(self, images, *args, **kwargs):
        out = orig(self, images[:len(images) // 2], *args, **kwargs)
        return np.concatenate([out, out])
    monkeypatch.setattr(PDAEService, "autoencode", half)


@pytest.mark.parametrize("cell, fault", [
    ("ffhq128.train", _state_unchanged), ("ffhq128.train", _train_half_batch),
    ("ffhq128.train", _ema_skipped),
    ("celeba64.autoencode", _answer_altered), ("celeba64.autoencode", _serve_half_batch)],
    ids=["train-state-unchanged", "train-half-batch", "train-ema-skipped",
         "autoencode-answer-altered", "autoencode-half-batch"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run_toy(cell)
    assert result["correct"] is False, result["compared"]
