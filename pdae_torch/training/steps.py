"""The train steps of the four stages: the port of
``pdae_tpu/training/steps.py`` and of the regular trainer's step
(``pdae_tpu/training/regular.py``).

Each builder returns ``step(state, x_0, ...) -> loss``: one optimizer step
that updates ``state`` (a ``TrainState`` built with the same optimizer), the
modules' parameters and the optimizer's moments in place and returns the
detached loss. ``x_0`` is NCHW in [-1, 1], or uint8 pixels
(``transfer_uint8``), which the step normalises on the device
(``utils.image.x0_from_transfer``). Where the loss draws ``t`` and noise,
they come from the ``generator`` unless injected. ``num_iters`` > 1 splits
the batch into that many micro-batches (the trainer's ``num_iterations``).
The EMA moves after the steps whose new count is a multiple of
``ema_every`` (``runner_config.ema_every``; 1: every step), or where the
step's ``ema`` argument says so (the two steps a CUDA graph captures,
``training/dispatch.py``). The step does no host synchronisation and
branches on no device value, so it can be captured; the count ``state.step``
is the host's, advanced by one per call. The models must
lie on ``device``: ``cuda`` unless the caller names another. Trained modules
run in train mode (dropout acts where it is configured), frozen ones in eval
mode. ``remat`` (``runner_config.remat``, the JAX steps' argument of that
name) rematerialises the training forward of the decoder or UNet through
``remat_wrap``.

Data-parallel (``rows`` = (rank, world) and ``reduce``, the trainer's
``parallel.mean_all_reducer``): each process draws ``t`` and noise for the
global micro-batch and keeps its rows (``accumulate_grads``), and between the
gradients and the update ``reduce`` averages the gradients and the detached
loss over the processes in one collective, so the step returns the global
batch's loss, as JAX's GSPMD step does; without ``reduce`` (one process) no
collective is issued. Under FSDP ``plan`` (``training/fsdp.py``, the
state's own) takes ``reduce``'s place: the forward and backward run inside
its ``saving()`` (each sharded tensor all-gathered from the blocks at each
use), it reduce-scatters the sharded tensors' gradients into this rank's
blocks and all-reduces the rest with the loss, and Adam and the EMA update
the state's masters, which are the blocks.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .. import resolve_device
from ..utils.image import x0_from_transfer
from .state import accumulate_grads, ema_due, ema_update, flat_params


def _on(device, *models):
    device = resolve_device(device)
    for model in models:
        for p in model.parameters():
            if p.device.type != device.type:
                raise ValueError(f"the train step runs on {device} but a model "
                                 f"parameter lies on {p.device}")
    return device


def remat_wrap(model, mode):
    """``model`` (a UNet or ShiftUNet) as its training forward under
    ``runner_config.remat``, the port of ``pdae_tpu/training/steps.py::
    remat_wrap`` on the models' non-reentrant activation checkpoints (the
    recompute restores the forward's RNG state, so dropout draws the same
    masks): falsy: none; ``"skips"``: the skips kept, as JAX's
    ``save_only_these_names("unet_skip")`` policy keeps them (the ShiftUNet
    recomputes its shift branch alone, the UNet each stage from them); any
    other truthy value: ``"full"`` (the ShiftUNet recomputes its trunk and
    shift branch, which is what JAX's full remat leaves after dead-code
    elimination, the UNet its whole forward)."""
    if not mode:
        return model
    return functools.partial(model, remat="skips" if mode == "skips" else "full")


def _modes(trained=(), frozen=()):
    for m in trained:
        if not m.training:
            m.train()
    for m in frozen:
        if m.training:
            m.eval()


def _saving(plan):
    """The step's forward and backward: inside the FSDP ``plan``'s
    ``saving()``, else as they are."""
    return contextlib.nullcontext() if plan is None else plan.saving()


def _reduced(reduce, plan, loss, grads):
    """The loss and the grads of the state's masters, averaged over the
    processes: by the FSDP ``plan``, or in place by ``reduce`` (both None:
    one process, left as they are)."""
    if plan is not None:
        return plan.reduce_grads(loss, grads)
    if reduce is not None:
        reduce([loss] + list(grads))
    return loss, grads


def _update(state, optimizer, grads, ema_decay, ema_every, ema=None):
    """Adam/AdamW of the masters on ``grads``, then the EMA where ``ema``
    says (None: where it is due at the new count), then the step count."""
    for p, g in zip(flat_params(state.masters), grads):
        p.grad = g
    optimizer.step()
    if ema_due(state.step + 1, ema_every) if ema is None else ema:
        ema_update(state.ema_params, state.masters, ema_decay)
    state.step += 1


def _check_state(state, optimizer, plan):
    if state.optimizer is not optimizer:
        raise ValueError("the state was built with another optimizer")
    if state.plan is not plan:
        raise ValueError("the state was built with another FSDP plan")


def _check(state, optimizer, plan, generator, t, noise):
    _check_state(state, optimizer, plan)
    if generator is None and (t is None or noise is None):
        raise ValueError("a generator is needed unless t and noise are injected")


def _image_draws(gd):
    """``draw`` of ``accumulate_grads`` for the losses whose noise is shaped
    as the images ``x_b``."""
    def draw(generator, x_b, n):
        return gd.train_draws(generator, n, x_b.shape[1:], x_b)
    return draw


def make_representation_train_step(gd, encoder, decoder, optimizer,
                                   ema_decay: float = 0.9999, num_iters: int = 1,
                                   device=None, ema_every: int = 1, remat=False,
                                   rows=(0, 1), reduce=None, plan=None):
    """``step(state, x_0, generator, *, t=None, noise=None, ema=None) ->
    loss``: the PDAE loss over the encoder and the shift branch (``state`` over
    ``trainable_params(encoder, decoder)``), the ShiftUNet's trunk frozen in
    eval mode; ``remat`` checkpoints the decoder's forward (``remat_wrap``);
    ``rows``, ``reduce`` and ``plan`` as the module's docstring says."""
    device = _on(device, encoder, decoder)
    train_decoder = remat_wrap(decoder, remat)

    def loss_fn(x_b, generator, t, noise):
        return gd.representation_learning_train_one_batch(
            generator, encoder, train_decoder, x_b, t=t, noise=noise)["prediction_loss"]

    def train_step(state, x_0, generator=None, *, t=None, noise=None, ema=None):
        _check(state, optimizer, plan, generator, t, noise)
        _modes(trained=(encoder, decoder))   # the ShiftUNet keeps its trunk in eval mode
        params = flat_params(state.params)
        with _saving(plan):
            summed = accumulate_grads(loss_fn, params, x0_from_transfer(x_0.to(device)),
                                      generator, num_iters, t=t, noise=noise,
                                      draw=_image_draws(gd), rows=rows)
        loss, grads = _reduced(reduce, plan, *summed)
        _update(state, optimizer, grads, ema_decay, ema_every, ema)
        return loss

    return train_step


def make_regular_train_step(gd, model, optimizer, ema_decay: float = 0.9999,
                            num_iters: int = 1, device=None, ema_every: int = 1,
                            remat=False, rows=(0, 1), reduce=None, plan=None):
    """``step(state, x_0, generator, *, condition=None, t=None, noise=None,
    ema=None) -> loss``: the epsilon-MSE of a DPM's UNet (``state`` over all its
    parameters); ``condition`` holds the class ids of a class-conditional
    UNet and is cut into the same micro-batches as ``x_0``; ``remat``
    checkpoints the UNet's forward (``remat_wrap``)."""
    device = _on(device, model)
    train_model = remat_wrap(model, remat)

    def loss_fn(x_b, generator, t, noise, cond=None):
        return gd.regular_train_one_batch(generator, train_model, x_b, cond, t=t,
                                          noise=noise)["prediction_loss"]

    def train_step(state, x_0, generator=None, *, condition=None, t=None, noise=None,
                   ema=None):
        _check(state, optimizer, plan, generator, t, noise)
        _modes(trained=(model,))
        params = flat_params(state.params)
        with _saving(plan):
            summed = accumulate_grads(
                loss_fn, params, x0_from_transfer(x_0.to(device)), generator, num_iters,
                t=t, noise=noise, cond=None if condition is None else condition.to(device),
                draw=_image_draws(gd), rows=rows)
        loss, grads = _reduced(reduce, plan, *summed)
        _update(state, optimizer, grads, ema_decay, ema_every, ema)
        return loss

    return train_step


def make_latent_train_step(gd, model, encoder, optimizer, mean, std,
                           ema_decay: float = 0.9999, ema_every: int = 1,
                           num_iters: int = 1, device=None, rows=(0, 1), reduce=None,
                           plan=None):
    """``step(state, x_0, generator, *, t=None, noise=None, ema=None) ->
    loss``: the latent DPM's l1 loss of the MLPSkipNet ``model`` (``state`` over its
    parameters) on the frozen ``encoder``'s z normalised with the inferred
    ``mean``/``std``; with ``IdentityEncoder`` the rows of ``x_0`` are the
    raw z (``latent_train_source: precomputed``)."""
    device = _on(device, model, encoder)
    mean, std = mean.to(device), std.to(device)

    def loss_fn(x_b, generator, t, noise):
        return gd.latent_diffusion_train_one_batch(
            generator, model, encoder, x_b, mean, std, t=t, noise=noise)["prediction_loss"]

    def draw(generator, x_b, n):
        # the noise of the normalised z, (z - mean) / std: fp32, [n, latent]
        return gd.train_draws(generator, n, mean.shape[-1:], mean, latent=True)

    def train_step(state, x_0, generator=None, *, t=None, noise=None, ema=None):
        _check(state, optimizer, plan, generator, t, noise)
        _modes(trained=(model,), frozen=(encoder,))
        params = flat_params(state.params)
        with _saving(plan):
            summed = accumulate_grads(loss_fn, params, x0_from_transfer(x_0.to(device)),
                                      generator, num_iters, t=t, noise=noise, draw=draw,
                                      rows=rows)
        loss, grads = _reduced(reduce, plan, *summed)
        _update(state, optimizer, grads, ema_decay, ema_every, ema)
        return loss

    return train_step


def make_manipulation_train_step(gd, model, encoder, optimizer, mean, std,
                                 ema_decay: float = 0.9999, ema_every: int = 1,
                                 device=None, reduce=None, plan=None):
    """``step(state, x_0, label, *, ema=None) -> loss``: the BCE-with-logits of the linear
    classifier ``model`` (``state`` over its parameters) on the frozen
    ``encoder``'s normalised z against ``label > 0``; it draws nothing."""
    device = _on(device, model, encoder)
    mean, std = mean.to(device), std.to(device)

    def train_step(state, x_0, label, *, ema=None):
        _check_state(state, optimizer, plan)
        _modes(trained=(model,), frozen=(encoder,))
        params = flat_params(state.params)
        with _saving(plan):
            loss = gd.manipulation_train_one_batch(
                model, encoder, x0_from_transfer(x_0.to(device)), label.to(device), mean,
                std)["bce_loss"]
            grads = torch.autograd.grad(loss, params)
        loss, grads = _reduced(reduce, plan, loss.detach(), grads)
        _update(state, optimizer, grads, ema_decay, ema_every, ema)
        return loss

    return train_step
