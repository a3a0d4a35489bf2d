"""The PDAE train step: the port of
``pdae_tpu/training/steps.py::make_representation_train_step``.

One optimizer step of representation learning: the loss over the encoder and
the shift branch with the frozen trunk in eval mode, its gradients
(accumulated over micro-batches where asked), the configured Adam/AdamW
update and the EMA lerp. Rematerialisation (the JAX ``remat`` argument, used
at 128px) is not ported.
"""

from __future__ import annotations

from .. import resolve_device
from .state import accumulate_grads, flat_params, maybe_ema_update


def make_representation_train_step(gd, encoder, decoder, optimizer,
                                   ema_decay: float = 0.9999, num_iters: int = 1,
                                   device=None, ema_every: int = 1):
    """``step(state, x_0, generator, *, t=None, noise=None) -> loss``.

    ``state`` is a ``TrainState`` over ``trainable_params(encoder, decoder)``
    built with this ``optimizer``; the step updates it, the modules'
    parameters and the optimizer in place and returns the detached loss.
    ``x_0`` is NCHW in [-1, 1]. ``t`` and ``noise`` are drawn from
    ``generator`` unless injected. ``num_iters`` > 1 splits the batch into
    that many micro-batches (the trainer's ``num_iterations``). The EMA moves
    after the steps whose new count is a multiple of ``ema_every``
    (``runner_config.ema_every``; 1: every step). The models must lie on
    ``device``: ``cuda`` unless the caller names another.
    """
    device = resolve_device(device)
    for model in (encoder, decoder):
        for p in model.parameters():
            if p.device.type != device.type:
                raise ValueError(f"the train step runs on {device} but a model "
                                 f"parameter lies on {p.device}")

    def loss_fn(x_b, generator, t, noise):
        return gd.representation_learning_train_one_batch(
            generator, encoder, decoder, x_b, t=t, noise=noise)["prediction_loss"]

    def train_step(state, x_0, generator=None, *, t=None, noise=None):
        if state.optimizer is not optimizer:
            raise ValueError("the state was built with another optimizer")
        if generator is None and (t is None or noise is None):
            raise ValueError("a generator is needed unless t and noise are injected")
        if not (encoder.training and decoder.training):
            encoder.train()
            decoder.train()          # the ShiftUNet keeps its trunk in eval mode
        params = flat_params(state.params)
        loss, grads = accumulate_grads(loss_fn, params, x_0.to(device), generator,
                                       num_iters, t=t, noise=noise)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        maybe_ema_update(state.step + 1, state.ema_params, state.params, ema_decay,
                         ema_every)
        state.step += 1
        return loss

    return train_step
