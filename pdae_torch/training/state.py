"""Train state and optimizer construction: the port of
``pdae_tpu/training/state.py``.

The JAX package advances an immutable pytree (params, EMA params, optax
state); here the modules own the parameters and the step updates them, the
EMA copy and the optimizer's moments **in place**. ``TrainState`` holds
references to the modules' parameters, not copies.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch


def parse_adam_betas(value) -> tuple:
    """'(0.9, 0.999)' -> (0.9, 0.999); already-parsed sequences pass through."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    b1, b2 = value
    return (float(b1), float(b2))


def flat_params(params: Dict[str, Dict]) -> list:
    """The tensors of ``{"encoder": {...}, "shift": {...}}`` in a fixed order."""
    return [p for group in params.values() for p in group.values()]


def make_optimizer(optimizer_config: dict, params) -> torch.optim.Optimizer:
    """Adam/AdamW over ``params`` from the reference optimizer_config schema
    (lr / adam_betas / adam_eps / weight_decay / name). ``Adam`` adds the
    weight decay to the gradient (L2), ``AdamW`` decays the weights
    themselves by ``lr * weight_decay``; both as the JAX package configures
    optax."""
    lr = float(optimizer_config["lr"])
    betas = parse_adam_betas(optimizer_config.get("adam_betas", (0.9, 0.999)))
    eps = float(optimizer_config.get("adam_eps", 1e-8))
    wd = float(optimizer_config.get("weight_decay", 0.0))
    name = optimizer_config.get("name", "Adam")
    if name not in ("Adam", "AdamW"):
        # never substitute silently: a typo'd name would train with the
        # wrong optimizer and misattribute the results
        raise ValueError(f"optimizer_config.name must be 'Adam' or 'AdamW', "
                         f"got {name!r}")
    cls = torch.optim.AdamW if name == "AdamW" else torch.optim.Adam
    return cls(list(params), lr=lr, betas=betas, eps=eps, weight_decay=wd)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Dict]        # {"encoder": {name: Parameter}, "shift": {...}}
    ema_params: Dict[str, Dict]    # EMA of the trainable params, same keys
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, params: Dict[str, Dict], optimizer) -> "TrainState":
        ema = {g: {k: p.detach().clone() for k, p in group.items()}
               for g, group in params.items()}
        return cls(step=0, params=params, ema_params=ema, optimizer=optimizer)

    def load_converted(self, converted: dict) -> None:
        """Copy a train state carried over by
        ``pdae_torch.utils.convert.train_state_tensors`` into the modules'
        parameters, the EMA copy and the optimizer's moments."""
        self.step = int(converted["step"])
        with torch.no_grad():
            for group, named in self.params.items():
                if sorted(named) != sorted(converted["params"][group]):
                    raise KeyError(f"{group}: the converted state has other keys")
                for key, p in named.items():
                    p.copy_(converted["params"][group][key])
                    self.ema_params[group][key].copy_(
                        converted["ema_params"][group][key])
                    if "mu" in converted:
                        self.optimizer.state[p] = {
                            "step": torch.tensor(float(converted["count"])),
                            "exp_avg": converted["mu"][group][key].to(p).clone(),
                            "exp_avg_sq": converted["nu"][group][key].to(p).clone()}


def accumulate_grads(loss_fn: Callable, params: Sequence[torch.Tensor], x_0,
                     generator, num_iters: int, *, t=None, noise=None):
    """Mean (loss, grads) over ``num_iters`` micro-batches, a Python loop
    where the JAX package runs one ``lax.scan``.
    ``loss_fn(x_b, generator, t_b, noise_b) -> scalar``; injected ``t`` and
    ``noise`` are cut into the same micro-batches as ``x_0``."""
    if num_iters <= 1:
        loss = loss_fn(x_0, generator, t, noise)
        return loss.detach(), list(torch.autograd.grad(loss, params))
    if x_0.shape[0] % num_iters:
        raise ValueError(f"batch {x_0.shape[0]} does not split into {num_iters} "
                         "micro-batches")
    mb = x_0.shape[0] // num_iters
    total, grads = None, None
    for i in range(num_iters):
        cut = slice(i * mb, (i + 1) * mb)
        loss = loss_fn(x_0[cut], generator, None if t is None else t[cut],
                       None if noise is None else noise[cut])
        g = torch.autograd.grad(loss, params)
        if grads is None:
            total, grads = loss.detach(), list(g)
        else:
            total = total + loss.detach()
            for acc, gi in zip(grads, g):
                acc.add_(gi)
    return total / num_iters, [g.div_(num_iters) for g in grads]


def ema_update(ema: Dict[str, Dict], params: Dict[str, Dict], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, with the float32
    ``decay`` and ``1 - decay`` of the JAX package."""
    d = np.float32(decay)
    keep, take = float(d), float(np.float32(1.0) - d)
    with torch.no_grad():
        for group, named in ema.items():
            for key, e in named.items():
                e.mul_(keep).add_(params[group][key].detach().to(e.dtype), alpha=take)


def maybe_ema_update(step: int, ema, params, decay: float, every: int) -> None:
    """EMA applied every ``every`` steps (runner_config.ema_every)."""
    if every <= 1 or step % every == 0:
        ema_update(ema, params, decay)
