"""Train state and optimizer construction: the port of
``pdae_tpu/training/state.py``.

The JAX package advances an immutable pytree (params, EMA params, optax
state); here the modules own the parameters and the step updates them, the
EMA copy and the optimizer's moments **in place**. ``TrainState`` holds
references to the modules' parameters, not copies.

Under FSDP (``training/fsdp.py``) the optimizer and the EMA run on the
plan's ``masters``: this rank's block of each sharded tensor, the one copy
of it the rank holds (its parameter is an empty placeholder between uses),
and the parameter itself where the tensor is whole; without a plan the
masters are the parameters. Under tensor parallelism (``parallel/tp.py``)
the parameters themselves are the rank's tp blocks.

On the card the optimizer is built ``capturable``: its step count lives on
the card and the bias corrections ``1 - beta ** count`` are computed there in
fp32 (as optax computes them), so a train step can be captured into a CUDA
graph (``training/dispatch.py``), and the eager step runs the same kernels,
so both give the same bits. PyTorch runs a capturable Adam on CUDA only: on
the CPU the count stays a host number and the corrections are Python floats
(the path the CPU tests hold to ``pdae_tpu``; the formulation the card takes
is held to it too, ``tests/test_torch_steps_per_dispatch.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.config import parse_adam_betas


def flat_params(params: Dict[str, Dict]) -> list:
    """The tensors of ``{"encoder": {...}, "shift": {...}}`` in a fixed order."""
    return [p for group in params.values() for p in group.values()]


def make_optimizer(optimizer_config: dict, params,
                   capturable=None) -> torch.optim.Optimizer:
    """Adam/AdamW over ``params`` from the reference optimizer_config schema
    (lr / adam_betas / adam_eps / weight_decay / name). ``Adam`` adds the
    weight decay to the gradient (L2), ``AdamW`` decays the weights
    themselves by ``lr * weight_decay``; both as the JAX package configures
    optax. ``capturable`` (None: where the parameters lie on a card) keeps
    the count and the bias corrections on the parameters' device (module
    docstring)."""
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
    params = list(params)
    if capturable is None:
        capturable = bool(params) and params[0].is_cuda
    cls = torch.optim.AdamW if name == "AdamW" else torch.optim.Adam
    return cls(params, lr=lr, betas=betas, eps=eps, weight_decay=wd,
               capturable=bool(capturable))


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Dict]        # {"encoder": {name: Parameter}, "shift": {...}}
    ema_params: Dict[str, Dict]    # EMA of the masters, same keys
    optimizer: torch.optim.Optimizer
    masters: Optional[Dict[str, Dict]] = None   # what Adam updates (module docstring)
    plan: Any = None               # the FSDP plan, None without one
    tp: Any = None                 # the tensor-parallel layout, None without one

    def __post_init__(self):
        if self.masters is None:
            self.masters = self.params

    @classmethod
    def create(cls, params: Dict[str, Dict], optimizer, plan=None, tp=None) -> "TrainState":
        masters = params if plan is None else plan.masters
        ema = {g: {k: p.detach().clone() for k, p in group.items()}
               for g, group in masters.items()}
        return cls(step=0, params=params, ema_params=ema, optimizer=optimizer,
                   masters=masters, plan=plan, tp=tp)

    def _local(self, group: str, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part, shaped as its master, of a whole tensor shaped
        as ``group``/``key``: its tp block, then its FSDP block."""
        part = self._param_part(group, key, whole)
        return part if self.plan is None else self.plan.local(group, key, part)

    def _param_part(self, group: str, key: str, whole: torch.Tensor) -> torch.Tensor:
        """The part of a whole tensor that the parameter ``group``/``key``
        holds: its tp block under tensor parallelism."""
        return whole if self.tp is None else self.tp.local(self.params[group][key], whole)

    def load_converted(self, converted: dict) -> None:
        """Copy a train state carried over by
        ``pdae_torch.utils.convert.train_state_tensors`` (whole tensors): this
        rank's part of it into the masters (the modules' parameters, or
        under FSDP the blocks), the EMA copy and the optimizer's moments."""
        self.step = int(converted["step"])
        with torch.no_grad():
            for group, named in self.params.items():
                if sorted(named) != sorted(converted["params"][group]):
                    raise KeyError(f"{group}: the converted state has other keys")
                for key, p in named.items():
                    m = self.masters[group][key]
                    whole = converted["params"][group][key]
                    if m is p:
                        p.copy_(self._param_part(group, key, whole))
                    else:
                        m.copy_(self._local(group, key, whole))
                    self.ema_params[group][key].copy_(
                        self._local(group, key, converted["ema_params"][group][key]))
                    if "mu" in converted:
                        # a capturable optimizer keeps its count beside the
                        # parameter, the other on the host
                        capturable = self.optimizer.param_groups[0]["capturable"]
                        self.optimizer.state[m] = {
                            "step": torch.tensor(float(converted["count"]),
                                                 device=m.device if capturable else "cpu"),
                            **{name: self._local(group, key, converted[src][group][key]).to(
                                m).clone(memory_format=torch.contiguous_format)
                               for name, src in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}


def accumulate_grads(loss_fn: Callable, params: Sequence[torch.Tensor], x_0,
                     generator, num_iters: int, *, t=None, noise=None, cond=None,
                     draw=None, rows=(0, 1)):
    """Mean (loss, grads) over ``num_iters`` micro-batches, a Python loop
    where the JAX package runs one ``lax.scan``.
    ``loss_fn(x_b, generator, t_b, noise_b) -> scalar``, and with a ``cond``
    (the class labels of a conditional DPM) ``loss_fn(..., cond=cond_b)``;
    injected ``t`` and ``noise`` and the ``cond`` are cut into the same
    micro-batches as ``x_0``.

    ``draw(generator, x_b, n) -> (t, noise)`` (where neither is injected)
    draws a micro-batch's ``t`` and noise here, in the order the loss draws
    them, for the global micro-batch of a data-parallel step: ``rows`` is
    (rank, world), each process draws ``world`` times its micro-batch ``x_b``
    and keeps its own rows ``[rank * mb, (rank + 1) * mb)``, so every
    process cuts one draw that does not depend on the world size, as
    GSPMD's processes compute their rows of one global draw. In one process
    (``(0, 1)``) these are the draws the loss makes itself."""
    rank, world = rows

    def call(cut):
        x_b = x_0[cut]
        t_b = None if t is None else t[cut]
        noise_b = None if noise is None else noise[cut]
        if draw is not None and t is None and noise is None:
            mb = x_b.shape[0]
            t_b, noise_b = draw(generator, x_b, world * mb)
            keep = slice(rank * mb, (rank + 1) * mb)
            t_b, noise_b = t_b[keep], noise_b[keep]
        extra = {} if cond is None else {"cond": cond[cut]}
        return loss_fn(x_b, generator, t_b, noise_b, **extra)

    if num_iters <= 1:
        loss = call(slice(None))
        return loss.detach(), list(torch.autograd.grad(loss, params))
    if x_0.shape[0] % num_iters:
        raise ValueError(f"batch {x_0.shape[0]} does not split into {num_iters} "
                         "micro-batches")
    mb = x_0.shape[0] // num_iters
    total, grads = None, None
    for i in range(num_iters):
        loss = call(slice(i * mb, (i + 1) * mb))
        g = torch.autograd.grad(loss, params)
        if grads is None:
            total, grads = loss.detach(), list(g)
        else:
            total = total + loss.detach()
            for acc, gi in zip(grads, g):
                acc.add_(gi)
    return total / num_iters, [g.div_(num_iters) for g in grads]


def host_copy(tensors: Sequence[torch.Tensor]) -> list:
    """Host copies of ``tensors`` (whole, or a rank's blocks), taken when
    this returns: they go into one flat device buffer, which crosses to the
    host in one copy (pinned on a card); the results are views of it shaped
    as the inputs."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat)
        else:
            host = flat            # torch.cat made a fresh copy
    out, offset = [], 0
    for t in tensors:
        out.append(host[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def adam_moments(optimizer, params: Sequence[torch.Tensor]):
    """(count, exp_avg list, exp_avg_sq list) of ``params`` (the masters:
    under FSDP a rank's blocks); before the first step, count 0 and zeros,
    as optax's fresh state holds."""
    state = optimizer.state
    count = int(next(iter(state.values()))["step"]) if state else 0
    mu = [state[p]["exp_avg"] if p in state else torch.zeros_like(p) for p in params]
    nu = [state[p]["exp_avg_sq"] if p in state else torch.zeros_like(p) for p in params]
    return count, mu, nu


def ema_update(ema: Dict[str, Dict], params: Dict[str, Dict], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, with the float32
    ``decay`` and ``1 - decay`` of the JAX package."""
    d = np.float32(decay)
    keep, take = float(d), float(np.float32(1.0) - d)
    with torch.no_grad():
        for group, named in ema.items():
            for key, e in named.items():
                e.mul_(keep).add_(params[group][key].detach().to(e.dtype), alpha=take)


def ema_due(step: int, every: int) -> bool:
    """Whether the EMA moves after the step whose new count is ``step``
    (``runner_config.ema_every``)."""
    return every <= 1 or step % every == 0


def maybe_ema_update(step: int, ema, params, decay: float, every: int) -> None:
    """EMA applied every ``every`` steps (runner_config.ema_every)."""
    if ema_due(step, every):
        ema_update(ema, params, decay)
