"""The plain reference of a cell's first train steps: PDAE's loss on the
encoder and the gradient branch over a frozen trunk, gradients by autograd,
Adam and the EMA (fp32, ``ema * decay + param * (1 - decay)`` after every
step), from the weights the benchmark made, on the batches and draws the
trainer takes (``h100_bench.reference.data``).

The batch runs in blocks of rows, each block's share of the mean loss
differentiated and the gradients summed: the loss is a mean over rows that
no layer couples (GroupNorm is per row), so this is the whole batch's
gradient, and a block of rows fits beside the activations' fp32 copies.
"""

from __future__ import annotations

import numpy as np
import torch

from . import data
from .diffusion import loss_tables, representation_loss_sum
from .model import Encoder, ShiftUNet, set_precision
from .precision import PRECISIONS


def build(config: dict, weights: dict, device, precision: str = "fp32"):
    """(encoder, decoder) of ``config`` holding ``weights`` (a state dict
    keyed ``encoder.*`` and ``decoder.*``) on ``device``."""
    enc = Encoder(int(config["image_size"]), int(config["latent_dim"]))
    dec = ShiftUNet(latent_dim=int(config["latent_dim"]), **config["dpm"])
    for prefix, model in (("encoder.", enc), ("decoder.", dec)):
        state = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
        model.load_state_dict(state, strict=True)
        model.to(device)
        set_precision(model, PRECISIONS[precision])
    return enc, dec


def trained_params(enc, dec) -> dict:
    """The trained leaves, keyed as the program's train state keys them
    (``encoder.<name>``, ``shift.<name>``)."""
    out = {f"encoder.{k}": p for k, p in enc.named_parameters()}
    for k, p in dec.named_parameters():
        if k.split(".")[0] in ShiftUNet.TRAINED:
            out[f"shift.{k}"] = p
        else:
            p.requires_grad_(False)
    return out


def train_readings(config: dict, batch: int, weights: dict, seed: int, device,
                   steps: int = 3, precision: str = "fp32", rows: int = None,
                   block: int = 8) -> dict:
    """``steps`` Adam steps at ``batch`` from ``weights``: each step's loss,
    and each trained leaf's first gradient norm and, after the steps, the
    norms of its Adam first moment over ``1 - beta1``, of its change and of
    its EMA's change. ``rows`` keeps only the first rows of each batch (a
    fault's reading)."""
    enc, dec = build(config, weights, device, precision)
    params = trained_params(enc, dec)
    names = list(params)
    leaves = [params[k] for k in names]
    start = [p.detach().clone() for p in leaves]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    ema = [p.detach().clone() for p in leaves]
    decay = np.float32(config["ema_decay"])
    keep, take = float(decay), float(np.float32(1.0) - decay)
    opt = config["optimizer"]
    lr, (b1, b2), eps = float(opt["lr"]), opt["adam_betas"], float(opt["adam_eps"])
    tables = loss_tables(int(config["diffusion"]["timesteps"]))
    size, length = int(config["image_size"]), int(config["dataset_length"])
    losses, grad_norms = [], {}
    for s in range(steps):
        x_0 = data.train_batch(seed, s, batch, length, size).to(device)
        t, noise = data.train_draws(seed, s, x_0.shape, device)
        if rows is not None:
            x_0, t, noise = x_0[:rows], t[:rows], noise[:rows]
        count = x_0.numel()
        grads = [torch.zeros_like(p) for p in leaves]
        total = 0.0
        for i in range(0, x_0.shape[0], block):
            cut = slice(i, i + block)
            part = representation_loss_sum(tables, enc, dec, x_0[cut], t[cut],
                                           noise[cut]) / count
            for acc, g in zip(grads, torch.autograd.grad(part, leaves)):
                acc.add_(g)
            total += float(part.detach().double())
        losses.append(total)
        if s == 0:
            grad_norms = {k: float(g.double().norm()) for k, g in zip(names, grads)}
        with torch.no_grad():
            n = s + 1
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / (1 - b2 ** n) ** 0.5).add_(eps)
                p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** n))
            for e, p in zip(ema, leaves):
                e.mul_(keep).add_(p, alpha=take)
    return {"losses": losses, "grad_norms": grad_norms,
            "moment_norms": {k: float(mi.double().norm()) / (1 - b1)
                             for k, mi in zip(names, m)},
            "delta_norms": {k: float((p.detach() - p0).double().norm())
                            for k, p, p0 in zip(names, leaves, start)},
            "ema_norms": {k: float((e - p0).double().norm())
                          for k, e, p0 in zip(names, ema, start)}}
