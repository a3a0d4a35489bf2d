"""The reference-headline autoencoding program: the port of
``scripts/headline_eval.py``.

The reference's README metric (SSIM 0.994 / MSE 3.84e-5) comes from its
``autoencoding_eval`` sampler: CelebA-HQ images through the FFHQ128
autoencoder, a ``ddim1000`` encode then a ``ddim100`` decode, eval batch 16.
The weights and the LMDB are not in the repository, but the program is: this
module trains the autoencoder briefly on the deterministic ``SYNTHETIC``
corpus, then runs the same eval pattern (styles, batch, geometry) on a
held-out slice of it and reports, per encode+decode style pair, the
throughput and the roundtrip SSIM/MSE; with both default pairs, the
fast-eval trade of ``dpm20+dpm20`` against the reference pattern on the same
model and images.

    python -m pdae_torch.headline_eval --size 128          # on the card
    python -m pdae_torch.headline_eval --size 16 --device cpu --train_steps 4 \\
        --train_batch 8 --eval_batch 8 --eval_n 8 --reps 1 \\
        --styles ddim20+ddim10,dpm5+dpm5 --texture 0.15

The data and the draws are the JAX script's: the same corpus indices and
texture noise (numpy), the train batches drawn from ``RandomState(0)``, the
per-step noise from a generator seeded from (7, step). The evaluation uses
the trained parameters, not the EMA, as the script does. Two of the
script's keys name XLA quantities; here they are ``warm_wall_s`` (one
untimed encoder pass and decoder evaluation at the batch's shapes, which
builds the kernels and settles cuDNN's plans) and ``peak_mb``
(``torch.cuda.max_memory_allocated`` over the style's calls; null on the
CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

CORPUS = 100000          # SYNTHETIC items
TRAIN_SPAN = 90000       # train indices are drawn from [0, TRAIN_SPAN)
EVAL_START = 95000       # the held-out slice starts here
NOISE_SEED = 7           # the per-step noise's seed
BASE_PAIR, FAST_PAIR = "ddim1000+ddim100", "dpm20+dpm20"


def synthetic_batch(dataset, idxs, texture=0.0) -> np.ndarray:
    """Stack corpus images (NHWC); ``texture`` adds per-index seeded uniform
    noise in [-texture, texture], clipped to the data range. The corpus is
    piecewise constant, which makes SSIM degenerate (a window's variance
    goes epsilon-negative); texture gives every window real variance."""
    imgs = []
    for i in idxs:
        x = dataset[int(i)]["x_0"]
        if texture:
            rs = np.random.RandomState(1000003 + int(i))
            x = np.clip(x + rs.uniform(-texture, texture, x.shape).astype(x.dtype), -1.0, 1.0)
        imgs.append(x)
    return np.stack(imgs)


def to_device(images: np.ndarray, device) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor on ``device``."""
    return torch.from_numpy(images).to(device).permute(0, 3, 1, 2).contiguous()


def build(size: int, dtype, device):
    """``(gd, encoder, decoder)`` of the headline at ``size`` px: the DPM
    geometry of that size, latent 512 (32 at 16px), the models built with
    the compute ``dtype`` over fp32 parameters and seeded (encoder 0,
    decoder 1) on the CPU, then moved to ``device``."""
    from .diffusion import GaussianDiffusion
    from .models import (CELEBA64_DPM, FFHQ128_DPM, TINY_DPM, SemanticEncoder, ShiftUNet,
                         encoder_for_resolution)
    from .training.base import init_on_cpu

    geometry = {16: TINY_DPM, 64: CELEBA64_DPM, 128: FFHQ128_DPM}[size]
    latent_dim = 512 if size in (64, 128) else 32
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    if size in (64, 128):
        encoder = init_on_cpu(0, 0, lambda: encoder_for_resolution(size, latent_dim,
                                                                   dtype=dtype))
    else:
        encoder = init_on_cpu(0, 0, lambda: SemanticEncoder(
            latent_dim, channels=(8, 16), attn_after_stage=2, image_size=size, dtype=dtype))
    decoder = init_on_cpu(0, 1, lambda: ShiftUNet(latent_dim=latent_dim, dtype=dtype,
                                                  **geometry))
    return gd, encoder.to(device), decoder.to(device)


def train(gd, encoder, decoder, dataset, steps: int, batch: int, texture: float,
          device) -> dict:
    """``steps`` PDAE train steps (Adam lr 1e-4) of the encoder and the
    shift branch, in place: ``{"state", "train_wall_s", "loss_first",
    "loss_last"}`` (the losses None without steps)."""
    from .training import TrainState, make_optimizer, make_representation_train_step
    from .training.partition import trainable_params
    from .training.state import flat_params
    from .utils.rng import TRAIN, generator

    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer({"lr": 1e-4}, flat_params(params))
    state = TrainState.create(params, optimizer)
    step = make_representation_train_step(gd, encoder, decoder, optimizer, device=device)
    rng = np.random.RandomState(0)
    loss_first = loss = None
    t0 = time.perf_counter()
    for i in range(steps):
        idxs = rng.randint(0, TRAIN_SPAN, (batch,))
        x_0 = to_device(synthetic_batch(dataset, idxs, texture), device)
        loss = step(state, x_0, generator(NOISE_SEED, TRAIN, i, device))
        if i == 0:
            loss_first = float(loss)
    loss_last = None if loss is None else float(loss)
    return {"state": state, "train_wall_s": time.perf_counter() - t0,
            "loss_first": loss_first, "loss_last": loss_last}


def autoencode(gd, pair: str, encoder, decoder, x: torch.Tensor) -> torch.Tensor:
    """One batch's roundtrip under the style pair ``"ENC+DEC"``."""
    enc_style, dec_style = pair.split("+")
    with torch.inference_mode():
        return gd.representation_learning_autoencoding(enc_style, dec_style, encoder,
                                                       decoder, x)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(gd, pair: str, encoder, decoder, dataset, idxs, batch: int, reps: int,
             texture: float, device) -> dict:
    """The style pair over the whole batches of ``idxs``, ``reps`` times,
    after one untimed warm-up: imgs/s, SSIM and MSE of ``(recon + 1) / 2``
    against ``(x + 1) / 2``, the warm-up's seconds and the peak memory."""
    from .metrics import MSEMetric, SSIMMetric

    encoder.eval()
    decoder.eval()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    x = to_device(synthetic_batch(dataset, idxs[:batch], texture), device)
    t = torch.full((batch,), gd.timesteps - 1, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        decoder(x, t, encoder(x))
    _sync(device)
    warm = time.perf_counter() - t0
    ssim_m, mse_m = SSIMMetric(), MSEMetric()
    n_done = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        for start in range(0, len(idxs), batch):
            sel = idxs[start:start + batch]
            if len(sel) < batch:
                break
            x = to_device(synthetic_batch(dataset, sel, texture), device)
            recon = autoencode(gd, pair, encoder, decoder, x)
            n_done += len(sel)
            a, b = (recon + 1.0) / 2.0, (x + 1.0) / 2.0
            ssim_m.process(a, b)
            mse_m.process(a.cpu().numpy(), b.cpu().numpy())
    _sync(device)
    wall = time.perf_counter() - t0
    return {"warm_wall_s": warm,
            "peak_mb": torch.cuda.max_memory_allocated(device) / 2 ** 20 if cuda else None,
            "imgs_per_sec": n_done / wall,
            "ssim": ssim_m.compute_metrics(), "mse": mse_m.compute_metrics()}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=128, choices=[16, 64, 128])
    p.add_argument("--train_steps", type=int, default=300,
                   help="synthetic pre-training steps (the zero-init output convs make an "
                        "untrained autoencode blind)")
    p.add_argument("--train_batch", type=int, default=32)
    p.add_argument("--eval_batch", type=int, default=16,
                   help="the reference's autoencoding_eval batch")
    p.add_argument("--eval_n", type=int, default=32, help="held-out images to evaluate")
    p.add_argument("--styles", default=f"{BASE_PAIR},{FAST_PAIR}",
                   help="comma list of encode+decode style pairs")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="compute dtype of both models (parameters stay fp32)")
    p.add_argument("--reps", type=int, default=2, help="timed passes over the eval images")
    p.add_argument("--texture", type=float, default=0.0,
                   help="seeded uniform noise amplitude added to every corpus image (train "
                        "and eval): makes SSIM well-defined on the piecewise-constant corpus")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run without one)")
    args = p.parse_args(argv)
    # a batch larger than the slice would skip every eval batch (NaN metrics)
    args.eval_batch = min(args.eval_batch, args.eval_n)
    return args


def main(argv=None) -> dict:
    from . import resolve_device
    from .data import SYNTHETIC

    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    gd, encoder, decoder = build(args.size, dtype, device)
    ds = SYNTHETIC({"image_size": args.size, "image_channel": 3, "length": CORPUS})
    trained = train(gd, encoder, decoder, ds, args.train_steps, args.train_batch,
                    args.texture, device)
    out = {"size": args.size,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda"
           else str(device),
           "dtype": args.dtype, "train_steps": args.train_steps,
           "train_batch": args.train_batch, "train_wall_s": trained["train_wall_s"],
           "loss_first": trained["loss_first"], "loss_last": trained["loss_last"],
           "eval_batch": args.eval_batch, "eval_n": args.eval_n, "texture": args.texture,
           "styles": {}}
    eval_idxs = np.arange(EVAL_START, EVAL_START + args.eval_n)
    for pair in (p.strip() for p in args.styles.split(",")):
        out["styles"][pair] = evaluate(gd, pair, encoder, decoder, ds, eval_idxs,
                                       args.eval_batch, args.reps, args.texture, device)
        print(f"[{pair}] {out['styles'][pair]}", file=sys.stderr)
    base, fast = out["styles"].get(BASE_PAIR), out["styles"].get(FAST_PAIR)
    if base and fast:
        out["fast_eval_trade"] = {
            "speedup": fast["imgs_per_sec"] / base["imgs_per_sec"],
            "ssim_delta": fast["ssim"] - base["ssim"],
            "mse_ratio": fast["mse"] / base["mse"] if base["mse"] else None}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
