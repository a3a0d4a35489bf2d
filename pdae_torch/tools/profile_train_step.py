"""Where the time of one representation-learning train step goes on the card.

Builds the celeba64 ShiftUNet (``CELEBA64_DPM``, latent 512) and the 64px
encoder with seeded random weights (zero-init layers perturbed, so the
gradient branch is live), and at batch ``--batch`` (Adam lr 1e-4, fp32)
measures, each over ``--steps`` steps after a warm-up:

* the wall time per step with the kernels (auto) and with the plain versions
  (``set_use_kernels(False)``), TF32 off, and with the kernels and TF32 on
  (which the port never turns on; timed to size what it would save);
* a ``torch.profiler`` trace of the kernel path (TF32 off): device busy time
  per step, the device's idle share, and device time by kernel category.

Run on a machine with a card, from the repository root:

    python -m pdae_torch.tools.profile_train_step [--batch 32] [--steps 5]

Prints one JSON line per measurement; the full table goes to
``chiprun_out/profile_train_step.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import torch

from .. import ops, resolve_device
from ..diffusion import GaussianDiffusion
from ..models import CELEBA64_DPM, ShiftUNet, encoder_for_resolution
from ..training import (TrainState, make_optimizer, make_representation_train_step,
                        trainable_params)
from ..training.state import flat_params
from .profile_autoencode import _busy_us
from .profile_autoencode import _category as _forward_category

LATENT = 512
OUT = os.path.join(os.getcwd(), "chiprun_out", "profile_train_step.json")


def _category(name: str) -> str:
    n = name.lower()
    if "gn_adagn_silu_bwd" in n:
        return "gn_adagn_silu_bwd kernel"
    if "multi_tensor" in n or "adam" in n or "foreach" in n:
        return "optimizer and EMA (foreach)"
    if "reduce" in n:
        return "reduction"
    return _forward_category(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device()
    if device.type != "cuda":
        raise RuntimeError("the profile measures the card; run it where CUDA is")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(args.seed)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM)
    encoder = encoder_for_resolution(64, LATENT)
    with torch.no_grad():
        for model in (decoder, encoder):
            for p in model.parameters():
                if not p.any():
                    p.normal_(std=0.02)
    decoder.to(device)
    encoder.to(device)
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer({"name": "Adam", "lr": 1e-4}, flat_params(params))
    state = TrainState.create(params, optimizer)
    step = make_representation_train_step(gd, encoder, decoder, optimizer)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x_0 = torch.rand(args.batch, 3, 64, 64, device=device) * 2 - 1

    def run():
        for _ in range(args.steps):
            step(state, x_0, gen)
        torch.cuda.synchronize()

    def wall_per_step(kernels, tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ops.set_use_kernels(None if kernels else False)
        try:
            step(state, x_0, gen)                   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) / args.steps * 1e3
        finally:
            ops.set_use_kernels(None)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    result = {"batch": args.batch, "steps": args.steps,
              "device": torch.cuda.get_device_name(0),
              "ms_per_step": {
                  "kernels_fp32": wall_per_step(True, False),
                  "plain_fp32": wall_per_step(False, False),
                  "kernels_fp32_tf32": wall_per_step(True, True),
                  "plain_fp32_second": wall_per_step(False, False),
                  "kernels_fp32_second": wall_per_step(True, False)}}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run()
    result["peak_mem_gb_kernels"] = torch.cuda.max_memory_allocated() / 1e9
    result["launches_per_step"] = {k: v / args.steps
                                   for k, v in ops.launch_counts().items()}
    print(json.dumps(result), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if getattr(e.device_type, "name", str(e.device_type)) == "CUDA"]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_cat = collections.defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        by_cat[_category(e.name)] += dur
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    trace = {
        "wall_ms_per_step": wall_us / args.steps / 1e3,
        "device_busy_ms_per_step": busy / args.steps / 1e3 if kernels else None,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "ms_per_step_by_category": {k: v / args.steps / 1e3 for k, v in
                                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(trace), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({**result, **trace, "by_kernel": [
            {"name": n, "ms_per_step": t / args.steps / 1e3,
             "count_per_step": c / args.steps} for n, (t, c) in top]}, f, indent=1)
    for n, (t, c) in top[:14]:
        print(json.dumps({"kernel": n[:90], "ms_per_step": t / args.steps / 1e3,
                          "count_per_step": c / args.steps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
