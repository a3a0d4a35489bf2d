"""Where the time of one ShiftUNet evaluation goes on the card.

Builds the celeba64 ShiftUNet (``CELEBA64_DPM``, latent 512) with seeded
random weights, and at batch ``--batch`` measures, each over ``--evals``
evaluations inside the shift-DDIM sample loop:

* the wall time per evaluation with the kernels (auto) and with the plain
  versions (``set_use_kernels(False)``), fp32 with TF32 off, and with the
  kernels and TF32 on (which the service never turns on; timed to size what
  it would save);
* a ``torch.profiler`` trace of the kernel path (fp32, TF32 off): device busy
  time per evaluation, the device's idle share, and device time by kernel.

Run on a machine with a card, from the repository root:

    python -m pdae_torch.tools.profile_autoencode [--batch 8] [--evals 10]

Prints one JSON line per measurement; the full table goes to
``chiprun_out/profile_autoencode.json``.
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
from ..models import CELEBA64_DPM, ShiftUNet

LATENT = 512
OUT = os.path.join(os.getcwd(), "chiprun_out", "profile_autoencode.json")


def _category(name: str) -> str:
    n = name.lower()
    if "gn_adagn_silu" in n:
        return "gn_adagn_silu kernel"
    if "attention_fwd" in n:
        return "attention kernel"
    if any(s in n for s in ("conv", "cudnn", "implicit", "wgrad", "dgrad", "sm90_xmma",
                            "winograd", "fft")):
        return "convolution"
    if "gemm" in n or "sgemm" in n or "cutlass" in n:
        return "matmul"
    if "cat" in n:
        return "concat"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--evals", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device()
    if device.type != "cuda":
        raise RuntimeError("the profile measures the card; run it where CUDA is")
    torch.manual_seed(args.seed)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM).to(device).eval()
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    style = f"ddim{args.evals}"
    x_T = torch.randn(args.batch, 3, 64, 64, device=device)
    z = torch.randn(args.batch, LATENT, device=device)

    def run():
        with torch.inference_mode():
            gd.representation_learning_ddim_sample(style, None, decoder, None, x_T, z)
        torch.cuda.synchronize()

    def wall_per_eval(kernels, tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ops.set_use_kernels(None if kernels else False)
        try:
            run()                                   # warm-up
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) / args.evals * 1e3
        finally:
            ops.set_use_kernels(None)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    result = {"batch": args.batch, "evals": args.evals,
              "device": torch.cuda.get_device_name(0),
              "ms_per_eval": {
                  "kernels_fp32": wall_per_eval(True, False),
                  "plain_fp32": wall_per_eval(False, False),
                  "kernels_fp32_tf32": wall_per_eval(True, True),
                  "plain_fp32_second": wall_per_eval(False, False),
                  "kernels_fp32_second": wall_per_eval(True, False)}}
    print(json.dumps(result), flush=True)

    from torch.profiler import ProfilerActivity, profile
    run()
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
        "wall_ms_per_eval": wall_us / args.evals / 1e3,
        "device_busy_ms_per_eval": busy / args.evals / 1e3 if kernels else None,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_launches_per_eval": len(kernels) / args.evals,
        "ms_per_eval_by_category": {k: v / args.evals / 1e3 for k, v in
                                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(trace), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({**result, **trace, "by_kernel": [
            {"name": n, "ms_per_eval": t / args.evals / 1e3, "count_per_eval": c / args.evals}
            for n, (t, c) in top]}, f, indent=1)
    for n, (t, c) in top[:12]:
        print(json.dumps({"kernel": n[:90], "ms_per_eval": t / args.evals / 1e3,
                          "count_per_eval": c / args.evals}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
