"""Where the time of one representation-learning train step goes on the card.

Builds the celeba64 ShiftUNet (``CELEBA64_DPM``, latent 512) and the 64px
encoder with seeded random weights (zero-init layers perturbed, so the
gradient branch is live) in the compute dtype ``--dtype`` (fp32 params either
way), and at batch ``--batch`` (Adam lr 1e-4, the decoder's forward under
``--remat``) measures, each over ``--steps`` steps after a warm-up:

* the wall time per step with the kernels (auto) and with the plain versions
  (``set_use_kernels(False)``), TF32 off, and with the kernels and TF32 on
  (which the port never turns on; timed to size what it would save);
* a ``torch.profiler`` trace of the kernel path (TF32 off): device busy time
  per step, the device's idle share, and device time by kernel category.

With ``--steps-per-dispatch K`` > 1 the step is also captured into a CUDA
graph (``training/dispatch.py``'s ``StepGraph``) and the same steps run as
replays, the generator re-seeded before each and the host synchronised once
per K: wall ms per step and the trace's busy ms and idle share beside the
eager path's, measured in the same process.

Run on a machine with a card, from the repository root:

    python -m pdae_torch.tools.profile_train_step [--batch 32] [--steps 5] \
        [--dtype float32|bfloat16] [--remat none|full|skips] [--steps-per-dispatch K]

Prints one JSON line per measurement; the full table goes to
``chiprun_out/profile_train_step[_DTYPE_REMAT][_kK].json`` (no suffix for
fp32 without remat and K = 1).
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
REMAT = {"none": None, "full": True, "skips": "skips"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _category(name: str) -> str:
    n = name.lower()
    if "gn_adagn_silu_bwd" in n:
        return "gn_adagn_silu_bwd kernel"
    if "multi_tensor" in n or "adam" in n or "foreach" in n:
        return "optimizer and EMA (foreach)"
    if "reduce" in n:
        return "reduction"
    return _forward_category(name)


def _trace(run, steps):
    """``run()`` (``steps`` steps, ending in a synchronise) under
    ``torch.profiler``: wall and device-busy ms per step, the idle share,
    launches and device ms by category per step; and the per-kernel sums."""
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
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3 if kernels else None,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "ms_per_step_by_category": {k: v / steps / 1e3 for k, v in
                                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }, by_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--remat", choices=sorted(REMAT), default="none")
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    args = ap.parse_args(argv)
    k = args.steps_per_dispatch
    suffix = ("" if (args.dtype, args.remat) == ("float32", "none")
              else f"_{args.dtype}_{args.remat}") + (f"_k{k}" if k > 1 else "")
    out = os.path.join(os.getcwd(), "chiprun_out", f"profile_train_step{suffix}.json")

    device = resolve_device()
    if device.type != "cuda":
        raise RuntimeError("the profile measures the card; run it where CUDA is")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(args.seed)
    dtype = DTYPES[args.dtype]
    decoder = ShiftUNet(latent_dim=LATENT, dtype=dtype, **CELEBA64_DPM)
    encoder = encoder_for_resolution(64, LATENT, dtype=dtype)
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
    step = make_representation_train_step(gd, encoder, decoder, optimizer,
                                          remat=REMAT[args.remat])
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

    result = {"batch": args.batch, "steps": args.steps, "dtype": args.dtype,
              "remat": args.remat, "device": torch.cuda.get_device_name(0),
              "ms_per_step": {
                  "kernels": wall_per_step(True, False),
                  "plain": wall_per_step(False, False),
                  "kernels_tf32": wall_per_step(True, True),
                  "plain_second": wall_per_step(False, False),
                  "kernels_second": wall_per_step(True, False)}}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run()
    result["peak_mem_gb_kernels"] = torch.cuda.max_memory_allocated() / 1e9
    result["launches_per_step"] = {k: v / args.steps
                                   for k, v in ops.launch_counts().items()}
    print(json.dumps(result), flush=True)

    trace, by_name = _trace(run, args.steps)
    print(json.dumps(trace), flush=True)
    if k > 1:
        from ..training.dispatch import StepGraph

        count = state.step
        graph = StepGraph(lambda: {"loss": step(state, x_0, gen, ema=True)}, [gen],
                          torch.cuda.Stream(device), torch.cuda.graph_pool_handle())
        state.step = count           # the capture ran nothing

        def replays():
            for i in range(args.steps):
                gen.manual_seed(args.seed + state.step)
                graph.replay()
                state.step += 1
                if (i + 1) % k == 0:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()

        def wall_per_replay():
            replays()                 # warm-up: the graph's first replays
            t0 = time.perf_counter()
            replays()
            return (time.perf_counter() - t0) / args.steps * 1e3

        ops.reset_launch_counts()
        graph_ms = [wall_per_replay(), wall_per_replay()]
        graph_result = {"steps_per_dispatch": k, "ms_per_step": graph_ms,
                        "launches_per_replay": graph.launches,
                        "launches_counted_while_replaying": ops.launch_counts(),
                        "eager_ms_per_step_now": wall_per_step(True, False)}
        graph_trace, _ = _trace(replays, args.steps)
        graph_result.update({f"trace_{n}": v for n, v in graph_trace.items()})
        print(json.dumps({"graph": graph_result}), flush=True)
        trace["graph"] = graph_result
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({**result, **trace, "by_kernel": [
            {"name": n, "ms_per_step": t / args.steps / 1e3,
             "count_per_step": c / args.steps} for n, (t, c) in top]}, f, indent=1)
    for n, (t, c) in top[:14]:
        print(json.dumps({"kernel": n[:90], "ms_per_step": t / args.steps / 1e3,
                          "count_per_step": c / args.steps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
