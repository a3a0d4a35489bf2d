"""Device memory of a data-parallel or FSDP rank on one card.

Starts two ranks of the celeba64 representation trainer (full width, seeded
weights, SYNTHETIC 64px, b32 a rank, fp32, TF32 off) over a gloo tensor
group, both on ``cuda:0``, once for each ``param_sharding`` asked for, and
prints one JSON line a rank: its device memory between steps
(``torch.cuda.memory_allocated`` after the loop: the bytes of its live
tensors), its peak since the trainer's build, the build's and the steps'
seconds, and, where the trainer has an FSDP plan that reports them, the
bytes of state it holds; first, the card's name and power limit.

Run on a machine with a card, from the repository root:

    python3 pdae_torch/tools/fsdp_memory.py [--modes replicated,fsdp] [--steps 3]
        [--root DIR]

``--root`` imports ``pdae_torch`` from another checkout of the repository
(an earlier commit's, to hold its layout beside this one's on the same card
in the same call); the script needs nothing else of that checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

WORLD = 2
LATENT = 512


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(sharding: str) -> dict:
    from pdae_torch.models import CELEBA64_DPM

    far = 10 ** 6
    return {
        "train_dataset_config": {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                                 "length": 320, "preload": True, "latent_dim": LATENT},
        "eval_dataset_config": {},
        "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
        "trained_ddpm_config": {"denoise_fn_config": {"model": "UNet", **CELEBA64_DPM}},
        "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
        "decoder_config": {"model": "CELEBA64Decoder", "latent_dim": LATENT},
        "dataloader_config": {"train": {"num_workers": 4, "batch_size": 32},
                              "eval": {"num_generations": 8}},
        "optimizer_config": {"lr": 1e-4, "adam_betas": "(0.9, 0.999)", "adam_eps": 1e-8,
                             "weight_decay": 0.0, "enable_amp": False},
        "runner_config": {"display_steps": 1, "evaluate_every_steps": far,
                          "save_latest_every_steps": far, "save_checkpoint_every_steps": far,
                          "num_iterations": 1, "ema_every": 1, "ema_decay": 0.9999,
                          "param_sharding": sharding}}


def _worker(sharding: str, steps: int) -> dict:
    import torch
    import torch.distributed as dist

    from pdae_torch import parallel
    from pdae_torch.train import pick_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.init_distributed(backend="gloo")
    try:
        cfg = _config(sharding)
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as run:
            t0 = time.perf_counter()
            trainer = pick_trainer(cfg)(config=cfg, run_path=run, seed=0)
            build = time.perf_counter() - t0
            built = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(max_steps=steps, save_on_exit=False)
            torch.cuda.synchronize()
            out = {"sharding": sharding, "rank": parallel.process_index(),
                   "build_s": build, "steps_s": time.perf_counter() - t0, "steps": steps,
                   "after_build_gb": built / 1e9,
                   "between_steps_gb": torch.cuda.memory_allocated() / 1e9,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            plan = trainer.plan
            if plan is not None and hasattr(plan, "held_bytes"):
                out["plan_held_bytes"] = plan.held_bytes()
                out["plan_buffer_bytes"] = plan.buffer_bytes()
            del trainer
    finally:
        dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="replicated,fsdp")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--root", default=None,
                    help="a checkout whose pdae_torch to import (default: this one)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    if args.worker is not None:
        sys.path.insert(0, root)
        print(json.dumps(_worker(args.worker, args.steps)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"card": card.stdout.strip().splitlines()[0]}), flush=True)
    for mode in args.modes.split(","):
        port = str(_free_port())
        procs = []
        for rank in range(WORLD):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK="0",
                       LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", mode, "--steps",
                 str(args.steps), "--root", root], env=env, stdout=subprocess.PIPE, text=True))
        for p in procs:
            out, _ = p.communicate()
            lines = [line for line in out.splitlines() if line.startswith("{")]
            print(json.dumps({"root": root, **json.loads(lines[-1])}) if lines
                  else json.dumps({"root": root, "mode": mode, "rc": p.returncode}), flush=True)
            if p.returncode:
                return p.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
