"""Train from a config: the port's counterpart of ``scripts/train.py``.

    python -m pdae_torch.train --config_path CONFIG --run_path RUN \\
        [--resume latest|PATH] [--max_steps N] [--seed S] [--set k=v]... \\
        [--device D]

The trainer is picked from the config's keys as ``scripts/train.py`` picks
it: ``denoise_fn_config`` the regular DPM, ``encoder_config`` and
``decoder_config`` PDAE representation learning, ``latent_denoise_fn_config``
the latent DPM, ``inferred_latents`` the manipulation classifier. ``--set
dotted.key=value`` overrides a config field (repeatable; values parse as
Python literals where they can). ``--device`` defaults to the card; pass
``cpu`` to train on the CPU.

Data-parallel over N processes (``param_sharding: replicated``, one process
a card; the global batch is ``batch_size * num_iterations * N``)::

    torchrun --nproc_per_node N -m pdae_torch.train --config_path CONFIG \\
        --run_path RUN

The process group is joined before the trainer is built
(``parallel.init_distributed``): gradients are averaged over NCCL, or over
gloo with ``--device cpu``. FSDP (``--set runner_config.param_sharding=fsdp``)
keeps each rank's block of the large trained tensors only and
reduce-scatters and all-gathers over the same group; ``--set
runner_config.checkpoint_format=sharded`` has every rank write its pieces of
the checkpoint (``pdae_tpu``'s directory layout)::

    torchrun --nproc_per_node 2 -m pdae_torch.train --config_path CONFIG \\
        --run_path RUN --set runner_config.param_sharding=fsdp \\
        --set runner_config.checkpoint_format=sharded --device cpu
"""

from __future__ import annotations

import argparse
import os


def pick_trainer(config: dict):
    from . import training
    if "denoise_fn_config" in config:
        return training.RegularDiffusionTrainer
    if "encoder_config" in config and "decoder_config" in config:
        return training.RepresentationLearningTrainer
    if "latent_denoise_fn_config" in config:
        return training.LatentDiffusionTrainer
    if "inferred_latents" in config:
        return training.ManipulationTrainer
    raise SystemExit("cannot infer trainer type from config keys")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", required=True)
    p.add_argument("--run_path", required=True)
    p.add_argument("--resume", default=None, help="'latest' or a checkpoint path")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the device to train on (default: the card)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides", help="override a config field by dotted path "
                                          "(repeatable)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .parallel import init_distributed, is_primary
    from .utils import apply_overrides, load_yaml
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        init_distributed(backend="gloo" if cpu else None)
    config = apply_overrides(load_yaml(args.config_path), args.overrides, dotted=True)
    trainer_cls = pick_trainer(config)
    if is_primary():
        print(f"trainer: {trainer_cls.__name__}", flush=True)
    try:
        trainer = trainer_cls(config=config, run_path=args.run_path, resume=args.resume,
                              seed=args.seed, device=args.device)
        trainer.train(max_steps=args.max_steps)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
