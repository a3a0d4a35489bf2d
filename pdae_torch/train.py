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
"""

from __future__ import annotations

import argparse


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

    from .utils import apply_overrides, load_yaml
    config = apply_overrides(load_yaml(args.config_path), args.overrides, dotted=True)
    trainer_cls = pick_trainer(config)
    print(f"trainer: {trainer_cls.__name__}", flush=True)
    trainer = trainer_cls(config=config, run_path=args.run_path, resume=args.resume,
                          seed=args.seed, device=args.device)
    trainer.train(max_steps=args.max_steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
