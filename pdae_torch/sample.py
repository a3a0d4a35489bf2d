"""Run one sampler of the port by name: the counterpart of ``scripts/sample.py``.

    python -m pdae_torch.sample --sampler autoencoding_eval \\
        --config configs/sampler/autoencoding_eval.yml [--set K=V ...] [--device D]

The config is a YAML (or JSON) file with the keys of ``configs/sampler/*.yml``;
``--set key=value`` overrides a top-level field (repeatable; values parse as
Python literals where they can), e.g. the fast solver styles:
``--set encoder_ddim_style=dpm20 --set decoder_ddim_style=dpm20``. The sampler
runs on the card unless ``--device`` names another (``--device cpu``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sampler", required=True)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--set", action="append", default=[], metavar="K=V", dest="overrides",
                   help="override a top-level config field (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run without one)")
    args = p.parse_args(argv)

    from .sampling import SAMPLERS
    from .utils import apply_overrides, load_yaml

    if args.sampler not in SAMPLERS:
        raise SystemExit(f"unknown sampler {args.sampler!r}; available: {sorted(SAMPLERS)}")
    config = apply_overrides(load_yaml(args.config), args.overrides, dotted=False)
    result = SAMPLERS[args.sampler](config, device=args.device).start()
    print(f"{args.sampler}: done -> {result}")
    return result


if __name__ == "__main__":
    main()
