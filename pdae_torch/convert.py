"""Convert the reference's torch ``.pt`` checkpoints to the port's msgpack
checkpoints, and back: the port's counterpart of
``scripts/convert_torch_checkpoint.py``, with its flags. The files it writes
are byte-equal to that script's.

Covers every artifact the reference distributes: pre-trained DPMs
(``ema_denoise_fn``), trained PDAE autoencoders (``ema_encoder``/
``ema_decoder``), latent DPMs, manipulation classifiers, inferred-latents
stats files, and the FID InceptionV3 and LPIPS AlexNet weights.

    python -m pdae_torch.convert in.pt out.ckpt [--encoder-stages {4,5}]
        # 4 = the 64px encoder, 5 = the 128px one
    python -m pdae_torch.convert latents.pt latents.ckpt --stats
    python -m pdae_torch.convert pt_inception-2015-12-05.pth inception.ckpt --inception
    python -m pdae_torch.convert alex.pth lpips.ckpt --lpips
    # the way back: a port (or pdae_tpu) .ckpt -> a .pt the reference loads
    python -m pdae_torch.convert in.ckpt out.pt --export

The ``.pt`` files pickle more than tensors (the reference's trainers save
whole dicts), so they load with ``weights_only=False``: convert only files
you trust.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--encoder-stages", type=int, default=4, choices=(4, 5))
    p.add_argument("--stats", action="store_true",
                   help="input is an inferred-latents {mean,std} file")
    p.add_argument("--inception", action="store_true",
                   help="input is the TF-FID InceptionV3 state dict "
                        "(pt_inception-2015-12-05)")
    p.add_argument("--lpips", action="store_true",
                   help="input is an lpips-package (AlexNet) or torchvision "
                        "alexnet state dict")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: a .ckpt -> a torch .pt the "
                        "reference trainers and samplers can load")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .utils import load_checkpoint, save_checkpoint
    from .utils.reference_checkpoint import (convert_reference_checkpoint,
                                             export_reference_checkpoint)

    if args.export:
        out = export_reference_checkpoint(load_checkpoint(args.input),
                                          num_encoder_stages=args.encoder_stages)
        torch.save(out, args.output)
        print(f"exported {args.input} -> {args.output} (keys: {sorted(out)})")
        return

    data = torch.load(args.input, map_location="cpu", weights_only=False)
    if args.inception or args.lpips:
        from .metrics.inception import convert_inception_state_dict
        from .metrics.lpips import flat_lpips_state_dict
        sd = data.state_dict() if hasattr(data, "state_dict") else data
        out = (convert_inception_state_dict if args.inception else flat_lpips_state_dict)(sd)
    elif args.stats:
        out = {k: np.asarray(data[k].numpy(), np.float32) for k in ("mean", "std")}
    else:
        out = convert_reference_checkpoint(data, num_encoder_stages=args.encoder_stages)
    save_checkpoint(args.output, out)
    print(f"converted {args.input} -> {args.output} (keys: {sorted(out)})")


if __name__ == "__main__":
    main()
