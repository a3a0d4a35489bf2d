"""The readings a cell's limits are set from, apart from the program's own:
the control (the plain reference in the program's place, one precision
below the configuration's) and, for training, the faults read in the
reference put in the program's place.

    python3 -m h100_bench.control --workload NAME --seeds 11,12,13

For each seed it prints one JSON line with each number the cell compares,
as the control (and each fault) reads it against the fp32 reference at the
cell's own sizes:

* ``train``: the control computes every product from fp8 (e4m3) operands,
  one step below the configuration's bf16; the fault ``half_batch`` takes
  each step's loss over half of the batch. A state left unchanged reads 1
  by the gap's own definition and needs no run.
* ``autoencode``: the control runs the reference with TF32 on, one step
  below fp32 with TF32 off, over the requests a run checks.

The benchmark's own runs never run this; it needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import run
from .geometry import geometry
from .reference.model import set_precision
from .reference.precision import FP32, TF32
from .reference.train import build, train_readings
from .traffic import autoencode, train
from .weights import make_weights


def train_control(config, workload, seed, device) -> dict:
    geo, batch = geometry(config), int(workload["batch_size"])
    w = make_weights(geo, seed, device)

    def gaps(**kw):
        return train.compare(train_readings(geo, batch, w, seed, device, **kw), ref)

    ref = train_readings(geo, batch, w, seed, device)
    return {"control_fp8": gaps(precision="fp8"), "half_batch": gaps(rows=batch // 2)}


def autoencode_control(config, workload, seed, device, requests: int = 9) -> dict:
    geo = autoencode.geometry(config)
    w = make_weights(geo, seed, device)
    enc, dec = build(geo, w, device)
    batch, size = int(workload["batch"]), geo["image_size"]
    n = [autoencode.steps(workload["encode_style"]), autoencode.steps(workload["decode_style"])]

    def images_in(precision, images):
        for model in (enc, dec):
            set_precision(model, precision)
        return autoencode.reference_autoencode(enc, dec, images, *n, device)

    gap = 0.0
    for r in autoencode.sample_requests(seed, range(1, requests + 1),
                                        int(workload["check_requests"])):
        images = autoencode.request_images(seed, r, batch, size)
        gap = max(gap, autoencode.image_gap(images_in(TF32, images), images_in(FP32, images)))
    return {"control_tf32": {"image_gap": gap}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    workload, config = run.cell_files(args.workload)
    device = torch.device("cuda", 0)
    reader = {"train": train_control, "autoencode": autoencode_control}[workload["traffic"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = reader(config, workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
