"""One rank of the live 2-process run of ``tests/test_torch_dist.py``: the
port's process layer over ``gloo`` on the CPU, under the environment that
torchrun sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). Imports no JAX.

Usage: python _torch_dist_worker.py <spec.json> <out.json>

The spec holds the sampler configs to run; the worker writes what it
observed, and each sampler's result, to ``out.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pdae_torch.sampling.context as context  # noqa: E402
from pdae_torch.metrics import BaseMetric, FIDMetric  # noqa: E402
from pdae_torch.models import SemanticEncoder  # noqa: E402
from pdae_torch.parallel import (gather_objects, init_distributed, is_primary,  # noqa: E402
                                 process_count, process_index, sync_global_devices)
from pdae_torch.sampling import SAMPLERS  # noqa: E402

torch.set_num_threads(1)


def tiny_encoder(config, image_size=None):
    """The sampler test stack's encoder (``tests/_torch_sampler_files.py``)."""
    return SemanticEncoder(config["latent_dim"], channels=(8, 16), attn_after_stage=2,
                           image_size=image_size)


def main(spec_path, out_path):
    with open(spec_path) as f:
        spec = json.load(f)
    context.build_encoder = tiny_encoder
    init_distributed()
    rank = process_index()
    out = {"rank": rank, "world": process_count(), "is_primary": is_primary()}
    # ragged lists, concatenated in rank order
    out["ragged"] = gather_objects([f"r{rank}-{i}" for i in range(rank + 1)])
    sync_global_devices("after_ragged")
    metric = BaseMetric()
    metric.results = [0.5] if rank == 0 else [1.0, 2.0]
    metric.all_gather_results()
    out["metric"] = [metric.results, metric.compute_metrics()]
    fid = FIDMetric(None)
    fid.features = [np.full((rank + 1, 2), float(rank))]
    fid.all_gather_results()
    out["fid_features"] = [f.tolist() for f in fid.features]
    try:
        for name, config in spec.items():
            out[name] = SAMPLERS[name](config, device="cpu").start()
            sync_global_devices(name)
    finally:
        torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
