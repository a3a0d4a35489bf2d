"""One rank of the live runs of ``tests/test_torch_hier.py``: the port's
representation step and trainers under ``param_sharding: fsdp`` with
``mesh_layout: hier`` (and ``replicated``/flat ``fsdp`` beside them) over a
``gloo`` tensor group on the CPU, under the environment that torchrun sets.
Imports no JAX.

Usage: python _torch_hier_worker.py <spec.json> <out.json>

The spec holds the jobs to run in order; for each the worker writes what its
rank computed to ``<out_dir>/<job>_rank<r>.pt`` and what it observed to
``out.json``.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_ddp_worker import tiny_encoder  # noqa: E402
from _torch_fsdp_worker import trainer_job  # noqa: E402

import torch.distributed as dist  # noqa: E402

import pdae_torch.training.representation as port_rep  # noqa: E402
import pdae_torch.training.stage as port_stage  # noqa: E402
from pdae_torch import parallel  # noqa: E402
from pdae_torch.diffusion import GaussianDiffusion  # noqa: E402
from pdae_torch.models import SemanticEncoder, ShiftUNet  # noqa: E402
from pdae_torch.parallel import (hier, init_distributed, process_count,  # noqa: E402
                                 process_index, sync_global_devices)
from pdae_torch.training import (TrainState, make_optimizer,  # noqa: E402
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.fsdp import FsdpPlan  # noqa: E402
from pdae_torch.training.state import flat_params  # noqa: E402
from pdae_torch.utils import encoder_tree, unet_tree  # noqa: E402

torch.set_num_threads(1)
TREES = {"encoder": encoder_tree, "shift": unet_tree}


def parity_job(job, rank, out_dir):
    """The port's representation step under an FSDP plan over the rows of a
    ``job["grid"]`` host grid (the reduce-scattered blocks averaged over the
    columns), as this rank of the global batch: weights, x, t and noise from
    the test, cut to this rank's rows. Dumps the loss, the gradients and
    params gathered whole, and this rank's blocks before the step in the
    flax layout."""
    data = torch.load(job["inputs"])
    encoder = SemanticEncoder(job["latent"], channels=(8, 16), attn_after_stage=2,
                              image_size=job["size"])
    decoder = ShiftUNet(latent_dim=job["latent"], **job["dpm"])
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    g = hier.hier_groups(*job["grid"])
    params = trainable_params(encoder, decoder)
    plan = FsdpPlan(params, TREES, job["min_size"], "cpu", g.row_group, (g.col, g.cols),
                    modules=(encoder, decoder), whole_group=parallel.tensor_group(),
                    replica_group=g.col_group if g.rows > 1 else None)
    blocks = {gr: TREES[gr]({k: t.detach().clone() for k, t in named.items()})
              for gr, named in plan.masters.items()}
    optimizer = make_optimizer(job["optimizer"], flat_params(plan.masters))
    ts = TrainState.create(params, optimizer, plan=plan)
    step = make_representation_train_step(
        GaussianDiffusion(job["diffusion"]), encoder, decoder, optimizer,
        ema_decay=job["ema_decay"], device="cpu", rows=(rank, process_count()), plan=plan)
    b = data["x"].shape[0] // process_count()
    mine = slice(rank * b, (rank + 1) * b)
    loss = step(ts, data["x"][mine], t=data["t"][mine], noise=data["noise"][mine])
    names = [(gr, k) for gr in ts.params for k in ts.params[gr]]
    grads = plan.gather([ts.masters[gr][k].grad for gr, k in names])
    whole = plan.gather([ts.masters[gr][k] for gr, k in names])
    torch.save({"loss": loss, "grads": {f"{gr}.{k}": t for (gr, k), t in zip(names, grads)},
                "params": {f"{gr}.{k}": t for (gr, k), t in zip(names, whole)},
                "blocks": blocks, "place": [g.row, g.col],
                "sharded": sorted(f"{lf.group}/{lf.flax_path}" for lf in plan.sharded),
                "exceptions": plan.exceptions},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def main(spec_path, out_path):
    with open(spec_path) as f:
        spec = json.load(f)
    port_rep.build_encoder = tiny_encoder
    port_stage.build_encoder = tiny_encoder
    init_distributed(backend="gloo")
    rank = process_index()
    out = {"rank": rank, "world": process_count()}
    try:
        for job in spec["jobs"]:
            run = parity_job if job["kind"] == "parity" else trainer_job
            out[job["name"]] = run(job, rank, spec["out_dir"])
            sync_global_devices(job["name"])
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
