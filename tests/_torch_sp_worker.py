"""One rank of the live spatial-parallel runs of ``tests/test_torch_sp.py``:
the port's models, train step, trainers and service under ``sp`` and
``fsdp+sp`` over a ``gloo`` tensor group on the CPU, under the environment
that torchrun sets. Imports no JAX.

Usage: python _torch_sp_worker.py <spec.json> <out.json>

The spec holds the jobs to run in order; for each the worker writes what its
rank computed to ``<out_dir>/<job>_rank<r>.pt`` and what it observed to
``out.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_ddp_worker import files_under, recording, tiny_encoder  # noqa: E402
from _torch_fsdp_worker import gathered_state  # noqa: E402
from _torch_tp_worker import MODELS, copy_checkpoint  # noqa: E402

import torch.distributed as dist  # noqa: E402

import pdae_torch.training.representation as port_rep  # noqa: E402
import pdae_torch.training.stage as port_stage  # noqa: E402
from pdae_torch import ops  # noqa: E402
from pdae_torch.diffusion import GaussianDiffusion  # noqa: E402
from pdae_torch.models import SemanticEncoder, ShiftUNet  # noqa: E402
from pdae_torch.parallel import (init_distributed, process_count,  # noqa: E402
                                 process_index, sp, sync_global_devices)
from pdae_torch.serving import PDAEService  # noqa: E402
from pdae_torch.train import pick_trainer  # noqa: E402
from pdae_torch.training import (TrainState, make_optimizer,  # noqa: E402
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.fsdp import FsdpPlan  # noqa: E402
from pdae_torch.training.state import flat_params  # noqa: E402
from pdae_torch.utils import encoder_tree, unet_tree  # noqa: E402

torch.set_num_threads(1)


def forward_job(job, rank, out_dir):
    """Each model of the job built from its kwargs, its whole state dict
    loaded, laid out over the job's sp ranks, and run on the whole inputs
    (no grad); the split passes' launches on the CPU (none: the plain
    versions) and the rows each rank held at the model's input."""
    data = torch.load(job["inputs"], weights_only=False)
    g = sp.sp_groups(job["sp"])
    out = {}
    ops.reset_launch_counts()
    for case in job["cases"]:
        cls, _ = MODELS[case["model"]]
        model = cls(**case["kwargs"])
        model.load_state_dict(data[case["name"]]["state"], strict=True)
        sp.shard_rows(model, g, data[case["name"]]["args"][0].shape[2])
        with torch.no_grad():
            out[case["name"]] = model(*data[case["name"]]["args"])
    torch.save({"out": out, "launches": ops.launch_counts(), "sp_index": g.sp_index},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def parity_job(job, rank, out_dir):
    """The port's representation step under ``sp`` (``fsdp+sp`` where
    ``fsdp``) on the test's weights, with its x, t and noise cut to this
    rank's data rows (the whole rows on every rank of an sp group); the
    gradients of the masters (reduced: summed over the sp group, averaged
    over the data group) and the updated params, whole."""
    data = torch.load(job["inputs"], weights_only=False)
    g = sp.sp_groups(job["sp"])
    encoder = SemanticEncoder(job["latent"], channels=(8, 16), attn_after_stage=2,
                              image_size=job["size"])
    decoder = ShiftUNet(latent_dim=job["latent"], **job["dpm"])
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    # partial gradients where the models run split (not where the rows of
    # the input do not divide by sp: then every rank runs them whole)
    partial = bool(sp.shard_rows(encoder, g, job["size"]) + sp.shard_rows(decoder, g,
                                                                        job["size"]))
    params = trainable_params(encoder, decoder)
    numel = sum(p.numel() for p in flat_params(params))
    plan = reduce = None
    if job.get("fsdp"):
        plan = FsdpPlan(params, {"encoder": encoder_tree, "shift": unet_tree},
                        job["min_size"], "cpu", g.data_group, (g.data_index, g.dp),
                        pre_reduce=sp.grad_sum(numel, "cpu", g, partial),
                        modules=(encoder, decoder))
    else:
        reduce = sp.grad_reducer(1 + numel, "cpu", g, partial)
    masters = params if plan is None else plan.masters
    optimizer = make_optimizer(job["optimizer"], flat_params(masters))
    ts = TrainState.create(params, optimizer, plan=plan)
    step = make_representation_train_step(
        GaussianDiffusion(job["diffusion"]), encoder, decoder, optimizer,
        ema_decay=job["ema_decay"], device="cpu", rows=(g.data_index, g.dp), reduce=reduce,
        plan=plan)
    b = data["x"].shape[0] // g.dp
    mine = slice(g.data_index * b, (g.data_index + 1) * b)
    loss = step(ts, data["x"][mine], t=data["t"][mine], noise=data["noise"][mine])
    names = [(gr, k) for gr in ts.params for k in ts.params[gr]]
    grads = [ts.masters[gr][k].grad for gr, k in names]
    values = [ts.masters[gr][k].detach() for gr, k in names]
    if plan is not None:
        grads, values = plan.gather(grads), plan.gather(values)
    torch.save({"loss": loss, "partial": partial,
                "grads": {f"{gr}.{k}": t for (gr, k), t in zip(names, grads)},
                "params": {f"{gr}.{k}": t for (gr, k), t in zip(names, values)}},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def trainer_job(job, rank, out_dir):
    """The job's trainer over the run directory all ranks share, trained to
    ``steps`` (``copy_at``: to that step first, its latest checkpoint copied
    to ``copy_to``); its gathered state, losses, the shapes of its
    parameters, EMA and moments against the whole ones, and its files."""
    run = job["root"]
    cfg = job["config"]
    trainer = pick_trainer(cfg)(config=cfg, run_path=run, resume=job.get("resume"),
                                device="cpu")
    losses = recording(trainer)
    if job.get("copy_at") is not None:
        trainer.train(max_steps=job["copy_at"])
        copy_checkpoint(os.path.join(run, "checkpoints", "latest.ckpt"), job["copy_to"])
    stopped = trainer.train(max_steps=job["steps"])
    if job.get("eval"):
        trainer.evaluate(trainer.step, **job["eval"])
    opt = trainer.optimizer.state
    held = []
    for gr, named in trainer.state.params.items():
        for k, p in named.items():
            m = trainer.state.masters[gr][k]
            held.append({"name": f"{gr}.{k}", "param": list(p.shape),
                         "ema": list(trainer.state.ema_params[gr][k].shape),
                         "moments": [list(opt[m][s].shape) for s in ("exp_avg", "exp_avg_sq")]})
    state = gathered_state(trainer)
    torch.save({"losses": losses, **state}, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    g = trainer.sp_groups
    return {"stopped_at": stopped, "step": trainer.step, "files": files_under(run),
            "held": held, "grid": [g.sp, g.dp, g.sp_index, g.data_index]}


def service_job(job, rank, out_dir):
    """``PDAEService`` at ``sp_size`` on the test's artifacts: every op, each
    rank's whole result."""
    data = torch.load(job["inputs"], weights_only=False)
    service = PDAEService(data["config"], data["encoder"], data["decoder"], device="cpu",
                          latent_state=data["latent"], latent_stats=data["stats"],
                          classifier_state=data["classifier"])
    out = {}
    for name, (op, args, kwargs) in data["calls"].items():
        out[name] = getattr(service, op)(*args, **kwargs)
    torch.save({"out": out}, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


JOBS = {"forward": forward_job, "parity": parity_job, "trainer": trainer_job,
        "service": service_job}


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
            out[job["name"]] = JOBS[job["kind"]](job, rank, spec["out_dir"])
            sync_global_devices(job["name"])
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1], sys.argv[2])
