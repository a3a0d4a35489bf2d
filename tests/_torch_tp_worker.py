"""One rank of the live tensor-parallel runs of ``tests/test_torch_tp.py``:
the port's models, train step, trainers and service under ``tp`` and
``fsdp+tp`` over a ``gloo`` tensor group on the CPU, under the environment
that torchrun sets. Imports no JAX.

Usage: python _torch_tp_worker.py <spec.json> <out.json>

The spec holds the jobs to run in order; for each the worker writes what its
rank computed to ``<out_dir>/<job>_rank<r>.pt`` and what it observed to
``out.json``.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_ddp_worker import files_under, recording, tiny_encoder  # noqa: E402
from _torch_fsdp_worker import gathered_state  # noqa: E402

import torch.distributed as dist  # noqa: E402

import pdae_torch.training.representation as port_rep  # noqa: E402
import pdae_torch.training.stage as port_stage  # noqa: E402
from pdae_torch.diffusion import GaussianDiffusion  # noqa: E402
from pdae_torch.models import MLPSkipNet, SemanticEncoder, ShiftUNet, UNet  # noqa: E402
from pdae_torch.parallel import (init_distributed, process_count,  # noqa: E402
                                 process_index, sync_global_devices, tp)
from pdae_torch.serving import PDAEService  # noqa: E402
from pdae_torch.train import pick_trainer  # noqa: E402
from pdae_torch.training import (TrainState, make_optimizer,  # noqa: E402
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.fsdp import FsdpPlan  # noqa: E402
from pdae_torch.training.state import flat_params  # noqa: E402
from pdae_torch.utils import (encoder_tree, mlp_skip_net_tree, unet_tree)  # noqa: E402

torch.set_num_threads(1)

MODELS = {"unet": (UNet, unet_tree), "shift": (ShiftUNet, unet_tree),
          "encoder": (SemanticEncoder, encoder_tree), "mlp": (MLPSkipNet, mlp_skip_net_tree)}


def block_shapes(layout) -> dict:
    """``{"held": [(block shape, whole shape)] of the sharded parameters}``."""
    return [(tuple(p.shape), info.shape) for p, info in layout.infos.items()
            if info.role == "block"]


def forward_job(job, rank, out_dir):
    """Each model of the job built from its kwargs, its whole state dict
    loaded, laid out over tp ranks, and run on the inputs (no grad)."""
    data = torch.load(job["inputs"], weights_only=False)
    g = tp.tp_groups(job["tp"])
    out, held = {}, {}
    for case in job["cases"]:
        cls, to_tree = MODELS[case["model"]]
        model = cls(**case["kwargs"])
        model.load_state_dict(data[case["name"]]["state"], strict=True)
        layout = tp.Layout(g, job["min_size"])
        layout.add(model, to_tree)
        held[case["name"]] = block_shapes(layout)
        with torch.no_grad():
            y = model(*data[case["name"]]["args"])
        out[case["name"]] = y
    # dropout above 0 in train mode: every rank of the model group draws the
    # whole mask from the same seed and takes its slice
    model = UNet(**dict(job["dropout_dpm"], dropout=0.5))
    model.load_state_dict(data["dropout"]["state"], strict=True)
    tp.Layout(g, job["min_size"]).add(model, unet_tree)
    torch.manual_seed(11)
    with torch.no_grad():
        out["dropout_train"] = model.train()(*data["dropout"]["args"])
        out["dropout_eval"] = model.eval()(*data["dropout"]["args"])
    torch.save({"out": out, "held": held}, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def parity_job(job, rank, out_dir):
    """The port's representation step under ``tp`` (``fsdp+tp`` where
    ``fsdp``) on the test's weights, with its x, t and noise cut to this
    rank's data rows; the gradients of the masters and the updated params
    gathered whole."""
    data = torch.load(job["inputs"], weights_only=False)
    g = tp.tp_groups(job["tp"])
    encoder = SemanticEncoder(job["latent"], channels=(8, 16), attn_after_stage=2,
                              image_size=job["size"])
    decoder = ShiftUNet(latent_dim=job["latent"], **job["dpm"])
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    layout = tp.Layout(g, job["min_size"])
    layout.add(encoder, encoder_tree)
    layout.add(decoder, unet_tree)
    params = trainable_params(encoder, decoder)
    plan = None
    if job.get("fsdp"):
        plan = FsdpPlan(params, {"encoder": encoder_tree, "shift": unet_tree},
                        job["min_size"], "cpu", g.data_group, (g.data_index, g.dp),
                        layout.fsdp_rule(params), layout.model_sum(flat_params(params), "cpu"),
                        modules=(encoder, decoder))
    masters = params if plan is None else plan.masters
    optimizer = make_optimizer(job["optimizer"], flat_params(masters))
    ts = TrainState.create(params, optimizer, plan=plan, tp=layout)
    reduce = None if plan is not None else layout.reducer(flat_params(params), "cpu")
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
    plist = [ts.params[gr][k] for gr, k in names]
    whole = layout.gather(grads + values, plist * 2)
    n = len(names)
    torch.save({"loss": loss,
                "grads": {f"{gr}.{k}": t for (gr, k), t in zip(names, whole[:n])},
                "params": {f"{gr}.{k}": t for (gr, k), t in zip(names, whole[n:])},
                "sharded": sum(1 for p in plist if layout.info(p).role == "block"),
                "held": block_shapes(layout)},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def copy_checkpoint(src, dst):
    """The primary copies a checkpoint file or directory; the ranks wait."""
    if process_index() == 0:
        (shutil.copytree if os.path.isdir(src) else shutil.copyfile)(src, dst)
    sync_global_devices("copied")


def trainer_job(job, rank, out_dir):
    """The job's trainer over the run directory all ranks share, trained to
    ``steps`` (``copy_at``: to that step first, its latest checkpoint copied
    to ``copy_to``); its gathered state, losses, the shapes its tp-sharded
    parameters, EMA and moments are held at, and its files."""
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
    held = []
    layout = trainer.tp_layout
    opt = trainer.optimizer.state
    for gr, named in trainer.state.params.items():
        for k, p in named.items():
            info = layout.info(p)
            m = trainer.state.masters[gr][k]
            held.append({"name": f"{gr}.{k}", "role": info.role, "param": list(p.shape),
                         "whole": list(info.shape),
                         "ema": list(trainer.state.ema_params[gr][k].shape),
                         "moments": [list(opt[m][s].shape) for s in ("exp_avg", "exp_avg_sq")]})
    state = gathered_state(trainer)
    torch.save({"losses": losses, **state}, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {"stopped_at": stopped, "step": trainer.step, "files": files_under(run),
            "held": held}


def service_job(job, rank, out_dir):
    """``PDAEService`` at ``tp_size`` on the test's artifacts: every op, each
    rank's whole result."""
    data = torch.load(job["inputs"], weights_only=False)
    service = PDAEService(data["config"], data["encoder"], data["decoder"], device="cpu",
                          latent_state=data["latent"], latent_stats=data["stats"],
                          classifier_state=data["classifier"])
    out = {}
    for name, (op, args, kwargs) in data["calls"].items():
        out[name] = getattr(service, op)(*args, **kwargs)
    torch.save({"out": out, "held": block_shapes(service.tp_layout)},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
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
