"""One rank of the live 2-process FSDP runs of ``tests/test_torch_fsdp.py``:
the port's trainers under ``param_sharding: fsdp`` and ``replicated`` over a
``gloo`` tensor group on the CPU, under the environment that torchrun sets.
Imports no JAX.

Usage: python _torch_fsdp_worker.py <spec.json> <out.json>

The spec holds the jobs to run in order; for each the worker writes its
rank's gathered final state, losses, local sizes and what it holds between
steps (``at_rest``) to ``<out_dir>/<job>_rank<r>.pt`` and what it observed
to ``out.json``.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_ddp_worker import files_under, recording, tiny_encoder  # noqa: E402

import torch.distributed as dist  # noqa: E402

import pdae_torch.training.base as port_base  # noqa: E402
import pdae_torch.training.representation as port_rep  # noqa: E402
import pdae_torch.training.stage as port_stage  # noqa: E402
from pdae_torch.diffusion import GaussianDiffusion  # noqa: E402
from pdae_torch.models import SemanticEncoder, ShiftUNet  # noqa: E402
from pdae_torch.parallel import (init_distributed, is_primary, process_count,  # noqa: E402
                                 process_index, sync_global_devices)
from pdae_torch.train import pick_trainer  # noqa: E402
from pdae_torch.training import (TrainState, make_optimizer,  # noqa: E402
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.fsdp import FsdpPlan  # noqa: E402
from pdae_torch.training.state import flat_params  # noqa: E402
from pdae_torch.utils import encoder_tree, unet_tree  # noqa: E402
from pdae_torch.utils.sharded_checkpoint import flatten_dict, write_shard_file  # noqa: E402

torch.set_num_threads(1)


def gathered_state(trainer) -> dict:
    """{name: [param, EMA, exp_avg, exp_avg_sq]} whole (gathered under FSDP:
    collective), the count, and this rank's own numel of the EMA and the
    moments."""
    snap = trainer.snapshot_state(full=True)
    tensors = {f"{g}.{k}": [snap[c][g][k].clone() for c in ("params", "ema", "mu", "nu")]
               for g in snap["params"] for k in snap["params"][g]}
    opt = trainer.optimizer.state
    held = {"ema": sum(t.numel() for named in trainer.state.ema_params.values()
                       for t in named.values()),
            "moments": sum(opt[m][s].numel() for named in trainer.state.masters.values()
                           for m in named.values() for s in ("exp_avg", "exp_avg_sq"))}
    plan = trainer.plan
    return {"tensors": tensors, "count": snap["count"], "held": held,
            "sharded": [] if plan is None else [
                f"{lf.group}.{lf.name}" for lf in plan.sharded]}


def at_rest(trainer) -> dict:
    """What an FSDP trainer holds between steps: the parameters the plan
    holds that are not their placeholder (a NaN scalar expanded, in its
    module's entry), each frozen group's pieces in the flax layout (its
    blocks, and its whole tensors, keyed by flax path), the plan's leaves and
    its held and buffer bytes."""
    plan = trainer.plan
    if plan is None:
        return {}
    pieces = {}
    for g, (named, to_tree, _) in trainer._frozen.items():
        tree = to_tree({k: plan._blocks.get((g, k), p).detach().clone()
                        for k, p in named.items()})
        pieces[g] = {path: torch.from_numpy(np.array(leaf))
                     for path, leaf in flatten_dict(tree).items()}
    whole = [f"{g}.{k}" for m, attr, p, (g, k) in plan.held
             if not (p.untyped_storage().nbytes() <= p.element_size()
                     and all(st == 0 for st in p.stride()) and m._parameters[attr] is p)]
    return {"whole": whole,
            "held": sorted(f"{g}.{k}" for _, _, _, (g, k) in plan.held),
            "frozen_pieces": pieces,
            "frozen_exceptions": plan.frozen_exceptions,
            "leaves": [(lf.group, lf.name, list(lf.flax_shape), lf.flax_dim, lf.torch_dim)
                       for lf in plan.leaves + plan.frozen_leaves],
            "held_bytes": plan.held_bytes(), "buffer_bytes": plan.buffer_bytes(),
            "gathers": plan.gathers}


def parity_job(job, rank, out_dir):
    """The port's representation step under an FSDP plan as this rank of
    the global batch: weights, x, t and noise from the test, cut to this
    rank's rows; the gradients of the masters gathered whole."""
    data = torch.load(job["inputs"])
    encoder = SemanticEncoder(job["latent"], channels=(8, 16), attn_after_stage=2,
                              image_size=job["size"])
    decoder = ShiftUNet(latent_dim=job["latent"], **job["dpm"])
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    params = trainable_params(encoder, decoder)
    plan = FsdpPlan(params, {"encoder": encoder_tree, "shift": unet_tree}, job["min_size"],
                    "cpu", modules=(encoder, decoder))
    optimizer = make_optimizer(job["optimizer"], flat_params(plan.masters))
    ts = TrainState.create(params, optimizer, plan=plan)
    step = make_representation_train_step(
        GaussianDiffusion(job["diffusion"]), encoder, decoder, optimizer,
        ema_decay=job["ema_decay"], device="cpu", rows=(rank, process_count()), plan=plan)
    b = data["x"].shape[0] // process_count()
    mine = slice(rank * b, (rank + 1) * b)
    loss = step(ts, data["x"][mine], t=data["t"][mine], noise=data["noise"][mine])
    names = [(g, k) for g in ts.params for k in ts.params[g]]
    grads = plan.gather([ts.masters[g][k].grad for g, k in names])
    whole = plan.gather([ts.masters[g][k] for g, k in names])
    torch.save({"loss": loss, "grads": {f"{g}.{k}": t for (g, k), t in zip(names, grads)},
                "params": {f"{g}.{k}": t for (g, k), t in zip(names, whole)},
                "sharded": len(plan.sharded)},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def copy_dir(src, dst):
    if is_primary():
        shutil.copytree(src, dst)
    sync_global_devices("copied")


def trainer_job(job, rank, out_dir):
    """Build the job's trainer over the run directory both ranks share and
    train it to ``steps``; ``copy_at``: train
    to that step first and copy its latest checkpoint to ``copy_to``;
    ``switch``: after the run, copy the sharded latest to ``sharded_copy``,
    save it in the full format over the directory, then sharded again over
    the file; ``fail_writes``: every shard-file write of rank 0 fails;
    ``eval``: the trainer's ``evaluate`` with these arguments after the
    run."""
    run = job["root"]             # one run directory, as a sharded save needs
    cfg = job["config"]
    trainer = pick_trainer(cfg)(config=cfg, run_path=run, resume=job.get("resume"),
                                device="cpu")
    if job.get("fail_writes") and rank == 0:
        def failing(path, *args):
            raise OSError(f"no space left for {os.path.basename(path)}")
        port_base.write_shard_file = failing
    losses = recording(trainer)
    latest = os.path.join(run, "checkpoints", "latest.ckpt")
    out = {}
    built = at_rest(trainer)
    if job.get("copy_at") is not None:
        trainer.train(max_steps=job["copy_at"])
        copy_dir(latest, job["copy_to"])
    try:
        out["stopped_at"], out["error"] = trainer.train(max_steps=job["steps"]), None
    except RuntimeError as e:
        out["stopped_at"], out["error"] = None, str(e)
    finally:
        port_base.write_shard_file = write_shard_file
    if job.get("eval"):
        trainer.evaluate(trainer.step, **job["eval"])
    out["files"] = files_under(run)
    if job.get("switch"):
        out["latest_files"] = sorted(os.listdir(latest)) if is_primary() else []
        copy_dir(latest, job["sharded_copy"])
        trainer.checkpoint_format = "full"
        trainer.save(trainer.step)
        trainer._join_save()
        sync_global_devices("full")
        out["after_full_is_file"] = os.path.isfile(latest)
        if is_primary():
            shutil.copyfile(latest, job["full_copy"])
        sync_global_devices("full_copied")
        trainer.checkpoint_format = "sharded"
        trainer.save(trainer.step)
        trainer._join_save()
        out["after_sharded_files"] = sorted(os.listdir(latest)) if is_primary() else []
    rest = at_rest(trainer)
    state = gathered_state(trainer)
    torch.save({"losses": losses, **state, "at_rest": rest,
                "frozen_at_build": built.get("frozen_pieces")},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    out.update(step=trainer.step, sharded=len(state["sharded"]), layout=trainer.mesh_layout,
               exceptions=[] if trainer.plan is None else trainer.plan.exceptions)
    return out


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
