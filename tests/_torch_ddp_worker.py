"""One rank of the live 2-process data-parallel runs of
``tests/test_torch_ddp.py``: the port's trainers over a ``gloo`` tensor group
on the CPU, under the environment that torchrun sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Imports no
JAX.

Usage: python _torch_ddp_worker.py <spec.json> <out.json>

The spec holds the jobs to run in order; for each the worker writes its
rank's final state, last gradients and losses to ``<out_dir>/<job>_rank<r>.pt``
and what it observed to ``out.json``.
"""

import json
import os
import shutil
import signal
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# no TensorBoard in the workers: its first import takes seconds, and the
# primary's metrics.jsonl is what the test reads
sys.modules["torch.utils.tensorboard"] = None

import torch.distributed as dist  # noqa: E402

import pdae_torch.training.base as port_base  # noqa: E402
import pdae_torch.training.representation as port_rep  # noqa: E402
import pdae_torch.training.stage as port_stage  # noqa: E402
from pdae_torch.models import SemanticEncoder, ShiftUNet  # noqa: E402
from pdae_torch.parallel import (init_distributed, is_primary, mean_all_reducer,  # noqa: E402
                                 process_count, process_index, sync_global_devices)
from pdae_torch.train import pick_trainer  # noqa: E402
from pdae_torch.training import (TrainState, make_optimizer,  # noqa: E402
                                 make_representation_train_step, trainable_params)
from pdae_torch.training.state import flat_params  # noqa: E402
from pdae_torch.diffusion import GaussianDiffusion  # noqa: E402
from pdae_torch.utils import save_checkpoint  # noqa: E402

torch.set_num_threads(1)


def tiny_encoder(config, image_size=None, dtype=torch.float32, input_channel=1):
    """The two-stage encoder of 8 and 16 channels the trainer tests build
    (``tests/_torch_parity.py::patch_tiny_encoders``)."""
    return SemanticEncoder(config["latent_dim"], channels=(8, 16), attn_after_stage=2,
                           image_size=image_size, input_channel=input_channel, dtype=dtype)


def trained_state(trainer) -> dict:
    """{name: [param, EMA, exp_avg, exp_avg_sq, grad]} and the count."""
    out = {}
    for g, named in trainer.state.params.items():
        for k, p in named.items():
            opt = trainer.optimizer.state[p]
            out[f"{g}.{k}"] = [t.detach().clone() for t in (
                p, trainer.state.ema_params[g][k], opt["exp_avg"], opt["exp_avg_sq"],
                p.grad)]
    return {"tensors": out, "count": int(next(iter(trainer.optimizer.state.values()))["step"])}


def recording(trainer) -> list:
    """The per-step losses of ``trainer``'s loop, kept by wrapping its chunk
    runner; ``trainer.after_chunk(step)``, where set, runs after each chunk."""
    seen, inner = [], trainer._chunk_runner

    def runner(*args):
        run = inner(*args)

        def wrapped(c):
            out, load = run(c)
            seen.extend(float(next(iter(m.values()))) for m in out)
            hook = getattr(trainer, "after_chunk", None)
            if hook is not None:
                hook(trainer.step)
            return out, load
        return wrapped

    trainer._chunk_runner = runner
    return seen


def files_under(path) -> list:
    if not os.path.exists(path):
        return []
    return sorted(os.path.relpath(os.path.join(p, n), path)
                  for p, _, names in os.walk(path) for n in names)


def parity_job(job, rank, out_dir):
    """The port's representation step as this rank of the global batch:
    weights, x, t and noise from the test, cut to this rank's rows."""
    data = torch.load(job["inputs"])
    encoder = SemanticEncoder(job["latent"], channels=(8, 16), attn_after_stage=2,
                              image_size=job["size"])
    decoder = ShiftUNet(latent_dim=job["latent"], **job["dpm"])
    encoder.load_state_dict(data["encoder"], strict=True)
    decoder.load_state_dict(data["decoder"], strict=True)
    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer(job["optimizer"], flat_params(params))
    ts = TrainState.create(params, optimizer)
    numel = 1 + sum(p.numel() for p in flat_params(params))
    step = make_representation_train_step(
        GaussianDiffusion(job["diffusion"]), encoder, decoder, optimizer,
        ema_decay=job["ema_decay"], device="cpu", rows=(rank, process_count()),
        reduce=mean_all_reducer(numel, "cpu"))
    b = data["x"].shape[0] // process_count()
    mine = slice(rank * b, (rank + 1) * b)
    loss = step(ts, data["x"][mine], t=data["t"][mine], noise=data["noise"][mine])
    torch.save({"loss": loss, "grads": {f"{g}.{k}": p.grad for g, n in ts.params.items()
                                        for k, p in n.items()},
                "params": {f"{g}.{k}": p.detach() for g, n in ts.params.items()
                           for k, p in n.items()}},
               os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {}


def trainer_job(job, rank, out_dir):
    """Build the job's trainer, train it to ``steps`` (with a copy of the
    step-``copy_at`` checkpoint for a resume; rank 1 sending itself SIGTERM
    after step ``sigterm_at``; every write of rank 0 failing with
    ``fail_writes``), optionally evaluate, and dump this rank's state."""
    run = os.path.join(job["root"], f"rank{rank}")
    cfg = job["config"]
    trainer = pick_trainer(cfg)(config=cfg, run_path=run, resume=job.get("resume"),
                                device="cpu")
    if job.get("augment"):
        trainer.train_dataset.augmentation = True
    if job.get("sigterm_at") is not None and rank == 1:
        def after_chunk(step):
            if step == job["sigterm_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
        trainer.after_chunk = after_chunk
    if job.get("fail_writes") and rank == 0:
        def failing(path, tree):
            raise OSError(f"no space left for {os.path.basename(path)}")
        port_base.save_checkpoint = failing
    losses = recording(trainer)
    copy_at = job.get("copy_at")
    if copy_at is not None:
        trainer.train(max_steps=copy_at)
        if is_primary():
            shutil.copy(os.path.join(run, "checkpoints", "latest.ckpt"), job["copy_to"])
        sync_global_devices("copied")
    try:
        stopped_at, error = trainer.train(max_steps=job["steps"]), None
    except RuntimeError as e:
        stopped_at, error = None, str(e)
    finally:
        port_base.save_checkpoint = save_checkpoint
    if job.get("eval"):
        trainer.evaluate(trainer.step, **job["eval"])
    state = trained_state(trainer)
    torch.save({"losses": losses, **state}, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))
    return {"stopped_at": stopped_at, "error": error, "step": trainer.step,
            "files": files_under(run),
            "eval_seconds": len(trainer.eval_seconds)}


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
