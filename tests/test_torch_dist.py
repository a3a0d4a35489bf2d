"""The port's process layer (``pdae_torch.parallel``) on the CPU: its pure
functions against ``pdae_tpu.parallel.dist``, its one-process identities,
and a live 2-process ``gloo`` run (two workers started with torchrun's
environment, as ``tests/test_multiprocess_live.py`` starts JAX's) of a
ragged gather, a barrier, the metrics' gathers, and ``AutoencodingEval``
(with LPIPS), ``InferLatents`` and ``UnconditionalSample`` at world 2
against world 1 on the 32px sampler test stack.

Tolerances: the shard and dispatch arithmetic exactly as JAX's. World 2
against world 1: each rank's batches hold other images than the one-process
run's, so a control runs one process over the ranks' batches in the ranks'
order; world 2 must equal the control within 1e-12 relative (the float64
means' order), and world 1 within the control's own gap from it plus that.
The latents are encoded one image a batch, so world 2's stats equal the
control's bit for bit and world 1's within 1e-6 relative (the float32 mean's
order over another concatenation).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import pdae_torch.sampling.samplers as port_samplers
from _torch_metric_weights import seeded_lpips
from _torch_sampler_files import read_png, sampler_files
from pdae_tpu.parallel import dist as jax_dist
from pdae_tpu.utils import save_checkpoint as jax_save_checkpoint
from pdae_torch import resolve_device
from pdae_torch.metrics import BaseMetric
from pdae_torch.parallel import (dispatch_num_samples_for_process, gather_objects,
                                 init_distributed, is_primary, process_count, process_index,
                                 process_shard_indices, sync_global_devices)
from pdae_torch.sampling import SAMPLERS
from pdae_torch.utils import load_checkpoint

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
MEAN_RTOL = 1e-12
LATENT_RTOL = 1e-6
GRID = [(n, rank, world) for world in range(1, 6) for rank in range(world)
        for n in range(0, 12)]


# -- the pure functions ------------------------------------------------------ #

@pytest.mark.parametrize("pad_to_even", [True, False])
def test_shard_indices_equal_jax_over_a_grid(pad_to_even):
    for n, rank, world in GRID:
        got = process_shard_indices(n, rank, world, pad_to_even=pad_to_even)
        want = jax_dist.process_shard_indices(n, rank, world, pad_to_even=pad_to_even)
        np.testing.assert_array_equal(got, want, err_msg=f"n={n} rank={rank} world={world}")
    # the padded shards are equal in length and wrap from the start, also
    # when n < world
    shards = [process_shard_indices(3, r, 8) for r in range(8)]
    assert {len(s) for s in shards} == {1}
    assert [int(s[0]) for s in shards] == [0, 1, 2, 0, 1, 2, 0, 1]


def test_dispatch_equals_jax_over_a_grid():
    for n, rank, world in GRID:
        assert dispatch_num_samples_for_process(n, rank, world) == \
            jax_dist.dispatch_num_samples_for_process(n, rank, world)
    for n, world in ((0, 3), (2, 5), (11, 4)):
        assert sum(dispatch_num_samples_for_process(n, r, world) for r in range(world)) == n


def test_one_process_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    init_distributed()
    assert not torch.distributed.is_initialized()
    assert (process_count(), process_index(), is_primary()) == (1, 0, True)
    local = [np.arange(3), "x"]
    got = gather_objects(local)
    assert got == local and got is not local
    sync_global_devices()
    np.testing.assert_array_equal(process_shard_indices(5), np.arange(5))
    assert dispatch_num_samples_for_process(7) == 7
    metric = BaseMetric()
    metric.results = [0.25, 0.75]
    metric.all_gather_results()
    assert metric.results == [0.25, 0.75] and metric.compute_metrics() == 0.5


def test_the_default_device_is_the_local_rank_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device() == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1.*1 CUDA devices"):
        resolve_device()
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


# -- the live run ----------------------------------------------------------- #

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _configs(files, root):
    os.makedirs(root, exist_ok=True)
    base = dict(files.config, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5")
    return {
        # 4 images, 2 a rank: each rank's batch is one of the control's
        "autoencoding_eval": dict(base, batch_size=2, max_samples=4,
                                  lpips_weights=files.path["lpips.ckpt"]),
        "infer_latents": dict(base, batch_size=1, max_samples=6,
                              output_path=str(root / "latents.ckpt")),
        # 3 samples: 2 on rank 0, 1 on rank 1; one a batch, so rank 0 draws
        # what the one-process run draws first
        "unconditional_sample": dict(base, num_samples=3, batch_size=1,
                                     latent_ddim_style="ddim2", decoder_ddim_style="ddim2",
                                     output_path=str(root / "uncond.png")),
    }


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """World 2 (two workers) and, in this process, world 1 and the control
    on the same files."""
    root = tmp_path_factory.mktemp("dist")
    jax_save_checkpoint(str(root / "lpips.ckpt"), seeded_lpips(9))
    with sampler_files(root, size=32) as files:
        files.path["lpips.ckpt"] = str(root / "lpips.ckpt")
        w2 = _configs(files, root / "w2")
        with open(root / "spec.json", "w") as f:
            json.dump(w2, f)
        port = str(_free_port())
        procs = []
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
                 str(root / "spec.json"), str(root / f"rank{rank}.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
        ranks = []
        for rank in range(2):
            with open(root / f"rank{rank}.json") as f:
                ranks.append(json.load(f))

        w1_cfg = _configs(files, root / "w1")
        w1 = {name: SAMPLERS[name](cfg, device="cpu").start() for name, cfg in w1_cfg.items()}
        # the control: one process over the ranks' shards, rank 0's first
        order = {n: np.concatenate([jax_dist.process_shard_indices(n, r, 2, pad_to_even=pad)
                                    for r in range(2)])
                 for n, pad in ((4, True), (6, False))}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_samplers, "process_shard_indices",
                       lambda n, pad_to_even=True: order[n])
            ctrl_cfg = _configs(files, root / "ctrl")
            ctrl = {name: SAMPLERS[name](ctrl_cfg[name], device="cpu").start()
                    for name in ("autoencoding_eval", "infer_latents")}
        yield {"ranks": ranks, "w1": w1, "ctrl": ctrl, "w2": w2, "root": root}


def test_rendezvous_ragged_gather_and_barrier(live):
    r0, r1 = live["ranks"]
    assert (r0["rank"], r0["world"], r0["is_primary"]) == (0, 2, True)
    assert (r1["rank"], r1["world"], r1["is_primary"]) == (1, 2, False)
    for r in (r0, r1):
        assert r["ragged"] == ["r0-0", "r1-0", "r1-1"]
        assert r["metric"] == [[0.5, 1.0, 2.0], pytest.approx(3.5 / 3, rel=1e-15)]
        assert r["fid_features"] == [[[0.0, 0.0]], [[1.0, 1.0], [1.0, 1.0]]]


def test_autoencoding_eval_at_world_two_equals_world_one(live):
    w1, ctrl = live["w1"]["autoencoding_eval"], live["ctrl"]["autoencoding_eval"]
    got = [r["autoencoding_eval"] for r in live["ranks"]]
    assert got[0] == got[1]
    assert sorted(got[0]) == ["lpips", "mse", "ssim"] and got[0]["lpips"] > 0
    for k, want in w1.items():
        assert abs(got[0][k] - ctrl[k]) <= MEAN_RTOL * abs(ctrl[k]), k
        assert abs(got[0][k] - want) <= abs(ctrl[k] - want) + MEAN_RTOL * abs(want), k


def test_infer_latents_at_world_two_equals_world_one(live):
    path = live["w2"]["infer_latents"]["output_path"]
    assert [r["infer_latents"] for r in live["ranks"]] == [path, path]
    got, w1 = load_checkpoint(path), load_checkpoint(live["w1"]["infer_latents"])
    ctrl = load_checkpoint(live["ctrl"]["infer_latents"])
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[k], ctrl[k])
        np.testing.assert_allclose(got[k], w1[k], rtol=LATENT_RTOL,
                                   atol=LATENT_RTOL * np.abs(w1[k]).max())


def test_unconditional_sample_splits_draws_and_writes_on_the_primary(live):
    """Rank 0 generates 2 and draws what world 1 draws first; rank 1
    generates 1 from draws of its own; the primary's grid holds all 3."""
    path = live["w2"]["unconditional_sample"]["output_path"]
    assert [r["unconditional_sample"] for r in live["ranks"]] == [path, path]
    got, want = read_png(path), read_png(live["w1"]["unconditional_sample"])
    assert got.shape == want.shape == (70, 70, 3)          # a 2x2 grid of 32px tiles

    def tile(png, i):
        r, c = divmod(i, 2)
        return png[2 + 34 * r:34 + 34 * r, 2 + 34 * c:34 + 34 * c]

    for i in (0, 1):
        np.testing.assert_array_equal(tile(got, i), tile(want, i))
    assert np.abs(tile(got, 2) - tile(want, 0)).max() > 1
    assert np.abs(tile(got, 2) - tile(want, 2)).max() > 1
