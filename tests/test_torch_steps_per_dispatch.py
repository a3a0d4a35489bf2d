"""``runner_config.steps_per_dispatch`` in the port's trainers, on the CPU.

On the card a chunk of K steps is K replays of one captured train step
(``pdae_torch/training/dispatch.py``, held there by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``dispatch`` phase); here, where the caller asks for
the CPU, each chunk runs as eager steps through the same loop. Held here:

* the chunk schedule is ``pdae_tpu``'s ``BaseTrainer._chunk_schedule`` on a
  grid of (start, K, max_steps), an endless run included, and the epoch
  stream's index chunks are ``pdae_tpu``'s ``_resident_index_chunks``;
* a cadence that is no multiple of K is refused with ``pdae_tpu``'s words;
* each of the four trainers (the latent and manipulation ones on a resident
  corpus, by epoch rows and by uniform draws) trains bit for bit alike at
  K=4 and K=1: the loss windows and, after a run stopped at step 5 (a tail
  chunk) and resumed there (a realigning chunk, then a tail), every param,
  EMA tensor, Adam moment and the count;
* ``GraphDispatch``, driven here by a stand-in graph that replays its body
  eagerly, trains like K=1: the static buffers (a host batch, a resident
  corpus's index rows), the re-seeding, the count around a capture, and an
  EMA and a no-EMA graph where ``ema_every`` is 2;
* a re-seeded ``StepGenerator`` draws what a fresh generator draws;
* the optimizer as the card builds it (``capturable``: the count and the
  bias corrections as fp32 tensors) against optax within the parity
  tolerance of ``tests/test_torch_training.py`` (rtol 1e-5, atol 1e-7).
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (TRAINER_DPM, TRAINER_DS, TRAINER_OPT, TRAINER_RUNNER,
                           assert_trees_bitwise, patch_tiny_encoders, tiny_pdae_config)
from pdae_torch.training import (LatentDiffusionTrainer, ManipulationTrainer,
                                 RegularDiffusionTrainer, RepresentationLearningTrainer,
                                 make_optimizer)
from pdae_torch.training.base import BaseTrainer
from pdae_torch.utils.rng import TRAIN, StepGenerator, generator
from pdae_tpu.training import state as jax_state
from pdae_tpu.training.base import BaseTrainer as JaxBaseTrainer
from test_stage34_sharded import build_stage34_artifacts, latent_cfg, manip_cfg

torch.set_num_threads(1)
K = 4
RUNNER_K = {"display_steps": K, "evaluate_every_steps": 100000,
            "save_latest_every_steps": 100000, "save_checkpoint_every_steps": 100000}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 50])
@pytest.mark.parametrize("start", [0, 1, 3, 4, 7, 49])
def test_chunk_schedule_is_jax(start, k):
    for end in (start, start + 1, start + 5, start + 13, start + 120):
        got = list(BaseTrainer._chunk_schedule(start, k, end))
        assert got == list(JaxBaseTrainer._chunk_schedule(start, k, end))
        assert sum(got) == end - start
    endless = BaseTrainer._chunk_schedule(start, k, None)
    want = JaxBaseTrainer._chunk_schedule(start, k, None)
    assert [next(endless) for _ in range(6)] == [next(want) for _ in range(6)]


def regular_cfg(**dataset):
    """A class-conditional tiny UNet on SYNTHETIC 16px gray, b8, 24 items (3
    batches an epoch), EMA every 2 steps."""
    return {"train_dataset_config": {**TRAINER_DS, "length": 24, **dataset},
            "eval_dataset_config": {},
            "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
            "denoise_fn_config": {**TRAINER_DPM, "num_class": 10},
            "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                                  "eval": {"num_generations": 2}},
            "optimizer_config": dict(TRAINER_OPT),
            "runner_config": {**TRAINER_RUNNER, **RUNNER_K, "ema_every": 2}}


@pytest.mark.parametrize("start,k,end", [(0, 4, 10), (5, 4, 13), (2, 3, 9), (7, 50, 60)])
def test_epoch_index_chunks_are_jax(start, k, end, tmp_path):
    from pdae_tpu.data import Loader as JaxLoader
    from pdae_tpu.data import build_dataset as jax_dataset
    from pdae_tpu.parallel import make_mesh

    cfg = regular_cfg(transfer_uint8=True, device_resident=True)
    tr = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path), device="cpu")
    shim = SimpleNamespace(
        mesh=make_mesh(jax.devices()[:1]), _chunk_schedule=JaxBaseTrainer._chunk_schedule,
        loader=JaxLoader(jax_dataset(cfg["train_dataset_config"]), 8, shuffle=True, seed=0,
                         num_workers=1))
    got = list(tr._resident_index_chunks(start, k, end))
    want = [np.asarray(c) for c in JaxBaseTrainer._resident_index_chunks(shim, start, k, end)]
    assert [c.shape for c in got] == [c.shape for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_the_cadence_refusal_is_jax(tmp_path):
    cfg = regular_cfg()
    cfg["runner_config"].update(steps_per_dispatch=4, display_steps=3)
    tr = RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="multiple of steps_per_dispatch"):
        tr.train(max_steps=8)
    assert tr.step == 0


@pytest.fixture(scope="module")
def stage34(tmp_path_factory):
    root = tmp_path_factory.mktemp("dispatch34")
    build_stage34_artifacts(root)
    return root


def _configs(stage, root):
    if stage == "representation":
        return tiny_pdae_config(**RUNNER_K), RepresentationLearningTrainer, "prediction_loss"
    if stage == "regular":
        return regular_cfg(), RegularDiffusionTrainer, "prediction_loss"
    make, cls, key, sampling = {
        "latent": (latent_cfg, LatentDiffusionTrainer, "prediction_loss", "epoch"),
        "manipulation": (manip_cfg, ManipulationTrainer, "bce_loss", "uniform"),
    }[stage]
    cfg = make(root, extra=dict(RUNNER_K))
    cfg["train_dataset_config"].update(device_resident=True, transfer_uint8=True,
                                       resident_sampling=sampling)
    return cfg, cls, key


def _windows(run, key):
    with open(os.path.join(str(run), "metrics.jsonl")) as f:
        return [(r["step"], r[key]) for r in map(json.loads, f)]


@pytest.mark.parametrize("stage", ["representation", "regular", "latent", "manipulation"])
def test_k4_trains_like_k1(stage, stage34, tmp_path, monkeypatch):
    """K=1 straight to 9 against K=4 straight to 9, and against K=4 to 5 (a
    chunk of 4 and a tail of 1) resumed there to 9 (a realigning chunk of 3
    and a tail of 1)."""
    patch_tiny_encoders(monkeypatch)
    cfg, cls, key = _configs(stage, stage34)

    def trainer(run, k, **kw):
        c = copy.deepcopy(cfg)
        c["runner_config"]["steps_per_dispatch"] = k
        return cls(config=c, run_path=str(tmp_path / run), device="cpu", **kw)

    one = trainer("one", 1)
    assert one.train(max_steps=9) == 9
    four = trainer("four", K)
    assert four.train(max_steps=9, save_on_exit=False) == 9
    assert _windows(tmp_path / "four", key) == _windows(tmp_path / "one", key)
    assert [s for s, _ in _windows(tmp_path / "one", key)] == [4, 8]
    assert_trees_bitwise(four.state_dict(), one.state_dict())

    first = trainer("cut", K)
    assert first.train(max_steps=5) == 5
    resumed = trainer("cut", K, resume="latest")
    assert resumed.start_step == 5
    assert resumed.train(max_steps=9) == 9
    assert _windows(tmp_path / "cut", key)[0] == _windows(tmp_path / "one", key)[0]
    assert_trees_bitwise(resumed.state_dict(), one.state_dict())
    assert resumed.step == one.step == 9


def test_a_reseeded_generator_draws_what_a_fresh_one_draws():
    gen = StepGenerator(7, TRAIN, "cpu")
    for step in (0, 3, 3, 12):
        torch.randn(5, generator=gen.at(step + 1))        # draws of another step
        got = gen.at(step)
        fresh = generator(7, TRAIN, step, "cpu")
        assert torch.equal(torch.randint(0, 1000, (9,), generator=got),
                           torch.randint(0, 1000, (9,), generator=fresh))
        assert torch.equal(torch.randn(4, 3, generator=got), torch.randn(4, 3, generator=fresh))
        assert torch.equal(torch.rand(6, generator=got), torch.rand(6, generator=fresh))


@pytest.mark.parametrize("config", [
    {"name": "Adam", "lr": 1e-2},
    {"name": "Adam", "lr": 1e-2, "adam_betas": "(0.8, 0.99)", "adam_eps": 1e-6},
    {"name": "Adam", "lr": 1e-2, "weight_decay": 0.1},
    {"name": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
], ids=["adam_defaults", "adam", "adam_l2", "adamw"])
def test_the_card_optimizer_matches_optax(config, monkeypatch):
    """``make_optimizer(..., capturable=True)``, PyTorch's formulation for a
    card (its count a tensor, the bias corrections ``1 - beta ** count``
    computed in fp32 as optax computes them), run here on the CPU, which
    PyTorch does not offer: its device check is widened for the test."""
    import torch.optim.adam as torch_adam
    widened = torch_adam._get_capturable_supported_devices() + ["cpu"]
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **kw: widened)
    rs = np.random.RandomState(4)
    p0 = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (s * rs.randn(*v.shape)).astype(np.float32) for k, v in p0.items()}
             for s in (1.0, 1e-6, 1e-2)]
    tx = jax_state.make_optimizer(config)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    optimizer = make_optimizer(config, tp.values(), capturable=True)
    assert optimizer.param_groups[0]["capturable"]
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
        for k, p in tp.items():
            assert isinstance(optimizer.state[p]["step"], torch.Tensor)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert not make_optimizer(config, tp.values()).param_groups[0]["capturable"]


class EagerGraph:
    """Stands in for ``dispatch.StepGraph`` where no card is: the capture
    keeps the body, a replay runs it, so ``GraphDispatch``'s buffers,
    seeding and counts run here as they run around a CUDA graph."""

    captures = 0

    def __init__(self, body, generators, stream, pool=None):
        type(self).captures += 1
        self.body, self.launches = body, {}

    def replay(self):
        self.outputs = self.body()
        return self.outputs


@pytest.mark.parametrize("stage", ["regular", "latent"])
def test_the_graph_dispatcher_trains_like_k1(stage, stage34, tmp_path, monkeypatch):
    """``GraphDispatch`` driven on the CPU with ``EagerGraph``: the copies
    into the static buffers (a host batch with its class ids; a resident
    corpus's epoch index rows, gathered in the body), the streams re-seeded
    before each replay, the count put back after a capture and advanced by
    each replay, and, with ``ema_every`` 2 (regular), one graph with the EMA
    and one without; the first step is the warm-up. K=4 to 5, resumed to 9,
    against K=1 to 9."""
    from pdae_torch.training import dispatch

    patch_tiny_encoders(monkeypatch)
    monkeypatch.setattr(dispatch, "StepGraph", EagerGraph)
    monkeypatch.setattr(dispatch.GraphDispatch, "_side", lambda self, fn: fn())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(BaseTrainer, "_replays", lambda self, k: k > 1)
    cfg, cls, key = _configs(stage, stage34)

    def trainer(run, k, **kw):
        c = copy.deepcopy(cfg)
        c["runner_config"]["steps_per_dispatch"] = k
        return cls(config=c, run_path=str(tmp_path / run), device="cpu", **kw)

    one = trainer("one", 1)
    one.train(max_steps=9)
    assert one._dispatch is None
    first = trainer("cut", K)
    assert first.train(max_steps=5) == 5
    assert first._dispatch.replays == 4 and first.step == 5
    resumed = trainer("cut", K, resume="latest")
    EagerGraph.captures = 0
    assert resumed.train(max_steps=9) == 9
    graphs = resumed._dispatch.graphs
    assert resumed._dispatch.replays == 3 and EagerGraph.captures == len(graphs)
    assert sorted(graphs) == ([False, True] if stage == "regular" else [True])
    assert sorted(resumed._dispatch.static) == (["condition", "x_0"] if stage == "regular"
                                                else ["indices"])
    assert_trees_bitwise(resumed.state_dict(), one.state_dict())
    assert _windows(tmp_path / "cut", key)[0] == _windows(tmp_path / "one", key)[0]
