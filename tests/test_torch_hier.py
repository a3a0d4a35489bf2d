"""FSDP's hierarchical layout in the port (``runner_config.mesh_layout:
hier``), live on the CPU: gloo ranks (``tests/_torch_hier_worker.py``,
started with torchrun's environment) at the tiny geometries of
``tests/test_torch_fsdp.py``, one thread each.

Held here:

* the grid: ``parallel.hier_coords`` equals ``make_hier_mesh``'s for
  ``[2, 2]``, ``[2, 4]``, ``[1, 4]`` and ``[4, 1]``; a leaf's dim under
  ``hier`` is ``pdae_tpu``'s ``fsdp_sharding(..., axis_name=ICI_AXIS)``'s (it
  must divide a row, not the world); ``auto`` picks ``hier`` exactly where
  ``pdae_tpu``'s condition does with a host the ranks of one
  ``LOCAL_WORLD_SIZE``; a ``hier_shape`` that does not cover the world and
  an uneven ``LOCAL_WORLD_SIZE`` raise ``ValueError``;
* four ranks at ``hier_shape: [2, 2]`` under ``fsdp``: one representation
  step against ``pdae_tpu``'s under ``make_hier_mesh((2, 2))`` on four of the
  eight CPU devices (loss rtol 1e-4, each gradient within 1e-5 times its
  largest |gradient| plus 1e-8, params atol 1e-5), each rank's blocks the
  ``ici`` shards of JAX's leaves and row 0's covering every leaf; the four
  trainers within ``tests/test_torch_ddp.py``'s tolerances of
  ``replicated`` at world 4, every parameter the plan holds its placeholder
  between steps; ``steps_per_dispatch: 2`` bit-equal to 1; a sharded save
  written by row 0 alone, read by ``pdae_tpu`` as the full checkpoint, and a
  resume from it bit-equal;
* two ranks: ``[1, 2]`` bit-equal to flat ``fsdp``, ``[2, 1]`` to
  ``replicated``.
"""

import copy
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdae_torch import parallel
from pdae_torch.training.base import mesh_layout
from pdae_torch.utils import load_checkpoint
from pdae_torch.utils.sharded_checkpoint import _read, flatten_dict
from pdae_tpu.parallel import (ICI_AXIS, data_sharding, fsdp_sharding, fsdp_shardings,
                               make_hier_mesh)
from pdae_tpu.utils import sharded_checkpoint as jax_sharded
from test_stage34_sharded import build_stage34_artifacts
from test_torch_ddp import LOSS_RTOL, PARAM_ATOL, SCALED_ATOL, _configs, _parity_inputs
from test_torch_fsdp import EDGE_SHAPES, FINAL_DENSE, MANIP_MIN_SIZE, MIN_SIZE
from test_torch_tp import _finish, _start
from test_torch_training import (DIFFUSION, EMA_DECAY, LATENT, OPT, SIZE, TINY_DPM, _Jax,
                                 _assert_groups_close)

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
STEPS = {"representation": 3, "regular": 4, "latent_epoch": 3, "manipulation": 3}


# -- the grid and the rule -------------------------------------------------------- #

@pytest.mark.parametrize("grid", [(2, 2), (2, 4), (1, 4), (4, 1)], ids=str)
def test_hier_coords_equal_make_hier_mesh(grid):
    rows, cols = grid
    mesh = make_hier_mesh(grid)
    world = rows * cols
    assert mesh.devices.shape == grid
    for r in range(world):
        row, col = parallel.hier_coords(r, world, rows, cols)
        assert mesh.devices[row, col] == jax.devices()[r]


RULE_CASES = [((3, 3, 64, 128), 256), ((4, 9), 4)] + [(s, MIN_SIZE) for s in EDGE_SHAPES]


@pytest.mark.parametrize("grid", [(2, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("case", RULE_CASES, ids=str)
def test_the_hier_dim_is_pdae_tpus_ici_spec(case, grid):
    """A leaf shards over a host's row: its dim divides ``cols``, not the
    world (``tests/test_fsdp.py``'s two cases, then the edge shapes)."""
    shape, min_size = case
    spec = fsdp_sharding(make_hier_mesh(grid), shape, axis_name=ICI_AXIS,
                         min_size=min_size).spec
    dims = [i for i, s in enumerate(spec) if s is not None]
    assert all(spec[i] == ICI_AXIS for i in dims)
    assert parallel.fsdp_dim(shape, grid[1], min_size) == (dims[0] if dims else None)


AUTO = [("fsdp", 4, 2), ("fsdp", 8, 2), ("fsdp", 8, 4), ("fsdp", 4, 4), ("fsdp", 4, 1),
        ("fsdp", 1, 1), ("replicated", 4, 2), ("fsdp+tp", 4, 2), ("fsdp+sp", 4, 2),
        ("tp", 4, 2)]


@pytest.mark.parametrize("case", AUTO, ids=str)
def test_auto_picks_hier_where_pdae_tpu_does(case):
    """``pdae_tpu`` picks ``hier`` for ``fsdp`` over more than one process of
    more than one local device; a port host is ``LOCAL_WORLD_SIZE`` ranks."""
    sharding, world, local = case
    hosts = world // local
    want = "hier" if sharding == "fsdp" and hosts > 1 and local > 1 else "flat"
    cfg = {"runner_config": {"param_sharding": sharding}}
    layout, grid = mesh_layout(cfg, world, local)
    assert layout == want
    assert grid == ((hosts, local) if want == "hier" else None)


def test_a_grid_that_does_not_cover_the_world_is_refused():
    cfg = {"runner_config": {"param_sharding": "fsdp", "mesh_layout": "hier"}}
    with pytest.raises(ValueError, match="uneven device count per process"):
        mesh_layout(cfg, 4, 3)
    for shape in ([3, 1], [2, 3], [0, 4]):
        cfg["runner_config"]["hier_shape"] = shape
        with pytest.raises(ValueError, match=re.escape(f"hier_shape={shape}") + ".*world of 4"):
            mesh_layout(cfg, 4, 2)
    cfg["runner_config"]["hier_shape"] = [1, 4]
    assert mesh_layout(cfg, 4, 2) == ("hier", (1, 4))
    with pytest.raises(ValueError, match="does not cover"):
        parallel.hier_coords(0, 4, 3, 1)


# -- the live runs ----------------------------------------------------------------- #

def _mode(cfg, name, mode, grid=None, **extra):
    cfg = copy.deepcopy(cfg)
    if mode != "replicated":
        min_size = MANIP_MIN_SIZE if name == "manipulation" else MIN_SIZE
        cfg["runner_config"].update(param_sharding="fsdp", fsdp_min_size=min_size)
    if grid is not None:
        cfg["runner_config"].update(mesh_layout="hier", hier_shape=list(grid))
    cfg["runner_config"].update(extra)
    return cfg


def _jobs4(root, configs, inputs):
    # a rank's share of the 24 regular images holds one micro-batch of 4
    configs = {**configs, "regular": _mode(configs["regular"], "regular", "replicated",
                                           num_iterations=1)}
    jobs = [{"kind": "parity", "name": "parity", "inputs": inputs, "latent": LATENT,
             "size": SIZE, "dpm": TINY_DPM, "optimizer": OPT, "diffusion": DIFFUSION,
             "ema_decay": EMA_DECAY, "min_size": MIN_SIZE, "grid": [2, 2]}]
    for name, steps in STEPS.items():
        for mode in ("hier", "replicated"):
            grid = (2, 2) if mode == "hier" else None
            cfg = _mode(configs[name], name, mode, grid)
            job = {"kind": "trainer", "name": f"{name}_{mode}", "config": cfg, "steps": steps,
                   "root": str(root / f"{name}_{mode}")}
            if name == "regular" and mode == "hier":
                cfg["runner_config"].update(checkpoint_format="sharded",
                                            save_latest_every_steps=2)
                job.update(copy_at=2, copy_to=str(root / "regular_step2.sharded"),
                           switch=True, sharded_copy=str(root / "regular_step4.sharded"),
                           full_copy=str(root / "regular_step4.ckpt"))
            jobs.append(job)
    k2 = _mode(configs["regular"], "regular", "hier", (2, 2), steps_per_dispatch=2,
               display_steps=2)
    jobs.append({"kind": "trainer", "name": "regular_hier_k2", "config": k2,
                 "steps": STEPS["regular"], "root": str(root / "regular_hier_k2")})
    resume = _mode(configs["regular"], "regular", "hier", (2, 2),
                   checkpoint_format="sharded")
    jobs.append({"kind": "trainer", "name": "regular_hier_resume", "config": resume,
                 "steps": STEPS["regular"], "root": str(root / "regular_hier_resume"),
                 "resume": str(root / "regular_step2.sharded")})
    return jobs


def _jobs2(root, configs):
    jobs = []
    for tag, mode, grid in (("row", "fsdp", (1, 2)), ("flat", "fsdp", None),
                            ("column", "fsdp", (2, 1)), ("replicated", "replicated", None)):
        jobs.append({"kind": "trainer", "name": f"w2_regular_{tag}",
                     "config": _mode(configs["regular"], "regular", mode, grid),
                     "steps": 3, "root": str(root / f"w2_regular_{tag}")})
    return jobs


def _jax_step_under_hier_mesh(jx, inputs):
    """``pdae_tpu``'s step over the parity batch under ``make_hier_mesh((2,
    2))``: the state laid out by ``fsdp_shardings`` over ``ici``, the batch
    over both axes. Returns the step's results and the laid-out params."""
    data = torch.load(inputs, weights_only=False)
    x, noise = (jnp.asarray(data[k].permute(0, 2, 3, 1).numpy()) for k in ("x", "noise"))
    mesh = make_hier_mesh((2, 2))
    state = jx.new_state()
    state = jax.device_put(state, fsdp_shardings(mesh, state, axis_name=ICI_AXIS,
                                                 min_size=MIN_SIZE))
    batch = jax.device_put((x, jnp.asarray(data["t"].numpy()), noise), data_sharding(mesh))
    with mesh:
        new, loss, grads = jax.jit(jx.step.__wrapped__)(state, *batch)
    return {"loss": float(loss), "grads": jax.device_get(grads),
            "params": jax.device_get(new.params), "placed": state.params, "mesh": mesh}


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    root = tmp_path_factory.mktemp("hier")
    build_stage34_artifacts(root)
    configs = _configs(root)
    for cfg in configs.values():
        cfg["dataloader_config"]["eval"]["num_generations"] = 2
    jx = _Jax()
    inputs, _ = _parity_inputs(root, jx)
    t0 = time.perf_counter()
    started4 = _start(root, _jobs4(root, configs, inputs), 4, "w4",
                      worker="_torch_hier_worker.py")
    started2 = _start(root, _jobs2(root, configs), 2, "w2", worker="_torch_hier_worker.py")
    jax_want = _jax_step_under_hier_mesh(jx, inputs)
    outs = {"w4": _finish(started4), "w2": _finish(started2)}
    seconds = time.perf_counter() - t0

    def dumps(name, world):
        return [torch.load(root / f"{name}_rank{r}.pt", weights_only=False)
                for r in range(world)]
    yield {"root": root, "outs": outs, "dumps": dumps, "jax": jax_want, "seconds": seconds}


def _grouped(flat):
    out = {"encoder": {}, "shift": {}}
    for key, v in flat.items():
        g, k = key.split(".", 1)
        out[g][k] = v
    return out


def test_one_hier_step_matches_pdae_tpus_step_under_make_hier_mesh(live):
    want = live["jax"]
    got_all = live["dumps"]("parity", 4)
    for got in got_all:
        assert got["sharded"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=RTOL)
        _assert_groups_close(_grouped(got["grads"]), want["grads"], atol=ATOL, rtol=RTOL,
                             scaled=True)
        _assert_groups_close(_grouped(got["params"]), want["params"], atol=ATOL)
    for got in got_all[1:]:
        assert all(torch.equal(got["params"][k], got_all[0]["params"][k])
                   for k in got["params"])


def test_each_ranks_blocks_are_the_ici_shards_of_jaxs_leaves(live):
    """Rank r at ``(row, col)`` holds what the device at that place of the
    ``[dcn, ici]`` mesh holds of every leaf (the named ``final_dense``
    aside, whose out dim the port splits), and the ranks of row 0 together
    hold every leaf whole."""
    want, mesh = live["jax"]["placed"], live["jax"]["mesh"]
    got_all = live["dumps"]("parity", 4)
    sharded = 0
    for rank, got in enumerate(got_all):
        row, col = got["place"]
        assert (row, col) == parallel.hier_coords(rank, 4, 2, 2)
        device = mesh.devices[row, col]
        assert [list(e) for e in got["exceptions"]] == [["encoder/" + FINAL_DENSE, 0, 1]]
        for group in ("encoder", "shift"):
            mine = flatten_dict(got["blocks"][group])
            for path, leaf in flatten_dict(want[group]).items():
                if path == FINAL_DENSE:
                    continue
                shard = next(s for s in leaf.addressable_shards if s.device == device)
                np.testing.assert_array_equal(np.asarray(mine[path]), np.asarray(shard.data),
                                              err_msg=f"{group}/{path}")
                sharded += not leaf.sharding.is_fully_replicated
    assert sharded > 0
    # row 0 (ranks 0 and 1) covers every leaf
    for group in ("encoder", "shift"):
        for path, leaf in flatten_dict(want[group]).items():
            if path == FINAL_DENSE or leaf.sharding.is_fully_replicated:
                continue
            dim = next(i for i, s in enumerate(leaf.sharding.spec) if s is not None)
            parts = [np.asarray(flatten_dict(got_all[r]["blocks"][group])[path])
                     for r in (0, 1)]
            np.testing.assert_array_equal(np.concatenate(parts, axis=dim), np.asarray(leaf))


@pytest.mark.parametrize("name", list(STEPS))
def test_hier_trains_what_replicated_trains_at_world_four(live, name):
    got_all, want = live["dumps"](f"{name}_hier", 4), live["dumps"](f"{name}_replicated", 4)[0]
    assert [o[f"{name}_hier"]["layout"] for o in live["outs"]["w4"]] == ["hier"] * 4
    for got in got_all:
        assert got["count"] == want["count"] == STEPS[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for key, ts in want["tensors"].items():
            for i, (x, w) in enumerate(zip(got["tensors"][key], ts)):
                atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
                np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                           err_msg=f"{name} {key} [{i}]")
        assert got["losses"] == got_all[0]["losses"]


@pytest.mark.parametrize("name", list(STEPS))
def test_hier_holds_blocks_of_a_row_between_steps(live, name):
    """Between steps every tensor the plan holds is its placeholder, each
    held leaf is split over a row of 2 (its dim divides 2), and a rank's
    bytes are the reckoning from the leaves: half of a held leaf, the whole
    of the others."""
    for got in live["dumps"](f"{name}_hier", 4):
        rest = got["at_rest"]
        assert not rest["whole"] and rest["held"]
        trained = frozen = 0
        for group, _, shape, flax_dim, torch_dim in rest["leaves"]:
            n = int(np.prod(shape)) * 4
            if torch_dim is not None:
                assert shape[flax_dim] % 2 == 0
                n //= 2
            if group in ("trunk", "frozen_encoder", "frozen_decoder"):
                frozen += n
            else:
                trained += n
        held = rest["held_bytes"]
        assert held["trained_blocks"] + held["trained_whole"] == trained
        assert held["frozen_blocks"] + held["frozen_whole"] == frozen
        assert (frozen > 0) == (name != "regular")


def test_steps_per_dispatch_two_is_bit_equal_to_one(live):
    for a, b in zip(live["dumps"]("regular_hier", 4), live["dumps"]("regular_hier_k2", 4)):
        assert a["losses"] == b["losses"]
        for key, ts in a["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(ts, b["tensors"][key])), key


def test_row_zero_writes_the_blocks_and_pdae_tpu_reads_the_full_checkpoint(live):
    d = str(live["root"] / "regular_step4.sharded")
    full = load_checkpoint(str(live["root"] / "regular_step4.ckpt"))
    got = jax_sharded.load_sharded_checkpoint(d)
    assert sorted(flatten_dict(got)) == sorted(flatten_dict(full))
    for path, leaf in flatten_dict(full).items():
        np.testing.assert_array_equal(np.asarray(flatten_dict(got)[path]), np.asarray(leaf),
                                      err_msg=path)
    names = sorted(n for n in os.listdir(d) if n.startswith("shard-"))
    assert names == [f"shard-4-{r:05d}-of-00004.msgpack" for r in range(4)]
    pieces = [_read(os.path.join(d, n)) for n in names]
    written = [sum(len(p) for p in shard.values()) for shard in pieces]
    assert written[0] > 0 and written[1] > 0 and written[2:] == [0, 0]


def test_a_resume_from_the_hier_directory_is_bit_equal(live):
    through = live["dumps"]("regular_hier", 4)
    resumed = live["dumps"]("regular_hier_resume", 4)
    assert [o["regular_hier_resume"]["step"] for o in live["outs"]["w4"]] == [4] * 4
    for a, b in zip(through, resumed):
        assert b["losses"] == a["losses"][2:]
        for key, ts in a["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(ts, b["tensors"][key])), key


@pytest.mark.parametrize("pair", [("row", "flat"), ("column", "replicated")], ids=str)
def test_one_row_is_fsdp_and_one_column_is_replicated(live, pair):
    """``[1, 2]`` is flat ``fsdp`` over the two ranks; ``[2, 1]`` holds whole
    blocks and averages them over the column: ``replicated``'s bits."""
    got, want = pair
    outs = live["outs"]["w2"]
    assert [o[f"w2_regular_{got}"]["layout"] for o in outs] == ["hier"] * 2
    for a, b in zip(live["dumps"](f"w2_regular_{got}", 2),
                    live["dumps"](f"w2_regular_{want}", 2)):
        assert a["losses"] == b["losses"]
        for key, ts in b["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(a["tensors"][key], ts)), key
    assert outs[0][f"w2_regular_{got}"]["sharded"] > 0


def test_the_live_runs_stay_in_their_budget(live):
    assert live["seconds"] < 150, live["seconds"]
