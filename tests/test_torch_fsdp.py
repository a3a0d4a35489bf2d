"""FSDP in the port (``param_sharding: fsdp``) and the sharded checkpoint
write (``checkpoint_format: sharded``), live on the CPU: two ranks over a
gloo tensor group (``tests/_torch_fsdp_worker.py``, started with torchrun's
environment, sharing one run directory) at tiny geometries (16px gray, b4 a
rank, ``fsdp_min_size`` 256; 64 for the manipulation classifier, whose
``Linear(16, 5)`` has 80 elements).

Held here:

* the rule: ``parallel.fsdp_dim`` equals ``pdae_tpu``'s ``fsdp_sharding``
  spec at worlds 1, 2 and 4 on edge shapes and on every flax leaf of the
  tiny PDAE, regular, latent and manipulation trees, and the plan's flax dim
  equals it on every trained leaf but one, named: the encoder's
  ``final_dense/kernel``, whose JAX dim 0 (H*W*C) is strided in the torch
  weight, so the plan shards its ``out`` dim (torch dim 0);
* all four trainers under ``fsdp`` at world 2 bit-equal to the same runs
  under ``replicated`` (every loss, and the params, EMA, Adam moments and
  count, the sharded ones gathered): a sum of two values does not depend on
  their order, and Adam and the EMA are elementwise; within
  ``tests/test_torch_ddp.py``'s tolerances of one process over the global
  batch; the two-rank step under a plan with injected draws within
  ``tests/test_torch_training.py``'s tolerances of ``pdae_tpu``'s step over
  the global batch;
* each rank holding only its blocks: its EMA and moments have the sum over
  the trained tensors of numel / 2 (sharded) or numel (whole) elements;
  between steps every trained and frozen tensor the plan shards is its
  placeholder (ZeRO-3: gathered per use), the rank's bytes of parameters
  the rule's reckoning, and the frozen modules' blocks (the trunk, the
  latent and manipulation stages' frozen encoder and decoder)
  ``pdae_tpu``'s ``_place_frozen`` shards on a 2-device mesh, bit-equal
  across steps; the representation run under ``remat: full`` and bf16
  bit-equal to ``replicated``;
* the sharded write at world 2: the manifest and the two step-tagged shard
  files only, read by ``pdae_tpu``'s ``load_sharded_checkpoint`` bit-equal
  to the port's full checkpoint of the same step, the manifest's leaves
  ``pdae_tpu``'s ``manifest_skeleton`` of that tree, and the pieces of the
  trained leaves JAX's for a 2-device mesh but the named ``final_dense``;
* a world-2 resume from the step-2 directory bit-equal; one process under
  ``replicated`` resumed from it within the tolerances of one process; a
  full save over the directory and a sharded one over the file;
* a failed shard write on the primary stops both ranks at the consensus
  step, then raises on the primary;
* in one process: the format switch both ways, an in-place re-save that
  keeps the old manifest until the new one lands, a foreign directory
  refused, and the ``.swap`` heal of both switches.
"""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import TRAINER_DPM, patch_tiny_encoders
from pdae_torch import parallel
from pdae_torch.data.pipeline import batch_to_device
from pdae_torch.models import (SemanticEncoder, build_classifier, build_decoder,
                               build_denoise_fn, build_latent_denoise_fn)
from pdae_torch.train import pick_trainer
from pdae_torch.training import RegularDiffusionTrainer
from pdae_torch.training.artifacts import load_pdae
from pdae_torch.training.fsdp import layout
from pdae_torch.training.partition import split_shift_tree
from pdae_torch.utils import (classifier_tree, encoder_tree, load_checkpoint,
                              mlp_skip_net_tree, unet_tree)
from pdae_torch.utils.sharded_checkpoint import (_read, flatten_dict, is_sharded_checkpoint,
                                                 load_sharded_checkpoint)
from pdae_tpu.parallel import fsdp_sharding, make_mesh
from pdae_tpu.utils import sharded_checkpoint as jax_sharded
from pdae_tpu.utils import save_sharded_checkpoint as jax_save_sharded
from test_torch_ddp import (LOSS_RTOL, MB, PARAM_ATOL, SCALED_ATOL, WORLD, _configs,
                            _control, _host_global_batches, _parity_inputs, _run_world2,
                            _state)
from test_stage34_sharded import build_stage34_artifacts
from test_torch_training import (DIFFUSION, EMA_DECAY, LATENT, OPT, SIZE, TINY_DPM, _Jax,
                                 _assert_groups_close)

torch.set_num_threads(1)
MIN_SIZE, MANIP_MIN_SIZE = 256, 64
STEPS = {"representation": 4, "regular": 3, "latent_epoch": 3, "manipulation": 3}
REMAT_STEPS = 2                  # the representation run under remat full and bf16
EVALS = {"representation": {"ddim_style": "ddim10"},
         "latent_epoch": {"latent_ddim_style": "ddim5", "decoder_ddim_style": "ddim5"},
         "manipulation": {"encode_style": "ddim5", "decode_style": "ddim5", "class_id": 1}}
FINAL_DENSE = "final_dense/kernel"
FROZEN = {"representation": {"trunk"}, "regular": set(),
          "latent_epoch": {"frozen_encoder", "frozen_decoder"},
          "manipulation": {"frozen_encoder", "frozen_decoder"}}


# -- the rule ------------------------------------------------------------------- #

def _jax_dim(shape, world, min_size):
    spec = fsdp_sharding(make_mesh(jax.devices()[:world]), tuple(shape),
                         min_size=min_size).spec
    dims = [i for i, s in enumerate(spec) if s is not None]
    return dims[0] if dims else None


EDGE_SHAPES = [
    (3, 3, 64, 64),      # a tie: the lower dim
    (64, 64),            # a tie
    (33, 35),            # no dim divides 2 or 4
    (255,),              # one element below the minimum
    (256,),              # at the minimum
    (2, 3, 3, 30),       # the largest dim does not divide 4, a smaller one does
    (1, 1, 3, 256),      # dims smaller than the world
    (3, 86),             # divides 2, not 4
    (),                  # a scalar
]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_the_rule_equals_pdae_tpus_on_edge_shapes(shape, world):
    assert parallel.fsdp_dim(shape, world, MIN_SIZE) == _jax_dim(shape, world, MIN_SIZE)


def _tiny_trees():
    """{name: ({group: {torch name: Parameter}}, {group: to_tree})} of the
    tiny trainers' modules."""
    encoder = SemanticEncoder(16, channels=(8, 16), attn_after_stage=2, image_size=16,
                              input_channel=1)
    decoder = build_decoder({"model": "ShiftUNet", "latent_dim": 16}, TRAINER_DPM)
    regular = build_denoise_fn({**TRAINER_DPM, "num_class": 10})
    latent = build_latent_denoise_fn({"model": "MLPSkipNet", "input_channel": 16,
                                      "model_channel": 32, "num_layers": 3,
                                      "time_emb_channel": 8, "use_norm": True,
                                      "dropout": 0.0})
    classifier = build_classifier(5, 16)
    return {"pdae": ({"encoder": dict(encoder.named_parameters()),
                      "decoder": dict(decoder.named_parameters())},
                     {"encoder": encoder_tree, "decoder": unet_tree}),
            "regular": ({"model": dict(regular.named_parameters())}, {"model": unet_tree}),
            "latent": ({"model": dict(latent.named_parameters())},
                       {"model": mlp_skip_net_tree}),
            "manipulation": ({"model": dict(classifier.named_parameters())},
                             {"model": classifier_tree})}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("tree", ["pdae", "regular", "latent", "manipulation"])
def test_the_rule_and_the_plan_on_every_flax_leaf(tree, world):
    """Every flax leaf: the rule's dim is JAX's; the plan's dim is JAX's but
    on the named ``final_dense`` kernel, where it shards the ``out`` dim."""
    params, to_trees = _tiny_trees()[tree]
    min_size = MANIP_MIN_SIZE if tree == "manipulation" else MIN_SIZE
    leaves, exceptions = layout(params, to_trees, world, min_size)
    assert len(leaves) == sum(len(v) for v in params.values())
    for lf in leaves:
        want = _jax_dim(lf.flax_shape, world, min_size)
        assert parallel.fsdp_dim(lf.flax_shape, world, min_size) == want, lf
        if lf.flax_path == FINAL_DENSE:
            assert (want, lf.flax_dim, lf.torch_dim) == (0, 1, 0), lf
        else:
            assert lf.flax_dim == want, lf
    named = [e[0] for e in exceptions]
    assert named == (["encoder/" + FINAL_DENSE] if tree == "pdae" else [])
    if world > 1:
        assert any(lf.torch_dim is not None for lf in leaves)


def test_the_full_width_classifier_stays_whole_at_the_default_minimum():
    classifier = build_classifier(40, 512)
    leaves, _ = layout({"model": dict(classifier.named_parameters())},
                       {"model": classifier_tree}, 2, parallel.FSDP_MIN_SIZE)
    assert [lf.torch_dim for lf in leaves] == [None, None]
    leaves, _ = layout({"model": dict(classifier.named_parameters())},
                       {"model": classifier_tree}, 2, MANIP_MIN_SIZE)
    assert {lf.name: lf.torch_dim for lf in leaves} == {"weight": 1, "bias": None}


# -- the live world-2 runs --------------------------------------------------------- #

def _fsdp(cfg, min_size=MIN_SIZE, **extra):
    cfg = copy.deepcopy(cfg)
    cfg["runner_config"].update(param_sharding="fsdp", fsdp_min_size=min_size, **extra)
    return cfg


def _jobs(root, configs, parity_inputs):
    jobs = [{"kind": "parity", "name": "parity", "inputs": parity_inputs, "latent": LATENT,
             "size": SIZE, "dpm": TINY_DPM, "optimizer": OPT, "diffusion": DIFFUSION,
             "ema_decay": EMA_DECAY, "min_size": MIN_SIZE}]
    for name, steps in STEPS.items():
        min_size = MANIP_MIN_SIZE if name == "manipulation" else MIN_SIZE
        for mode in ("fsdp", "replicated"):
            cfg = configs[name] if mode == "replicated" else _fsdp(configs[name], min_size)
            job = {"kind": "trainer", "name": f"{name}_{mode}", "config": cfg, "steps": steps,
                   "root": str(root / f"{name}_{mode}"), "eval": EVALS.get(name)}
            if name == "representation" and mode == "fsdp":
                cfg["runner_config"]["checkpoint_format"] = "sharded"
                job.update(copy_at=2, copy_to=str(root / "rep_step2.sharded"), switch=True,
                           sharded_copy=str(root / "rep_step4.sharded"),
                           full_copy=str(root / "rep_step4.ckpt"))
            jobs.append(job)
    for mode in ("fsdp", "replicated"):
        cfg = copy.deepcopy(configs["representation"])
        cfg["runner_config"].update(remat="full", compute_dtype="bfloat16")
        jobs.append({"kind": "trainer", "name": f"remat_bf16_{mode}", "steps": REMAT_STEPS,
                     "config": _fsdp(cfg) if mode == "fsdp" else cfg,
                     "root": str(root / f"remat_bf16_{mode}")})
    resume = _fsdp(configs["representation"], checkpoint_format="sharded")
    jobs.append({"kind": "trainer", "name": "representation_resume", "config": resume,
                 "steps": 4, "root": str(root / "representation_resume"),
                 "resume": str(root / "rep_step2.sharded")})
    failing = _fsdp(configs["regular"], checkpoint_format="sharded", num_iterations=1,
                    display_steps=2, save_latest_every_steps=2)
    jobs.append({"kind": "trainer", "name": "fail_writes", "config": failing, "steps": 40,
                 "fail_writes": True, "root": str(root / "fail_writes")})
    return jobs


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    build_stage34_artifacts(root)
    configs = _configs(root)
    jx = _Jax()
    inputs, jax_want = _parity_inputs(root, jx)
    outs, logs = _run_world2(root, _jobs(root, configs, inputs), worker="_torch_fsdp_worker.py")
    names = [f"{n}_{m}" for n in list(STEPS) + ["remat_bf16"] for m in ("fsdp", "replicated")]
    dumps = {name: [torch.load(root / f"{name}_rank{r}.pt") for r in range(WORLD)]
             for name in names + ["representation_resume", "parity", "fail_writes"]}
    controls = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        patch_tiny_encoders(mp)
        for name, steps in STEPS.items():
            trainer, losses = _control(name, configs[name], steps, root / "w1" / name)
            controls[name] = {"losses": losses, "state": _state(trainer), "step": trainer.step}
        # one process, replicated, resumed from the world-2 step-2 directory
        cfg = configs["representation"]
        resumed = pick_trainer(cfg)(config={**cfg, "dataloader_config": {
            **cfg["dataloader_config"], "train": {**cfg["dataloader_config"]["train"],
                                                  "batch_size": WORLD * MB}}},
            run_path=str(root / "w1_resumed"), resume=str(root / "rep_step2.sharded"),
            device="cpu")
        batches = _host_global_batches(cfg, ("x_0",), STEPS["representation"])
        resumed._batch_iterator = lambda start: (batch_to_device(b, "cpu", ("x_0",))
                                                 for b in batches[start:])
        start = resumed.start_step
        resumed.train(max_steps=STEPS["representation"])
        controls["w1_resumed"] = {"state": _state(resumed), "start": start,
                                  "step": resumed.step}
    yield {"root": root, "outs": outs, "logs": logs, "dumps": dumps, "controls": controls,
           "jax": jax_want, "configs": configs}


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_is_bit_equal_to_replicated_at_world_two(live, name):
    for r in range(WORLD):
        a, b = live["dumps"][f"{name}_fsdp"][r], live["dumps"][f"{name}_replicated"][r]
        assert a["count"] == b["count"] == STEPS[name]
        assert a["losses"] == b["losses"]
        assert sorted(a["tensors"]) == sorted(b["tensors"])
        for key, ts in a["tensors"].items():
            for i, (x, y) in enumerate(zip(ts, b["tensors"][key])):
                assert torch.equal(x, y), (r, key, i)
    assert live["dumps"][f"{name}_fsdp"][0]["losses"] == live["dumps"][f"{name}_fsdp"][1][
        "losses"]


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_at_world_two_trains_what_one_process_trains(live, name):
    got, want = live["dumps"][f"{name}_fsdp"][0], live["controls"][name]
    assert got["count"] == want["step"] == STEPS[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for key, ts in want["state"].items():
        for i, (x, w) in enumerate(zip(got["tensors"][key], ts[:4])):
            atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{name} {key} [{i}]")


@pytest.mark.parametrize("name", list(STEPS))
def test_each_rank_holds_only_its_blocks(live, name):
    fsdp, whole = live["dumps"][f"{name}_fsdp"], live["dumps"][f"{name}_replicated"][0]
    sharded = set(fsdp[0]["sharded"])
    assert sharded, name
    want = sum(ts[0].numel() // WORLD if key in sharded else ts[0].numel()
               for key, ts in whole["tensors"].items())
    for r in range(WORLD):
        assert fsdp[r]["sharded"] == fsdp[0]["sharded"]
        assert fsdp[r]["held"] == {"ema": want, "moments": 2 * want}
    assert whole["held"]["ema"] == sum(ts[0].numel() for ts in whole["tensors"].values())
    assert want < whole["held"]["ema"]


# -- blocks at rest ---------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(STEPS))
def test_between_steps_a_sharded_tensor_is_only_its_block(live, name):
    """Every trained and frozen tensor the plan shards is its placeholder
    in its module between steps (its block is the one copy), the frozen
    modules' among them, and a rank's bytes of parameters are the
    reckoning from ``pdae_tpu``'s rule: half of a sharded leaf, the whole of
    the others."""
    min_size = MANIP_MIN_SIZE if name == "manipulation" else MIN_SIZE
    for r in range(WORLD):
        rest = live["dumps"][f"{name}_fsdp"][r]["at_rest"]
        assert not rest["whole"], rest["whole"]
        assert set(rest["frozen_pieces"]) == FROZEN[name]
        assert FROZEN[name] <= {h.split(".")[0] for h in rest["held"]}
        want = {"trained": 0, "frozen": 0}
        for group, _, shape, flax_dim, torch_dim in rest["leaves"]:
            split = parallel.fsdp_dim(shape, WORLD, min_size) is not None
            assert split == (torch_dim is not None)
            n = int(np.prod(shape)) * 4 // (WORLD if split else 1)
            want["frozen" if group in FROZEN[name] else "trained"] += n
        held = rest["held_bytes"]
        assert held["trained_blocks"] + held["trained_whole"] == want["trained"]
        assert held["frozen_blocks"] + held["frozen_whole"] == want["frozen"]
        assert (held["frozen_blocks"] > 0) == bool(FROZEN[name])


def _frozen_trees(live, name):
    """``{group: flax tree}`` of the frozen modules of trainer ``name``."""
    if name == "representation":
        tree = load_checkpoint(str(live["root"] / "representation_replicated" / "checkpoints"
                                   / "latest.ckpt"))
        return {"trunk": split_shift_tree(tree["decoder"])[1]}
    cfg = live["configs"][name]
    _, enc, dec = load_pdae(cfg["trained_representation_learning_config"],
                            cfg["trained_representation_learning_checkpoint"])
    return {"frozen_encoder": enc, "frozen_decoder": dec}


@pytest.mark.parametrize("name", ["representation", "latent_epoch", "manipulation"])
def test_the_frozen_blocks_are_pdae_tpus_place_frozen_shards(live, name):
    """A rank's frozen pieces are what ``_place_frozen`` puts on the device of
    its rank (``fsdp_sharding`` on a 2-device mesh), but the named
    ``final_dense`` of a frozen encoder, and stay bit-equal across steps."""
    min_size = MANIP_MIN_SIZE if name == "manipulation" else MIN_SIZE
    mesh = make_mesh(jax.devices()[:WORLD])
    trees = _frozen_trees(live, name)
    split = 0
    for r in range(WORLD):
        dump = live["dumps"][f"{name}_fsdp"][r]
        rest = dump["at_rest"]
        skip = {tuple(e[0].split("/", 1)) for e in rest["frozen_exceptions"]}
        assert skip == ({("frozen_encoder", FINAL_DENSE)} if name != "representation"
                        else set())
        for group, tree in trees.items():
            mine = rest["frozen_pieces"][group]
            assert sorted(mine) == sorted(flatten_dict(tree))
            for path, leaf in flatten_dict(tree).items():
                assert torch.equal(dump["frozen_at_build"][group][path], mine[path])
                if (group, path) in skip:
                    continue
                placed = jax.device_put(np.asarray(leaf),
                                        fsdp_sharding(mesh, np.shape(leaf), min_size=min_size))
                shard = next(s for s in placed.addressable_shards
                             if s.device == jax.devices()[r])
                np.testing.assert_array_equal(mine[path].numpy(), np.asarray(shard.data),
                                              err_msg=f"{group}/{path}")
                split += not placed.sharding.is_fully_replicated
    assert split > 0


@pytest.mark.parametrize("name", list(EVALS))
def test_the_eval_grid_under_fsdp_is_replicateds(live, name):
    """The eval gathers the EMA and the frozen modules whole for its
    duration (the manipulation eval decodes on the primary alone after
    every rank joined the gathers): the grid's bytes are ``replicated``'s."""
    grids = []
    for mode in ("fsdp", "replicated"):
        d = live["root"] / f"{name}_{mode}" / "samples"
        names = sorted(os.listdir(d))
        assert names == ["sample0k.png"], names
        grids.append((d / names[0]).read_bytes())
    assert grids[0] == grids[1]
    for r in range(WORLD):
        assert not live["dumps"][f"{name}_fsdp"][r]["at_rest"]["whole"]


def test_remat_and_bf16_stay_bit_equal_to_replicated(live):
    """The representation run under ``remat: full`` (the trunk recomputed in
    the backward, its blocks gathered there again) and bf16 compute."""
    for r in range(WORLD):
        a, b = live["dumps"]["remat_bf16_fsdp"][r], live["dumps"]["remat_bf16_replicated"][r]
        assert a["count"] == b["count"] == REMAT_STEPS
        assert a["losses"] == b["losses"]
        for key, ts in a["tensors"].items():
            assert all(torch.equal(x, y) for x, y in zip(ts, b["tensors"][key])), (r, key)
        assert not a["at_rest"]["whole"]


def test_two_fsdp_ranks_match_the_jax_step_over_the_global_batch(live):
    want = live["jax"]
    for r in range(WORLD):
        got = live["dumps"]["parity"][r]
        assert got["sharded"] > 0
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)

        def grouped(flat):
            out = {"encoder": {}, "shift": {}}
            for key, v in flat.items():
                g, k = key.split(".", 1)
                out[g][k] = v
            return out

        _assert_groups_close(grouped(got["grads"]), want["grads"], atol=1e-4, rtol=1e-3,
                             scaled=True)
        _assert_groups_close(grouped(got["params"]), want["params"], atol=2e-5)
    a, b = live["dumps"]["parity"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


# -- the sharded write ---------------------------------------------------------- #

def test_the_sharded_directory_holds_the_manifest_and_two_shard_files(live):
    r0 = live["outs"][0]["representation_fsdp"]
    files = ["manifest.msgpack", "shard-4-00000-of-00002.msgpack",
             "shard-4-00001-of-00002.msgpack"]
    assert r0["latest_files"] == files
    assert sorted(os.listdir(live["root"] / "rep_step2.sharded")) == [
        "manifest.msgpack", "shard-2-00000-of-00002.msgpack", "shard-2-00001-of-00002.msgpack"]
    assert r0["after_full_is_file"] and r0["after_sharded_files"] == files
    assert [o["representation_fsdp"]["exceptions"] for o in live["outs"]] == [
        [["encoder/" + FINAL_DENSE, 0, 1]]] * WORLD
    assert "checkpoints/latest.ckpt/manifest.msgpack" in r0["files"]


def test_pdae_tpu_reads_the_directory_as_the_full_checkpoint(live):
    d = str(live["root"] / "rep_step4.sharded")
    got = jax_sharded.load_sharded_checkpoint(d)
    full = load_checkpoint(str(live["root"] / "rep_step4.ckpt"))
    assert int(full["step"]) == 4

    def same(a, b, path=""):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
            return
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path

    same(got, full)
    same(load_sharded_checkpoint(d), full)
    manifest = _read(os.path.join(d, "manifest.msgpack"))
    assert manifest["world"] == 2
    assert manifest["leaves"] == jax_sharded.manifest_skeleton(got)
    # the sharded save over the full file reads the same tree again
    same(load_checkpoint(str(live["root"] / "representation_fsdp" / "checkpoints"
                             / "latest.ckpt")), full)


def tree_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _pieces(d):
    out = set()
    for name in sorted(os.listdir(d)):
        if name.startswith("shard-"):
            for path, pieces in _read(os.path.join(d, name)).items():
                for p in pieces.values():
                    out.add((path, tuple(p["start"]), np.asarray(p["data"]).shape))
    return out


def test_the_trained_leaves_pieces_are_jaxs_on_two_devices(live):
    """JAX's pieces: the trained leaves of the same tree placed by
    ``fsdp_sharding`` on a 2-device mesh (the rest on the host, written whole
    by process 0), through ``pdae_tpu``'s ``extract_local_shards``."""
    d = str(live["root"] / "rep_step4.sharded")
    tree = load_checkpoint(str(live["root"] / "rep_step4.ckpt"))
    mu = tree["optimizer"]["0"]["mu"]
    trained = {f"{top}/{k}" for top in ("encoder", "ema_encoder") for k in mu["encoder"]}
    trained |= {f"{top}/{k}" for top in ("decoder", "ema_decoder") for k in mu["shift"]}
    trained |= {f"optimizer/0/{m}/{g}/{k}" for m in ("mu", "nu") for g in mu for k in mu[g]}
    mesh = make_mesh(jax.devices()[:2])

    def place(node, path=""):
        if isinstance(node, dict):
            return {k: place(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if any(path == t or path.startswith(t + "/") for t in trained):
            return jax.device_put(node, fsdp_sharding(mesh, np.shape(node), min_size=MIN_SIZE))
        return node

    jax_pieces = {(path, tuple(p["start"]), p["data"].shape)
                  for path, ps in jax_sharded.extract_local_shards(place(tree)).items()
                  for p in ps}
    got = _pieces(d)
    dense = {p for p in got | jax_pieces if p[0].endswith(FINAL_DENSE)}
    assert got - dense == jax_pieces - dense
    assert sum(1 for p in got - dense if p[1] != (0,) * len(p[1])) > 0
    # the named exception: JAX splits dim 0 (H*W*C), the port the out dim
    for path in {p[0] for p in dense}:
        h, w = np.shape(tree_leaf(tree, path))
        assert {(s, sh) for p, s, sh in got if p == path} == {
            ((0, 0), (h, w // 2)), ((0, w // 2), (h, w // 2))}, path
        assert {(s, sh) for p, s, sh in jax_pieces if p == path} == {
            ((0, 0), (h // 2, w)), ((h // 2, 0), (h // 2, w))}, path
    assert len({p[0] for p in dense}) == 4        # encoder, ema_encoder, mu, nu


def test_a_world_two_resume_from_the_sharded_directory_is_bit_equal(live):
    through, resumed = live["dumps"]["representation_fsdp"], live["dumps"][
        "representation_resume"]
    assert [o["representation_resume"]["step"] for o in live["outs"]] == [4, 4]
    assert resumed[0]["losses"] == through[0]["losses"][2:]
    for r in range(WORLD):
        for key, ts in through[r]["tensors"].items():
            for x, y in zip(ts, resumed[r]["tensors"][key]):
                assert torch.equal(x, y), (r, key)


def test_one_replicated_process_resumes_the_world_two_directory(live):
    got, want = live["controls"]["w1_resumed"], live["controls"]["representation"]
    assert (got["start"], got["step"]) == (2, 4)
    for key, ts in want["state"].items():
        for i, (x, w) in enumerate(zip(got["state"][key][:4], ts[:4])):
            atol = PARAM_ATOL if i < 2 else SCALED_ATOL * float(w.abs().max()) + 1e-8
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{key} [{i}]")


def test_a_failed_shard_write_on_the_primary_stops_both_ranks_then_raises(live):
    """Rank 0's shard file of step 2 fails; the ranks agree to stop at the
    next consensus (4), no manifest is written, and rank 0 raises once both
    have left the loop."""
    r0, r1 = (o["fail_writes"] for o in live["outs"])
    assert r1["stopped_at"] == r1["step"] == 4 and r1["error"] is None
    assert r0["stopped_at"] is None and r0["step"] == 4
    assert "sharded checkpoint write failed (the run stopped by consensus)" in r0["error"]
    assert not any(f.endswith("manifest.msgpack") for f in r0["files"])


# -- the sharded write in one process ------------------------------------------------ #

def _regular(tmp_path, monkeypatch, **runner):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = copy.deepcopy(_configs(tmp_path)["regular"])
    cfg["runner_config"].update(num_iterations=1, **runner)
    return cfg


def test_one_process_switches_between_the_formats_both_ways(tmp_path, monkeypatch):
    """full -> sharded over the file, then sharded -> full over the
    directory, each resuming at the step the other saved; the sharded
    directory of one process is every leaf on process 0."""
    run = str(tmp_path / "run")
    latest = os.path.join(run, "checkpoints", "latest.ckpt")
    full = _regular(tmp_path, monkeypatch, save_latest_every_steps=2)
    sharded = _regular(tmp_path, monkeypatch, save_latest_every_steps=2,
                       checkpoint_format="sharded", param_sharding="fsdp")
    tr = RegularDiffusionTrainer(config=full, run_path=run, device="cpu")
    tr.train(max_steps=2)
    assert os.path.isfile(latest)
    tr = RegularDiffusionTrainer(config=sharded, run_path=run, resume="latest", device="cpu")
    assert tr.start_step == 2
    tr.train(max_steps=4)
    tr._join_save()
    assert sorted(os.listdir(latest)) == ["manifest.msgpack",
                                          "shard-4-00000-of-00001.msgpack"]
    assert not os.path.exists(latest + ".swap")
    tree = jax_sharded.load_sharded_checkpoint(latest)
    assert int(tree["step"]) == 4
    np.testing.assert_array_equal(tree["ema_denoise_fn"]["out_conv"]["kernel"],
                                  tr.state_dict()["ema_denoise_fn"]["out_conv"]["kernel"])
    tr = RegularDiffusionTrainer(config=full, run_path=run, resume="latest", device="cpu")
    assert tr.start_step == 4
    tr.train(max_steps=6)
    tr._join_save()
    assert os.path.isfile(latest) and int(load_checkpoint(latest)["step"]) == 6


def test_an_in_place_resave_keeps_the_old_manifest_until_the_new_one_lands(
        tmp_path, monkeypatch):
    """The step-4 shard file lands beside step 2's while the manifest still
    lists step 2's: the directory loads step 2; the new manifest, then the
    stale file removed."""
    import pdae_torch.training.base as port_base
    run = str(tmp_path / "run")
    latest = os.path.join(run, "checkpoints", "latest.ckpt")
    cfg = _regular(tmp_path, monkeypatch, save_latest_every_steps=2,
                   checkpoint_format="sharded")
    tr = RegularDiffusionTrainer(config=cfg, run_path=run, device="cpu")
    tr.train(max_steps=2)
    tr._join_save()
    seen = {}

    def torn(self, targets, skeleton, tag):
        seen["files"] = sorted(os.listdir(latest))
        seen["step"] = int(load_sharded_checkpoint(latest)["step"])
        return finish(self, targets, skeleton, tag)

    finish = port_base.BaseTrainer._finish_sharded
    monkeypatch.setattr(port_base.BaseTrainer, "_finish_sharded", torn)
    tr.train(max_steps=4)
    tr._join_save()
    assert seen == {"files": ["manifest.msgpack", "shard-2-00000-of-00001.msgpack",
                              "shard-4-00000-of-00001.msgpack"], "step": 2}
    assert sorted(os.listdir(latest)) == ["manifest.msgpack",
                                          "shard-4-00000-of-00001.msgpack"]
    assert int(load_sharded_checkpoint(latest)["step"]) == 4


@pytest.mark.parametrize("fmt", ["full", "sharded"])
def test_a_foreign_directory_is_refused(fmt, tmp_path, monkeypatch):
    run = str(tmp_path / "run")
    cfg = _regular(tmp_path, monkeypatch, save_latest_every_steps=2, checkpoint_format=fmt)
    tr = RegularDiffusionTrainer(config=cfg, run_path=run, device="cpu")
    latest = os.path.join(run, "checkpoints", "latest.ckpt")
    os.makedirs(latest)
    with open(os.path.join(latest, "user_data.txt"), "w") as f:
        f.write("not ours")
    with pytest.raises(ValueError, match="refusing to overwrite"):
        tr.train(max_steps=2)
    assert os.listdir(latest) == ["user_data.txt"]


def test_a_sharded_save_over_a_torn_directory_and_the_swap_heal(tmp_path, monkeypatch):
    """A torn directory (shard files, no manifest) takes a sharded save; a
    switch to the sharded format stopped between writing ``latest.ckpt.swap``
    and renaming it is completed by the resume, as the full switch's is."""
    run = str(tmp_path / "run")
    latest = os.path.join(run, "checkpoints", "latest.ckpt")
    cfg = _regular(tmp_path, monkeypatch, save_latest_every_steps=2,
                   checkpoint_format="sharded")
    tr = RegularDiffusionTrainer(config=cfg, run_path=run, device="cpu")
    os.makedirs(latest)
    jax_save_sharded(latest, {"w": np.ones((4, 4), np.float32)}, tag="9")
    os.unlink(os.path.join(latest, "manifest.msgpack"))
    tr.train(max_steps=2)
    tr._join_save()
    assert sorted(os.listdir(latest)) == ["manifest.msgpack",
                                          "shard-2-00000-of-00001.msgpack"]
    # the swap of a switch from the full file, cut before the rename
    os.replace(latest, latest + ".swap")
    tr = RegularDiffusionTrainer(config=cfg, run_path=run, resume="latest", device="cpu")
    assert tr.start_step == 2
    assert is_sharded_checkpoint(latest) and not os.path.exists(latest + ".swap")


def test_a_full_format_fsdp_save_in_one_process_is_the_one_process_file(tmp_path, monkeypatch):
    """Without a tensor group ``fsdp`` is the one-process layout: no plan, and
    the same bits as ``replicated``."""
    files = []
    for mode in ("replicated", "fsdp"):
        cfg = _regular(tmp_path, monkeypatch, save_latest_every_steps=2, param_sharding=mode)
        run = str(tmp_path / mode)
        tr = RegularDiffusionTrainer(config=cfg, run_path=run, device="cpu")
        assert tr.plan is None
        tr.train(max_steps=2)
        tr._join_save()
        with open(os.path.join(run, "checkpoints", "latest.ckpt"), "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]


# -- the pieces around the plan ------------------------------------------------- #

def test_lists_encode_as_flax_encodes_them():
    """The manifest's shapes and the pieces' starts are lists: the port's
    codec writes flax's bytes for them."""
    from flax import serialization
    from pdae_torch.utils import _msgpack
    tree = {"start": [0, 3, 70000], "empty": [], "leaves": {"a": {"shape": [2, 5],
                                                                   "dtype": "float32"}},
            "data": np.arange(6, dtype=np.float32).reshape(2, 3), "flag": True}
    assert _msgpack.packb(tree) == serialization.msgpack_serialize(tree)
    assert _msgpack.unpackb(_msgpack.packb(tree))["start"] == [0, 3, 70000]


def test_local_pieces_take_blocks_and_whole_leaves():
    from pdae_torch.training.fsdp import local_pieces
    skeleton = {"a/w": {"shape": [4, 6], "dtype": "float32"},
                "a/b": {"shape": [6], "dtype": "float32"}}
    tree = {"a": {"w": np.ones((4, 3), np.float32), "b": np.zeros(6, np.float32)}}
    got = local_pieces(tree, skeleton, 1, 2)
    assert [p["start"] for p in got["a/w"]] == [[0, 3]] and got["a/b"] == []
    assert [p["start"] for p in local_pieces(tree, skeleton, 0, 2)["a/b"]] == [[0]]
    with pytest.raises(ValueError, match="a block"):
        local_pieces({"a": {"w": np.ones((2, 3), np.float32), "b": tree["a"]["b"]}},
                     skeleton, 0, 2)


def test_without_a_group_the_collectives_are_the_identity():
    t = [torch.ones(4, 2), torch.zeros(3)]
    assert parallel.tensor_backend() is None
    assert all(a is b for a, b in zip(parallel.gather_full(t, [0, None]), t))


@pytest.mark.parametrize("key,value", [("param_sharding", "zero3"), ("mesh_layout", "ring")])
def test_values_neither_package_takes_are_refused(key, value, tmp_path, monkeypatch):
    cfg = _regular(tmp_path, monkeypatch, **{key: value})
    with pytest.raises(ValueError, match=f"runner_config.{key} must be"):
        RegularDiffusionTrainer(config=cfg, run_path=str(tmp_path / "run"), device="cpu")
