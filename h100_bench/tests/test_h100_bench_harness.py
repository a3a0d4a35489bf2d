"""The harness on the CPU: discovery by file name, the manifest's shape, the
result line, the check for JAX, and the refusal without a card."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import types

import pytest

from h100_bench import run
from h100_bench.geometry import geometry
from h100_bench.traffic import autoencode, train
from h100_bench.tests.toy import run_toy

MANIFEST = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["h100_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[key]]
    assert all(NAME.match(n) for n in names)
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    workload, config = run.cell_files(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert workload[key] == entry[key]
    assert config["name"] == entry["config"]
    assert hasattr(run.traffic_module(entry["traffic"]), "Cell")
    e2e, per_layer = run.cell_metrics(MANIFEST, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = run.load_json(run.ROOT, config["file"])
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]


@pytest.mark.parametrize("kind", ["train", "autoencode"])
@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_every_configuration_serves_every_traffic(config, kind):
    """One schema: each traffic kind reads what it needs of any configuration
    file, so a new cell is a workload file alone."""
    data = run.load_json(run.ROOT, config["file"])
    workload = next(run.cell_files(w["name"])[0] for w in MANIFEST["workloads"]
                    if w["traffic"] == kind)
    geo = geometry(data)
    assert geo["image_size"] > 0 and geo["compute_dtype"] in ("float32", "bfloat16")
    if kind == "train":
        cfg = train.trainer_config(data, workload)
        assert cfg["dataloader_config"]["train"]["batch_size"] == workload["batch_size"]
        assert cfg["runner_config"]["steps_per_dispatch"] >= 1
    else:
        cell = autoencode.Cell(data, workload, 1, "cpu", run.Setup())
        assert cell.service_config()["image_size"] == geo["image_size"]


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_layer_metric_reader_found_by_name(metric):
    assert callable(run.load_reader(metric))


@pytest.mark.parametrize("loaded, found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["flax.linen"], ["flax"]),
    (["optax"], ["optax"]), (["pdae_tpu.models"], ["pdae_tpu"]), (["jaxlib"], ["jaxlib"]),
    (["pdae_torch", "pdae_torch.models", "jaxtyping", "pdae_tpux"], [])])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, loaded, found):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == found


def test_result_line_keys():
    result = run_toy("celeba64.autoencode")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {"autoencode_imgs_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in result["compared"].values())
    json.dumps(result)


def test_traced_result_line_keys():
    result = run_toy("celeba64.autoencode", trace=True)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in MANIFEST["per_layer"]
             if "celeba64.autoencode" in m["workloads"]}
    assert set(result["metrics"]) <= names


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                           "ffhq128.train", "--seed", "1", "--seconds", "1"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout == ""
