"""The control comes out as not correct: the plain reference in the
program's place, one precision below the configuration's (fp8 operands for
the bf16 train cell, TF32 for the fp32 autoencode cell), fails at least
one of the cell's limits. At the toy sizes on the CPU (TF32 by operand
rounding), and at the cell's own sizes on the card (``cuda``)."""

from __future__ import annotations

import pytest
import torch

from h100_bench import control, run
from h100_bench.tests.toy import SEED, toy_cell

CELLS = ("ffhq128.train", "celeba64.autoencode")


def _readings(workload, config, seed, device):
    if workload["traffic"] == "train":
        return control.train_control(config, workload, seed, device)["control_fp8"]
    return control.autoencode_control(config, workload, seed, device,
                                      requests=3)["control_tf32"]


def _fails(readings, limits) -> bool:
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_control_fails_toy(cell, seed):
    workload, config = toy_cell(cell)
    readings = _readings(workload, config, seed, torch.device("cpu"))
    assert _fails(readings, workload["limits"]), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own sizes runs on the card")
    workload, config = run.cell_files(cell)
    readings = _readings(workload, config, SEED, torch.device("cuda", 0))
    assert _fails(readings, workload["limits"]), readings
