"""Each traffic driver through the harness at the toy sizes on the CPU, on
the port's plain paths: the run completes, counts its work and comes out
correct against the plain reference."""

from __future__ import annotations

import pytest

from h100_bench.tests.toy import run_toy


@pytest.mark.parametrize("cell, metric", [("ffhq128.train", "train_imgs_per_s"),
                                          ("celeba64.autoencode", "autoencode_imgs_per_s")])
def test_cell_runs_correct(cell, metric):
    result = run_toy(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"][metric]["value"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0
