"""Toy versions of the benchmark's cells for the CPU tests: the cells'
files with a two-level-deep 16-channel DPM, 64 px, batches of two and short
solver loops, run through the harness on the CPU (the kernels' plain
versions)."""

from __future__ import annotations

import copy
import time

import torch

from h100_bench import run

TOY_DPM = {"model": "UNet", "input_channel": 3, "base_channel": 16,
           "channel_multiplier": [1, 2, 2], "num_residual_blocks_of_a_block": 1,
           "attention_resolutions": [4], "use_new_attention_order": False, "num_heads": 2,
           "head_channel": -1, "dropout": 0.0}
SEED = 3_000_000_019          # above 2**31, as the benchmark's seeds may be


def toy_cell(name: str):
    """(workload, configuration) of the cell ``name``, cut to the toy sizes."""
    workload, config = (copy.deepcopy(d) for d in run.cell_files(name))
    config["denoise_fn_config"] = dict(TOY_DPM)
    config["train_dataset_config"].update(image_size=64, length=64)
    config["encoder_config"]["model"] = "CELEBA64Encoder"
    config["dataloader_config"]["train"]["num_workers"] = 1
    if workload["traffic"] == "train":
        workload.update(batch_size=2)
    else:
        workload.update(batch=2, encode_style="dpm3", decode_style="dpm3", check_requests=2)
    return workload, config


def run_toy(name: str, seconds: float = 1.0, trace: bool = False, seed: int = SEED) -> dict:
    workload, config = toy_cell(name)
    return run.run_cell(name, seed, seconds, trace, torch.device("cpu"), workload, config,
                        t0=time.perf_counter())
