"""Metric accumulation: per-sample results gathered locally, reduced to
their mean (``pdae_tpu/metrics/base.py``).

The port runs in one process. ``all_gather_results`` is the identity there,
and raises when ``WORLD_SIZE`` says the run has several processes: the
gather across processes is not ported (ROADMAP.md, queue 1 item 15)."""

from __future__ import annotations

import os
from typing import List

import numpy as np


class BaseMetric:
    def __init__(self):
        self.results: List[float] = []

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def all_gather_results(self):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: gathering metric results across processes is not "
                "ported (ROADMAP.md, queue 1 item 15); run the port in one process")

    def compute_metrics(self) -> float:
        return float(np.mean(np.asarray(self.results, np.float64)))

    def __len__(self):
        return len(self.results)
