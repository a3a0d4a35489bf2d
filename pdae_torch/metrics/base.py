"""Metric accumulation: per-sample results gathered locally, merged across
processes by ``all_gather_results`` (``parallel.gather_objects``), reduced
to their mean (``pdae_tpu/metrics/base.py``)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..parallel import gather_objects


class BaseMetric:
    def __init__(self):
        self.results: List[float] = []

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def all_gather_results(self):
        self.results = gather_objects(self.results)

    def compute_metrics(self) -> float:
        return float(np.mean(np.asarray(self.results, np.float64)))

    def __len__(self):
        return len(self.results)
