"""The program's own spans in a traced window, beside its device intervals.

The port records spans at its layer boundaries (``pdae_torch.tracing``)
while a profiler records, on the clock of the profiler's timestamps, so a
span and the window's device activities (``record["kernels"]``) compare
without a conversion. Set-up runs no profiler, and the train traffic stops
its profiler after its traced steps, so the spans that ``pdae_torch.
tracing.spans()`` holds after a traced run are those of the traced window.

A program without the tracing module has no spans: ``window_spans`` returns
None and the readers report nothing. One that has it must have recorded one
unit span (a train step, a request) per traced unit.
"""

from __future__ import annotations

import bisect
from typing import List, Optional


def window_spans(record: dict, unit: str) -> Optional[list]:
    """The program's spans of the traced window; None where the program
    records none. Raises unless the spans named ``unit`` number
    ``record["units"]``."""
    try:
        from pdae_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    found = sum(s.name == unit for s in spans)
    if found != record["units"]:
        raise RuntimeError(f"the traced window holds {found} {unit!r} spans for "
                           f"{record['units']} units")
    return spans


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def host_seconds(spans: list, name: str) -> float:
    """Seconds inside the spans named ``name``."""
    return sum(s.seconds for s in named(spans, name))


class Busy:
    """The union of the device's activity intervals, asked how much of a
    stretch of time it covers."""

    def __init__(self, kernels):
        merged: List[list] = []
        for s, e in sorted((s, s + d) for _, s, d in kernels):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]          # busy seconds before each interval
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def _until(self, t: float) -> float:
        """Busy seconds before ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def idle(self, start: float, end: float) -> float:
        """Seconds of ``[start, end]`` that no device activity covers."""
        return (end - start) - (self._until(end) - self._until(start))


def idle_seconds(record: dict, spans: list, name: str) -> float:
    """Device-idle seconds inside the spans named ``name``."""
    busy = Busy(record["kernels"])
    return sum(busy.idle(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in named(spans, name))
