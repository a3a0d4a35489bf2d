"""The traced run's records: ``torch.profiler`` (CPU and CUDA) around the
window, reduced to what the per-layer readers take.

``Trace.begin()`` starts the profiler and opens the ``bench.window`` span;
``end()`` waits for the card, closes the span, stops the profiler and
keeps the record: every device activity (kernels, copies, sets) in the
span as ``(name, start_s, seconds)``, the span's length, the device's busy
seconds in it (the union of the activity intervals), and the breakdown the
result line carries. A traffic driver begins and ends the trace inside its
window (a long window's trace may cover its first part only). Kernels are sorted
into families by name (``category``); the rules are the benchmark's and do
not follow the program's.
"""

from __future__ import annotations

import bisect
import collections
import sys
import time

import torch


WINDOW_SPAN = "bench.window"

_CONV = ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "cudnn",
         "nchwtonhwc", "nhwctonchw", "pointwise_mult_and_sum")



def category(name: str) -> str:
    """The family of a device activity, from its name."""
    n = name.lower()
    if "gn_adagn_silu_bwd" in n or "gn_bwd_dx" in n:
        return "gn_bwd"
    if "gn_adagn_silu" in n or "gn_apply" in n or "gn_stats" in n:
        return "gn_fwd"
    if "attention_fwd" in n:
        return "attention"
    if "multi_tensor" in n or "foreach" in n or "adam" in n:
        return "optimizer"
    if any(s in n for s in _CONV):
        return "conv"
    if "gemm" in n or "gemv" in n or "cutlass" in n:
        return "matmul"
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copy"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def union(intervals):
    """(busy seconds, [(gap start, gap seconds)]) of ``[(start, end)]``."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None:
            busy, end = e - s, e
        elif s > end:
            gaps.append((end, s - end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _events(prof):
    """(device activities, host events). A range the profiler mirrors onto
    the device's timeline from a host annotation (``record_function``)
    carries the host event's name and occupies nothing: it is left out."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), start, dur))
        else:
            host.append((start, start + dur, e.name()))
    names = {name for _, _, name in host}
    return [d for d in device if d[0] not in names], host


def _host_at(host_sorted, starts, t):
    """The innermost host event running at ``t`` (latest start, still open)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 20000), -1):
        s, e, name = host_sorted[j]
        if e >= t:
            return name
    return "host: no event"


class Trace:

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.span = self.record = None

    def begin(self):
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    @property
    def open(self) -> bool:
        return self.span is not None and self.record is None

    def end(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        t = time.perf_counter()
        self.prof.stop()
        stopped = time.perf_counter()
        device, host = _events(self.prof)
        print(f"trace: stop {stopped - t:.1f}s, read {time.perf_counter() - stopped:.1f}s, "
              f"{len(device)} device activities, {len(host)} host events", file=sys.stderr)
        spans = [(s, e) for s, e, name in host if name == WINDOW_SPAN]
        if not spans:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        w0, w1 = spans[0]
        inside = [(n, s, d) for n, s, d in device if s < w1 and s + d > w0]
        clipped = [(max(s, w0), min(s + d, w1)) for _, s, d in inside]
        busy, gaps = union(clipped)
        if clipped:
            first, last = min(s for s, _ in clipped), max(e for _, e in clipped)
            gaps = [(w0, first - w0)] + gaps + [(last, w1 - last)]
        self.record = {"kernels": inside, "window_s": w1 - w0, "busy_s": busy,
                       "breakdown": self._breakdown(inside, gaps, host)}

    @staticmethod
    def _breakdown(kernels, gaps, host) -> dict:
        by_name = collections.defaultdict(float)
        for name, _, d in kernels:
            by_name[name] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        host_sorted = sorted(h for h in host if h[2] != WINDOW_SPAN)
        starts = [h[0] for h in host_sorted]
        idle = collections.defaultdict(float)
        for start, length in sorted(gaps, key=lambda g: -g[1])[:500]:
            idle[_host_at(host_sorted, starts, start + length / 2)] += length
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in top]}


def device_seconds(record: dict, family: str) -> float:
    """Seconds of the traced window's device activities of ``family``."""
    return sum(d for n, _, d in record["kernels"] if category(n) == family)


def roofline(record: dict, family: str, least: str):
    """The least seconds of ``family``'s work in the window (``least``, per
    unit, of the record's counts) as a share of its device seconds, in %;
    None where the window ran none of it."""
    spent = device_seconds(record, family)
    if spent <= 0:
        return None
    return 100.0 * record["counts"][least] * record["units"] / spent


def idle_share(record: dict) -> float:
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def mfu(record: dict) -> float:
    """The window's model FLOPs over its length, as a share of the peak of
    the cell's compute dtype, in %."""
    flops = record["counts"]["model_flops"] * record["units"]
    return 100.0 * flops / record["window_s"] / record["counts"]["peak_flops"]
