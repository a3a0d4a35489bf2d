"""Run one cell of the benchmark on the card and print its result line.

    python3 -m h100_bench.run --workload NAME --seed N --seconds S --trace 0|1

The cell is ``workloads/NAME.json``: its configuration (``configs/``), its
traffic kind (``traffic/<kind>.py``, which drives the program) and the
kind's parameters. The run makes the inputs and weights from ``--seed``,
sets up and warms up (``setup_s``: from the process's start to the window),
measures for ``--seconds``, then checks what the window produced against
the plain reference (``reference/``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, each read by ``layer_metrics/<name>.py``
from a ``torch.profiler`` trace of the window), ``device``, ``breakdown``
(traced runs) and, last, ``compared``: each number checked, with its limit.
The same numbers end standard error. Which metrics a cell reports comes
from ``BENCHMARK.json``.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; with JAX, flax, optax or ``pdae_tpu`` loaded once the
window has closed, it exits 3.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock: now, less its
    age from /proc (clock ticks since boot against the uptime); now where
    /proc cannot say."""
    now = time.perf_counter()
    try:
        import os
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - started)


_T0 = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from .trace import Trace  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pdae_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(name: str):
    """(workload, configuration) of the cell ``name``, found by file name."""
    workload = load_json(BENCH, "workloads", f"{name}.json")
    return workload, load_json(BENCH, "configs", f"{workload['config']}.json")


def cell_metrics(manifest: dict, name: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that the
    cell ``name`` reports: those listing it, or listing no cells."""
    def mine(m):
        return name in m.get("workloads", [name])
    return ([m for m in manifest["end_to_end"] if mine(m)],
            [m for m in manifest["per_layer"] if mine(m)])


def load_reader(metric: str):
    """``read(record) -> float | None`` of ``layer_metrics/<metric>.py``."""
    path = os.path.join(BENCH, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def traffic_module(kind: str):
    return importlib.import_module(f"h100_bench.traffic.{kind}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fix_cache_dirs() -> None:
    """The build and kernel caches inside the checkout, at fixed paths (the
    port's nvcc libraries already live in ``pdae_torch/_build``)."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


class Setup:
    """Where set-up went: ``part(name)`` times a stretch of it."""

    def __init__(self):
        self.parts = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t

    def line(self, total: float) -> str:
        named = " ".join(f"{k}={v:.3f}s" for k, v in self.parts.items())
        rest = total - sum(self.parts.values())
        return f"setup: total={total:.3f}s {named} imports_and_other={rest:.3f}s"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             workload: dict = None, config: dict = None, manifest: dict = None,
             t0: float = _T0) -> dict:
    """Set up, measure and check one cell; returns the result line's object.
    ``workload``, ``config`` and ``manifest`` default to the cell's files."""
    if workload is None:
        workload, config = cell_files(name)
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    e2e, per_layer = cell_metrics(manifest, name)
    on_card = device.type == "cuda"
    setup = Setup()
    setup.parts["harness_imports"] = time.perf_counter() - t0
    cell = traffic_module(workload["traffic"]).Cell(config, workload, seed, device, setup)
    cell.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    print(setup.line(setup_s), file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Trace() if trace else None
    out = cell.window(seconds, tracer)
    if tracer is not None and tracer.open:
        tracer.end()
    record = tracer.record if tracer else None
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    window_reserved = torch.cuda.max_memory_reserved(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    compared = cell.check()
    counts = cell.counts() if trace else None
    del cell
    gc.collect()

    result_metrics = {}
    if trace:
        record.update(units=out["traced_units"], counts=counts, config=config,
                      workload=workload, window_reserved_bytes=window_reserved)
        for m in per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in e2e:
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct = (out["failed"] == 0 and
               all(math.isfinite(v) and v <= lim for v, lim in compared.values()))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": result_metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": int(workload["chips"]),
                         "memory_peak_bytes": int(max(peak, window_peak))}}
    if trace:
        result["device"].update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, _ = cell_files(args.workload)
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {found}",
              file=sys.stderr)
        return 2
    fix_cache_dirs()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}, which it may not", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
