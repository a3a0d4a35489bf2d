"""The readers of the program's spans (``h100_bench/spans.py`` and the five
metrics that use it) on synthetic records, and the toy cells' traced runs
on the CPU reporting them."""

from __future__ import annotations

import math
import sys

import pytest

import pdae_torch
from pdae_torch import tracing
from pdae_torch.tracing import Span

from h100_bench import run
from h100_bench.spans import Busy
from h100_bench.tests.toy import run_toy

T0 = 1_790_000_000.0            # an epoch second, as the profiler's clock gives
TRAIN = ("load_ms.train", "dispatch_ms.train", "data_stall_ms.train")
AUTOENCODE = ("solver_host_ms.autoencode", "service_stall_ms.autoencode")


@pytest.fixture(autouse=True)
def ring():
    """No span of another test's traced run in the ring, before or after."""
    tracing.reset()
    yield
    tracing.reset()


def span(name, a, b, key=None, parent=None):
    return Span(name, int(round((T0 + a) * 1e9)), int(round((T0 + b) * 1e9)), parent, key)


def kernels(*intervals):
    return [("k", T0 + a, b - a) for a, b in intervals]


def given(monkeypatch, spans):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))


def test_busy_covers_merged_intervals():
    busy = Busy(kernels((0.0, 1.0), (0.2, 0.7), (2.0, 3.0), (2.5, 3.2)))
    assert busy.idle(T0 - 1.0, T0 + 4.0) == pytest.approx(5.0 - 2.2, abs=1e-6)
    assert busy.idle(T0 + 0.5, T0 + 2.5) == pytest.approx(1.0, abs=1e-6)
    assert busy.idle(T0 + 0.1, T0 + 0.9) == pytest.approx(0.0, abs=1e-6)
    assert Busy([]).idle(T0, T0 + 2.0) == pytest.approx(2.0, abs=1e-6)


def test_train_readers_on_gaps_that_straddle_the_spans(monkeypatch):
    """Two steps: the card busy over [0, 1], [2, 3] and [3.5, 4]; the first
    loader wait [0.5, 2.5] holds the gap [1, 2], the second [2.8, 3.7] the
    gap [3, 3.5]; each gap runs past one end of its span."""
    given(monkeypatch, [
        span("pdae.loader.next", 0.5, 2.5, 1), span("pdae.train.step", 2.5, 2.6, 1),
        span("pdae.loader.next", 2.8, 3.7, 2), span("pdae.train.step", 3.7, 3.9, 2),
        span("pdae.loader.fetch", 0.6, 2.0, 1, "pdae.loader.next")])
    record = {"units": 2, "kernels": kernels((0, 1), (2, 3), (3.5, 4), (0.2, 0.8))}
    got = {m: run.load_reader(m)(record) for m in TRAIN}
    assert got["load_ms.train"] == pytest.approx(1e3 * (2.0 + 0.9) / 2, abs=1e-3)
    assert got["dispatch_ms.train"] == pytest.approx(1e3 * (0.1 + 0.2) / 2, abs=1e-3)
    assert got["data_stall_ms.train"] == pytest.approx(1e3 * (1.0 + 0.5) / 2, abs=1e-3)


def test_autoencode_readers(monkeypatch):
    """Two requests of two evaluations: the card idle over [0, 0.3] (before
    the first request: the caller's), [1.0, 1.2] and [1.9, 2.4], the last
    straddling the second request's start at 2.0."""
    given(monkeypatch, [
        span("pdae.solver.step", 0.5, 0.7, 0, "pdae.service.autoencode"),
        span("pdae.solver.step", 0.7, 1.1, 1, "pdae.service.autoencode"),
        span("pdae.service.autoencode", 0.4, 1.5, 1),
        span("pdae.solver.step", 2.1, 2.2, 0, "pdae.service.autoencode"),
        span("pdae.solver.step", 2.2, 2.5, 1, "pdae.service.autoencode"),
        span("pdae.service.autoencode", 2.0, 2.9, 2)])
    record = {"units": 2, "counts": {"evaluations": 2},
              "kernels": kernels((0.3, 1.0), (1.2, 1.9), (2.4, 3.0))}
    got = {m: run.load_reader(m)(record) for m in AUTOENCODE}
    assert got["solver_host_ms.autoencode"] == pytest.approx(1e3 * 1.0 / 4, abs=1e-3)
    assert got["service_stall_ms.autoencode"] == pytest.approx(1e3 * (0.2 + 0.4) / 2,
                                                               abs=1e-3)


@pytest.mark.parametrize("metric", TRAIN + AUTOENCODE)
def test_a_span_count_other_than_the_units_raises(monkeypatch, metric):
    given(monkeypatch, [
        span("pdae.loader.next", 0.0, 0.1, 1), span("pdae.train.step", 0.1, 0.2, 1),
        span("pdae.solver.step", 0.3, 0.4, 0), span("pdae.service.autoencode", 0.3, 0.5, 1)])
    record = {"units": 2, "counts": {"evaluations": 1}, "kernels": kernels((0, 1))}
    with pytest.raises(RuntimeError, match="spans"):
        run.load_reader(metric)(record)


def test_solver_spans_other_than_the_evaluations_raise(monkeypatch):
    given(monkeypatch, [span("pdae.solver.step", 0.1, 0.2, 0),
                        span("pdae.service.autoencode", 0.0, 0.5, 1)])
    record = {"units": 1, "counts": {"evaluations": 2}, "kernels": []}
    with pytest.raises(RuntimeError, match="evaluations"):
        run.load_reader("solver_host_ms.autoencode")(record)


@pytest.mark.parametrize("metric", TRAIN + AUTOENCODE)
def test_a_program_without_spans_reports_nothing(monkeypatch, metric):
    """The parent of the tracing module: no ``pdae_torch.tracing``."""
    monkeypatch.delattr(pdae_torch, "tracing")
    monkeypatch.setitem(sys.modules, "pdae_torch.tracing", None)
    record = {"units": 2, "counts": {"evaluations": 2}, "kernels": kernels((0, 1))}
    assert run.load_reader(metric)(record) is None


@pytest.mark.parametrize("cell, metrics", [("ffhq128.train", TRAIN),
                                           ("celeba64.autoencode", AUTOENCODE)])
def test_toy_traced_cells_report_the_span_metrics(cell, metrics):
    result = run_toy(cell, trace=True)
    for m in metrics:
        value = result["metrics"][m]["value"]
        assert math.isfinite(value) and value >= 0 and result["metrics"][m]["unit"] == "ms"
    assert result["correct"]
