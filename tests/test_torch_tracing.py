"""``pdae_torch.tracing`` and its spans in place, on the CPU; one test on
the card (marker ``cuda``; it skips without one). Imports no JAX, so the
card test runs as
    python -m pytest --noconftest -q tests/test_torch_tracing.py

Off, a span records nothing and enters no ``record_function``. On, spans
nest with their parents (per thread) and keys, the ring keeps its bound,
and each span's stamps lie within 50 us of the profiler's copy of it (one
clock). On the card a span around ``torch.cuda._sleep`` and a synchronize
contains that kernel's device interval from the same trace. In place: a
dpm2/dpm2 ``autoencode`` gives one solver span per evaluation, with
``prepare`` and ``finish`` inside the request's span (the training loop's
spans: ``tests/test_torch_trainer_loop.py``).
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pdae_torch import tracing
from pdae_torch.models import ShiftUNet, encoder_for_resolution
from pdae_torch.serving import PDAEService

torch.set_num_threads(1)


@pytest.fixture
def ring():
    """An empty ring, tracing off, before and after the test."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def traced(ring):
    tracing.enable()
    yield


def test_off_records_nothing_and_enters_no_record_function(ring, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with tracing.span("a", 1):
        with tracing.span("b"):
            pass
    with tracing.span("timed", 2, timed=True) as timed:
        torch.ones(64).sum()
    assert tracing.spans() == [] and entered == []
    assert timed.seconds > 0


def test_spans_nest_per_thread_with_keys(traced):
    inside = threading.Event()

    def writer():
        with tracing.span("bg", 9):
            with tracing.span("bg.inner"):
                inside.set()

    with tracing.span("outer", 5):
        with tracing.span("inner"):
            t = threading.Thread(target=writer)
            t.start()
            t.join(timeout=30)
        with tracing.span("keyed", 6):
            pass
    assert not t.is_alive() and inside.is_set()
    got = {s.name: (s.parent, s.key) for s in tracing.spans()}
    assert got == {"outer": (None, 5), "inner": ("outer", 5), "keyed": ("outer", 6),
                   "bg": (None, 9), "bg.inner": ("bg", 9)}
    spans = {s.name: s for s in tracing.spans()}
    for child, parent in (("inner", "outer"), ("keyed", "outer"), ("bg.inner", "bg")):
        assert spans[parent].start_ns <= spans[child].start_ns
        assert spans[child].end_ns <= spans[parent].end_ns


def test_a_span_that_raises_is_kept_and_unwinds(traced):
    with pytest.raises(ValueError):
        with tracing.span("outer", 1):
            with tracing.span("fails"):
                raise ValueError("x")
    with tracing.span("after", 2):
        pass
    got = {s.name: (s.parent, s.key) for s in tracing.spans()}
    assert got == {"fails": ("outer", 1), "outer": (None, 1), "after": (None, 2)}


def test_the_ring_keeps_the_newest(traced):
    for i in range(tracing.RING + 10):
        with tracing.span("s", i):
            pass
    spans = tracing.spans()
    assert len(spans) == tracing.RING
    assert [spans[0].key, spans[-1].key] == [10, tracing.RING + 9]
    tracing.reset()
    assert tracing.spans() == []


def _profiled_copies(prof, names):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and e.device_type() != torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_profiler_copy_on_the_same_clock(ring):
    """Under a profiler (no ``enable()``) every span is recorded and has a
    copy in the trace, on the same clock: after a warm-up, each span's start
    and end lie within 50 us of its copy's. A thread the profiler does not
    trace still records its spans in the ring."""
    def untraced_thread():
        with tracing.span("bg", 1):
            torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):                      # record_function's first calls
            with tracing.span("warm", i):
                pass
        for i in range(20):
            with tracing.span("outer", i):
                with tracing.span("inner"):
                    torch.ones(256).sum()
        t = threading.Thread(target=untraced_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = tracing.spans()
    assert [s.name for s in spans].count("bg") == 1
    copies = _profiled_copies(prof, {"outer", "inner", "bg"})
    assert "bg" not in copies
    for name in ("outer", "inner"):
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        assert len(mine) == len(copies[name]) == 20
        for (s0, s1), (p0, p1) in zip(mine, copies[name]):
            assert abs(p0 - s0) < 50_000 and abs(p1 - s1) < 50_000, (name, p0 - s0, s1 - p1)
    assert all(s.parent == "outer" for s in spans if s.name == "inner")


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_the_card(ring):
    """A span around ``torch.cuda._sleep`` and a synchronize holds the sleep
    kernel's device interval from the same profiler trace: the card's
    timestamps are on the spans' clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with tracing.span("pdae.test.sleep", i):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
    spans = sorted((s for s in tracing.spans() if s.name == "pdae.test.sleep"),
                   key=lambda s: s.start_ns)
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and e.name() != "pdae.test.sleep" and e.duration_ns() > 1_000_000)
    assert len(spans) == len(kernels) == 3
    lead = [(k0 - s.start_ns, s.end_ns - k1) for s, (k0, k1) in zip(spans, kernels)]
    print("span start to kernel start, kernel end to span end (ns):", lead)
    assert all(a > 0 and b > 0 for a, b in lead), lead


# -- the spans in place -------------------------------------------------- #

SIZE, LATENT = 64, 16
SERVICE_DPM = {"input_channel": 3, "base_channel": 16, "channel_multiplier": (1, 2),
               "num_residual_blocks_of_a_block": 1, "attention_resolutions": (4,),
               "num_heads": 1, "head_channel": -1, "use_new_attention_order": False,
               "dropout": 0.0}


def test_autoencode_spans_a_solver_step_per_evaluation(traced):
    torch.manual_seed(0)
    service = PDAEService(
        {"trained_ddpm_config": SERVICE_DPM, "decoder_config": {"latent_dim": LATENT},
         "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
         "image_size": SIZE, "max_batch": 4},
        encoder_for_resolution(SIZE, LATENT).state_dict(),
        ShiftUNet(latent_dim=LATENT, **SERVICE_DPM).state_dict(), device="cpu")
    images = np.random.RandomState(0).randint(0, 256, (3, SIZE, SIZE, 3), np.uint8)
    tracing.reset()
    service.autoencode(images, "dpm2", "dpm2")
    service.autoencode(images[:1], "dpm2", "dpm2")
    evaluations = (service.gd.solver_tables("dpm2", direction="encode").num_steps
                   + service.gd.solver_tables("dpm2").num_steps)
    spans = tracing.spans()
    requests = [s for s in spans if s.name == "pdae.service.autoencode"]
    assert [s.key for s in requests] == [1, 2]
    for r in requests:
        inner = [s for s in spans if s is not r
                 and r.start_ns <= s.start_ns and s.end_ns <= r.end_ns]
        names = [s.name for s in inner]
        assert names.count("pdae.service.prepare") == names.count("pdae.service.finish") == 1
        assert names.count("pdae.solver.step") == evaluations == len(names) - 2
        assert all(s.parent == "pdae.service.autoencode" for s in inner)
        assert all(s.key == r.key for s in inner if s.name != "pdae.solver.step")
