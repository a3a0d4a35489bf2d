"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name, key=None)`` marks a stretch of host work: a train step, a
loader wait, a service request, one solver evaluation. Tracing is on while
``torch.profiler`` records in the process (the trainer's
``profile_dir``, the benchmark's traced runs, any caller's profiler) and
after ``enable()``; each span checks at entry. When it is off a span
records nothing and enters nothing; one made with ``timed=True`` still
reads the clock twice, for a caller that reports its length (``seconds``).

When tracing is on a span

* keeps ``Span(name, start_ns, end_ns, parent, key)`` in a ring of the
  newest ``RING`` spans, stamped with ``time.time_ns()``: the clock of the
  profiler's host events, onto which it also converts the card's activity
  timestamps, so spans and device intervals compare without a conversion.
  ``parent`` is the name of the span open around it on the same thread;
  ``key`` (the step or the request number) is the enclosing span's where
  the span is given none, so the spans of one step or one request share it;
* enters ``torch.profiler.record_function(name)`` where the profiler
  records its thread (the thread that started it), so the span also shows
  by name in the profiler's trace (TensorBoard's view of ``profile_dir``,
  a Chrome trace).

``spans()`` reads the ring in the order the spans ended; ``reset()`` clears it. The ring
is the only store: the profiler's own trace is the exported copy.

The spans the port records (the key in brackets):

* ``pdae.train.chunk`` (first step), ``pdae.train.step`` (step),
  ``pdae.graph.capture`` (step), ``pdae.train.log`` (step),
  ``pdae.train.save`` and ``pdae.train.save_write`` (step),
  ``pdae.train.eval`` (step): ``training/``;
* ``pdae.loader.next`` (step), ``pdae.loader.fetch``, ``pdae.loader.h2d``:
  the training loop's batch stream, ``data/pipeline.py``;
* ``pdae.service.<op>`` (request), ``pdae.service.prepare``,
  ``pdae.service.finish``: ``serving.py``;
* ``pdae.solver.step`` (the loop's step index): one model evaluation and
  its update in every loop of ``diffusion/dpm_solver.py`` and
  ``diffusion/ddim.py``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 16

# whether this thread's ops reach a profiler: only the thread that started it
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    key: Optional[int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_ring = collections.deque(maxlen=RING)
_enabled = False
_open = threading.local()       # .top: the innermost open span of the thread


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The recorded spans, oldest end first."""
    return list(_ring)


def reset() -> None:
    _ring.clear()


class span:
    """A context manager around one stretch of host work (the module's
    docstring). ``seconds`` is its length after it closes: 0 where tracing
    was off at entry, unless ``timed``."""

    __slots__ = ("name", "key", "timed", "start_ns", "seconds", "_on", "_parent", "_rf")

    def __init__(self, name: str, key: Optional[int] = None, timed: bool = False):
        self.name, self.key, self.timed = name, key, timed
        self.start_ns, self.seconds, self._on = None, 0.0, False
        self._parent = self._rf = None

    def __enter__(self) -> "span":
        # a profiler recording on any thread (the background save writer's
        # spans are recorded while the loop's thread is profiled)
        if _enabled or _autograd_profiler._is_profiler_enabled:
            self._on = True
            self._parent = parent = getattr(_open, "top", None)
            if self.key is None and parent is not None:
                self.key = parent.key
            _open.top = self
            self.start_ns = time.time_ns()
            if _profiling():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        elif self.timed:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.start_ns is None:
            return False
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.time_ns()
        self.seconds = (end - self.start_ns) * 1e-9
        if not self._on:
            return False
        parent = self._parent
        _open.top = parent
        _ring.append(Span(self.name, self.start_ns, end,
                          None if parent is None else parent.name, self.key))
        return False
