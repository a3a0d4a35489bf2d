"""A chunk of train steps replayed from a CUDA graph: the port of
``pdae_tpu/training/base.py``'s ``_make_multi_step`` and
``_make_resident_multi_step``.

``runner_config.steps_per_dispatch: K`` makes the JAX trainer scan K train
steps into one XLA program, so the host dispatches once per chunk. On the
card the port captures one train step into a CUDA graph and runs a chunk of
c steps as c replays: the host then issues one launch per step where the
eager step issues thousands, and never waits for the card inside a chunk.

* **What is captured.** The trainer's ``_graph_body``: the step on static
  input buffers (the batch, or a resident corpus's index row and the gather
  from it), drawing from the trainer's per-stream generators
  (``utils.rng.StepGenerator``), which are registered with the graph. Before
  each replay the host copies the step's batch into the buffers and
  re-seeds every stream to (seed, stream, step): a replay reads the
  generators' seeds and offsets as they stand, so it draws what the eager
  step draws, and the step's bits are the eager step's (the optimizer is
  ``capturable`` on the card for both paths, ``state.make_optimizer``).
* **Warm-up.** PyTorch warms a graph up on a side stream before capturing
  (handles, workspaces and the optimizer's state are made lazily, which a
  capture cannot do). A warm-up that ran the step would move the state, so
  the first step of a ``GraphDispatch`` is that warm-up: an eager step on
  the side stream, with the same buffers and seeds as a replay.
* **The EMA.** The step whose new count is a multiple of ``ema_every``
  moves the EMA; with ``ema_every`` > 1 two graphs are captured, with and
  without it, into one memory pool (they never run at once).
* **Counts.** A capture records the step's kernels without running them:
  the host count ``state.step`` that the captured step advanced is put back,
  and each replay advances it by one. The ops' launch counters
  (``pdae_torch.ops``) count a captured launch once, at the capture;
  ``launches`` keeps those counts so a caller can multiply them by
  ``replays``.
* **Data-parallel.** Over an NCCL tensor group the step's all-reduce of
  the gradients and the loss (``parallel.all_reduce_mean_``) is captured
  with the step, and each replay runs it on every rank; the trainer's
  reducer ran one reduction when it was made, so NCCL's communicator exists
  before the first capture. Under FSDP the plan's reduce-scatter of the
  gradients and all-gather of the parameters (``training/fsdp.py``) are
  captured the same way, through flat buffers the plan made, and each ran
  once then too. A gloo collective cannot be captured: the
  trainer refuses ``steps_per_dispatch`` > 1 on the card over gloo by name
  (``BaseTrainer._chunk_runner``) and never runs the chunk eagerly instead.
* **Failure.** A capture or replay that fails raises; the step never runs
  eagerly in its place. A failed capture can leave PyTorch's generators in
  capture mode, so the trainer is not used again after it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from .. import ops
from .state import ema_due


class StepGraph:
    """``body()`` (one train step on static inputs, returning a dict of
    device tensors) captured once into a CUDA graph on ``stream``, drawing
    from ``generators``; ``replay()`` runs it again and returns the same
    output tensors, rewritten."""

    def __init__(self, body: Callable[[], Dict[str, torch.Tensor]],
                 generators: Sequence[torch.Generator], stream, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = ops.launch_counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = body()
        except Exception as e:
            raise RuntimeError("capturing the train step into a CUDA graph failed; it "
                               "is not run eagerly in its place") from e
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}

    def replay(self) -> Dict[str, torch.Tensor]:
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError("replaying the captured train step failed") from e
        return self.outputs


class GraphDispatch:
    """The card's steps of a trainer with ``steps_per_dispatch`` > 1:
    ``step(inputs)`` runs the trainer's next step from the captured graph
    (the first one as the eager warm-up) and returns its losses."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.static: Dict[str, torch.Tensor] = {}
        self.graphs: Dict[bool, StepGraph] = {}
        self.stream = torch.cuda.Stream(trainer.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.warm = False
        self.replays = 0

    @property
    def launches(self) -> Dict[str, int]:
        """Kernel launches one replay makes (every graph's are the same;
        empty before the first capture)."""
        return next(iter(self.graphs.values())).launches if self.graphs else {}

    def _load(self, inputs: Dict[str, torch.Tensor]) -> None:
        if not self.static:
            self.static = {k: torch.empty_like(v) for k, v in inputs.items()}
        if set(inputs) != set(self.static):
            raise ValueError(f"the step's inputs {sorted(inputs)} are not the captured "
                             f"{sorted(self.static)}")
        for k, v in inputs.items():
            if v.shape != self.static[k].shape or v.dtype != self.static[k].dtype:
                raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype} is not the captured "
                                 f"{tuple(self.static[k].shape)} {self.static[k].dtype}")
            self.static[k].copy_(v)

    def _side(self, fn):
        """``fn()`` on the side stream, ordered after and before the current one."""
        current = torch.cuda.current_stream(self.trainer.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def _capture(self, ema: bool) -> StepGraph:
        tr = self.trainer
        count = tr.state.step
        try:
            graph = StepGraph(lambda: tr._graph_body(self.static, ema),
                              [tr._train_gen.generator, tr._data_gen.generator],
                              self.stream, self.pool)
        finally:
            tr.state.step = count
        self.graphs[ema] = graph
        return graph

    def step(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        self._load(inputs)
        step = tr.state.step
        ema = ema_due(step + 1, tr.ema_every)
        if not self.warm:
            with tr.seeded(step):
                out = self._side(lambda: tr._graph_body(self.static, ema))
            self.warm = True
            return out
        graph = self.graphs.get(ema) or self._capture(ema)
        with tr.seeded(step):
            out = graph.replay()
        tr.state.step = step + 1
        self.replays += 1
        return {k: v.clone() for k, v in out.items()}
