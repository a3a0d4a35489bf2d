"""Seeds of the port's random streams.

The JAX package folds the step into a ``jax.random`` key; those streams
cannot be reproduced in torch, so the port seeds a ``torch.Generator`` per
use instead. Every seed is a pure function of (seed, stream, step), so a run
resumed at step N draws what an uninterrupted run draws there:

    stream_seed(seed, stream, step) =
        SeedSequence([BASE_SEED + seed, stream, step]).generate_state(2, uint64)[0]
        mod 2**63

``INIT`` seeds the models' initialisation (``step`` is 0 for the encoder and
1 for the decoder), ``TRAIN`` each train step's draws of t and noise,
``DROPOUT`` its dropout masks (where a trained module has dropout), ``EVAL``
the x_T (and z_T) of the eval at a step, ``SAMPLE`` each draw of a sampler
(``step`` is the draw's salt, ``sampling/samplers.py``);
``training.resident.DATA_STREAM_TAG`` the device-resident corpus's uniform
rows and flip coins of a step.

A train step's streams are drawn from ``StepGenerator``s: one generator per
stream, made once and re-seeded before every step, which draws exactly what
a fresh ``generator(seed, stream, step)`` draws. Being one object for the
whole run, it can be registered with the CUDA graph a step is captured into
(``training/dispatch.py``): a replay reads the generator's seed and offset
as they stand when it starts, so re-seeding before each replay gives the
eager step's draws.

A process of a run of several salts its streams with its rank (``rank``),
as the JAX package folds the process index into a key, so no two ranks
draw alike; rank 0 adds nothing, so it draws what a one-process run draws.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_SEED = 666666666
INIT, TRAIN, EVAL, DROPOUT, SAMPLE = 0, 1, 2, 3, 4


def stream_seed(seed: int, stream: int, step: int = 0, rank: int = 0) -> int:
    entropy = [BASE_SEED + int(seed), int(stream), int(step)] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy)
    return int(state.generate_state(2, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, stream: int, step: int, device, rank: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``stream_seed``."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream, step, rank))


class StepGenerator:
    """The generator of one stream on ``device``, re-seeded per step:
    ``at(step)`` seeds it with ``stream_seed(seed, stream, step, rank)``
    (offset 0) and returns it."""

    def __init__(self, seed: int, stream: int, device, rank: int = 0):
        self.seed, self.stream, self.rank = int(seed), int(stream), int(rank)
        self.generator = torch.Generator(device=device)

    def at(self, step: int) -> torch.Generator:
        return self.generator.manual_seed(stream_seed(self.seed, self.stream, step, self.rank))
