"""What the trainer derives from its seed, worked out again: the SYNTHETIC
corpus's images, the host loader's epoch order, and the seeds of the
per-step streams that draw t and the noise.

* Item i of SYNTHETIC is ``RandomState(i).rand(8, 8, C)`` upsampled by
  repetition to the image size, mapped to [-1, 1].
* Epoch e's order is ``RandomState((seed * 1000003 + e) % 2**31)``'s
  permutation of the corpus; step s of epoch 0 takes rows [s B, (s + 1) B).
* Step s's draws come from a generator seeded with
  ``SeedSequence([666666666 + seed, 1, s]).generate_state(2, uint64)[0]``
  mod 2**63: t (int32, [0, 1000)), then the noise, shaped as the batch.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_SEED = 666666666
TRAIN_STREAM = 1


def stream_seed(seed: int, stream: int, step: int) -> int:
    state = np.random.SeedSequence([BASE_SEED + int(seed), int(stream), int(step)])
    return int(state.generate_state(2, np.uint64)[0]) & ((1 << 63) - 1)


def synthetic_item(index: int, size: int, channels: int = 3) -> np.ndarray:
    base = np.random.RandomState(index).rand(8, 8, channels).astype(np.float32)
    img = np.kron(base, np.ones((size // 8, size // 8, 1), np.float32))
    return img * 2.0 - 1.0


def epoch_order(seed: int, length: int, epoch: int = 0) -> np.ndarray:
    return np.random.RandomState((int(seed) * 1_000_003 + epoch) % (2 ** 31)).permutation(length)


def train_batch(seed: int, step: int, batch: int, length: int, size: int) -> torch.Tensor:
    """Step ``step``'s x_0 (fp32 NCHW), for steps inside the first epoch."""
    rows = epoch_order(seed, length)[step * batch:(step + 1) * batch]
    x = np.stack([synthetic_item(int(i), size) for i in rows])
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def train_draws(seed: int, step: int, shape, device, timesteps: int = 1000):
    """Step ``step``'s (t, noise) from its generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, TRAIN_STREAM, step))
    t = torch.randint(0, timesteps, (shape[0],), generator=gen, device=device,
                      dtype=torch.int32)
    noise = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return t, noise
