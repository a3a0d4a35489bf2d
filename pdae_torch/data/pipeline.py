"""Host input pipeline: shuffle -> decode (thread pool) -> collate -> device
prefetch. The port's copy of ``pdae_tpu/data/pipeline.py``.

Every process derives the same epoch permutation from (seed, epoch) and takes
its rank's slice; each item's augmentation draws from its own generator
seeded with (augment_seed, rank, epoch, index). So the stream is a pure
function of the seed and the position, the same as the JAX package's, and a
resumed run can skip to the batch an uninterrupted run would take.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 4, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 augment_seed: int = 1234):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.rank = 0 if process_index is None else int(process_index)
        self.world = 1 if process_count is None else int(process_count)
        self.collate = getattr(type(dataset), "collate_fn")
        self._augment_seed = augment_seed
        self._pool = None

    def __len__(self):
        return self.batches_per_epoch()

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            # the same permutation on every process (same seed and epoch)
            idx = np.random.RandomState(
                (self.seed * 1_000_003 + epoch) % (2 ** 31)).permutation(n)
        if n % self.world != 0:
            pad = self.world - (n % self.world)
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.rank::self.world]

    def _num_batches(self, idx_len: int) -> int:
        nb = (idx_len // self.batch_size if self.drop_last
              else -(-idx_len // self.batch_size))
        if nb == 0:
            raise ValueError(
                f"per-process shard ({idx_len} samples) smaller than "
                f"batch_size ({self.batch_size}); reduce batch_size / "
                f"num_iterations or grow the dataset")
        return nb

    def batches_per_epoch(self) -> int:
        return self._num_batches(len(self._epoch_indices(0)))

    def epoch(self, epoch: int = 0, skip_batches: int = 0) -> Iterator[dict]:
        """One pass over this process's shard. ``skip_batches`` skips that
        many batches without decoding them (resume)."""
        idx = self._epoch_indices(epoch)
        nb = self._num_batches(len(idx))

        def fetch(i):
            item_rng = np.random.default_rng(
                [self._augment_seed, self.rank, epoch, int(i)])
            return self._getitem(int(i), item_rng)

        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(self.num_workers)
        for b in range(skip_batches, nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.collate(list(self._pool.map(fetch, chunk)))

    def _getitem(self, i: int, rng):
        try:
            return self.dataset.__getitem__(i, rng)
        except TypeError:
            return self.dataset[i]

    def infinite(self, start_epoch: int = 0, skip_batches: int = 0) -> Iterator[dict]:
        """Endless batches, a new shuffle each epoch. ``skip_batches``
        applies to the first epoch only (resume)."""
        epoch = start_epoch
        while True:
            yield from self.epoch(epoch, skip_batches)
            skip_batches = 0
            epoch += 1


def batch_to_device(batch: dict, device, keys: Optional[Sequence[str]] = None) -> dict:
    """A host batch's arrays (those in ``keys``, or all) as tensors on
    ``device``, each in its own dtype; 4-D image arrays, NHWC on the host,
    arrive NCHW. On a card each array is pinned and copied with
    ``non_blocking``."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        t = t.to(device, non_blocking=pin)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


def prefetch_to_device(iterator: Iterator[dict], device, size: int = 2,
                       keys: Optional[Sequence[str]] = None) -> Iterator[dict]:
    """Batches as tensors on ``device``, ``size`` of them in flight.

    On a card each array is pinned and copied with ``non_blocking``, so the
    copy of the next batch overlaps the step on the current one; 4-D image
    arrays (NHWC on the host) arrive NCHW. Each array keeps its dtype: a
    ``transfer_uint8`` x_0 crosses as uint8, 4x fewer bytes than float, and
    the step normalises it on the device (``utils.image.x0_from_transfer``).
    ``keys`` keeps only those keys (the rest never leave the host). On the
    CPU nothing is pinned."""
    queue = collections.deque()
    for batch in iterator:
        queue.append(batch_to_device(batch, device, keys))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
