"""Device-resident training data: the port of ``pdae_tpu/training/resident.py``.

The step-consumed keys of the whole corpus (``x_0``, and ``condition`` or
``label`` where the step reads them) are collated once, moved to the device
once, and every train step gathers its rows there with ``index_select``: no
per-step host batch at all. The corpora this targets fit on the card with
room to spare (CelebA64 with ``transfer_uint8``: 138k x 64x64x3 uint8 = 1.6
GB; the CelebA-HQ set of the manipulation stage 1.4 GB at 128px).

Sampling (``train_dataset_config.resident_sampling``):

* ``"epoch"`` (the default): step N takes row N of the host loader's own
  index stream (``epoch_global_indices``: the loader's epoch permutation and
  padding), so without augmentation the batches are bit-equal to the host
  loader's;
* ``"uniform"``: the rows are drawn with replacement from a
  ``torch.Generator`` seeded with (seed, ``DATA_STREAM_TAG``, N).

In a data-parallel run each process gathers its own rows of the global
batch: its columns of the epoch stream's row, or its cut of the global
uniform draws and coins (``sample_batch``'s ``rows``).

Where the dataset augments, each gathered row is flipped horizontally by a
coin from that same generator: the materialised items are the unflipped
ones, and a flip of the raw pixels commutes with the [-1, 1] normalisation.
``jax.random`` streams cannot be reproduced in torch, so the uniform draws
and the coins differ from the JAX package's by design; the epoch stream does
not.

``encode_corpus`` and ``IdentityEncoder`` serve ``latent_train_source:
precomputed`` (the latent and manipulation stages): the frozen encoder runs
over the corpus once, the resident corpus holds the raw z, and the step's
encoder is the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.image import x0_from_transfer

# the stream of the data draws, apart from every model and noise stream
DATA_STREAM_TAG = 0xD47A


def materialize_step_arrays(dataset, keys: Optional[tuple], chunk: int = 1024) -> dict:
    """One pass over ``dataset`` in index order -> stacked numpy arrays of
    the step-consumed ``keys`` (None: all), collated by the dataset's own
    ``collate_fn`` as the host loader collates them, so dtypes and layout
    (``transfer_uint8`` included) are the loader's. Items are read without
    an augmentation generator: the flip happens on the device."""
    collate = getattr(type(dataset), "collate_fn")
    n = len(dataset)
    if n == 0:
        raise ValueError("device_resident requires a non-empty dataset")
    parts = []
    for s in range(0, n, chunk):
        items = []
        for i in range(s, min(s + chunk, n)):
            try:
                items.append(dataset.__getitem__(i, None))
            except TypeError:          # datasets without an rng parameter
                items.append(dataset[i])
        b = collate(items)
        keep = tuple(keys) if keys is not None else tuple(b)
        parts.append({k: np.asarray(b[k]) for k in keep if k in b})
    return {k: (np.concatenate([p[k] for p in parts]) if len(parts) > 1 else parts[0][k])
            for k in parts[0]}


def epoch_global_indices(loader, epoch: int) -> np.ndarray:
    """One epoch's batch index table, int32 ``[batches, world * batch]``: row
    b is the concatenation over ranks of the host loader's batch b, from
    loaders of every rank with the same seed (the permutation, padding and
    striding of ``Loader._epoch_indices``)."""
    from ..data.pipeline import Loader
    world = loader.world
    per_rank = [Loader(loader.dataset, loader.batch_size, shuffle=loader.shuffle,
                       seed=loader.seed, num_workers=1, process_index=r,
                       process_count=world)._epoch_indices(epoch)
                for r in range(world)]
    nb, b = loader.batches_per_epoch(), loader.batch_size
    return np.stack([np.concatenate([pr[i * b:(i + 1) * b] for pr in per_rank])
                     for i in range(nb)]).astype(np.int32)


class IdentityEncoder(nn.Module):
    """The step's encoder when the resident rows already are the raw z
    (``latent_train_source: precomputed``): the latent and manipulation
    steps keep their structure with the encoder forward removed."""

    def forward(self, z):
        return z


def encode_corpus(encoder: nn.Module, x_host: np.ndarray, device,
                  chunk: int = 512) -> torch.Tensor:
    """The raw z of a materialised image corpus (NHWC numpy, uint8 or
    float), through the frozen ``encoder`` on ``device`` in chunks of
    ``chunk`` images under ``no_grad``; the ragged tail is padded with
    repeats of its last image to a whole chunk and the padding's z dropped,
    so every encoder call has one shape. Valid where an image's z does not
    depend on its batch (the encoder normalises each sample alone) and on no
    draw (no augmentation). Returns ``[N, latent]`` on ``device``."""
    outs = []
    with torch.no_grad():
        for s in range(0, len(x_host), chunk):
            xb = x_host[s:s + chunk]
            keep = len(xb)
            if keep < chunk:
                xb = np.concatenate([xb, np.repeat(xb[-1:], chunk - keep, axis=0)])
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
            x = x0_from_transfer(x.permute(0, 3, 1, 2).contiguous())
            outs.append(encoder(x)[:keep])
    return torch.cat(outs)


def sample_batch(data: dict, generator: torch.Generator, batch_size: int, n: int,
                 flip: bool = False, indices: Optional[torch.Tensor] = None,
                 rows=(0, 1)) -> dict:
    """A minibatch gathered on the device from the resident ``data``: the
    rows at ``indices`` (epoch mode) or at ``batch_size`` uniform draws from
    ``generator`` (uniform mode); with ``flip`` each row's ``x_0`` (NCHW) is
    flipped along its width where a coin from ``generator`` says so.

    ``rows`` is (rank, world) of a data-parallel run: the uniform indices and
    the coins are drawn for the global batch of ``world`` times the rows and
    this process keeps its rows ``[rank * b, (rank + 1) * b)``, as JAX's
    ``sample_batch`` draws global indices; ``indices`` are already this
    process's. In one process these are the draws of the batch itself."""
    rank, world = rows
    if indices is None:
        drawn = torch.randint(0, n, (world * batch_size,), generator=generator,
                              device=generator.device)
        indices = drawn[rank * batch_size:(rank + 1) * batch_size].to(
            next(iter(data.values())).device)
    batch = {k: v.index_select(0, indices) for k, v in data.items()}
    if flip and "x_0" in batch:
        x = batch["x_0"]
        if x.dim() != 4:
            raise ValueError("the device-side flip takes NCHW x_0")
        b = indices.shape[0]
        coin = torch.rand(world * b, generator=generator,
                          device=generator.device)[rank * b:(rank + 1) * b].to(x.device) < 0.5
        batch["x_0"] = torch.where(coin[:, None, None, None], x.flip(3), x)
    return batch
