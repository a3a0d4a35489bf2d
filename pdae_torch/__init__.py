"""PDAE on PyTorch and CUDA for one NVIDIA H100.

The port of ``pdae_tpu`` (JAX on a TPU), which stays beside it as the
reference. Module names mirror the JAX package's. The modules run NCHW; the
public entry points (``serving.PDAEService``, the samplers of ``sampling``)
take and write NHWC images as the JAX package's do. Every TPU kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use (``ops/_build.py``).

This package imports neither JAX nor ``pdae_tpu``.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another, and ``cuda:LOCAL_RANK`` in a process that torchrun started.
    Without that card and without an explicit device it raises rather than
    carry on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the port on the CPU")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda")
    if int(local) >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local}, but this host has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", int(local))
