"""The precision in which the plain reference computes its products.

``FP32`` is the reference itself: fp32 operands and sums, TF32 off. The
lower ones are the controls that ``h100_bench.control`` puts in the
program's place, each the step below a configuration's stated precision:

* ``TF32`` (below fp32 with TF32 off): on a card the products run with
  cuDNN's and cuBLAS's TF32 switched on; on the CPU, which has no TF32, the
  operands are rounded to TF32's 10-bit mantissa (round to nearest even)
  and the sums stay fp32, which is what a TF32 tensor core computes.
* ``FP8`` (below bf16): every operand of a product scaled per tensor so its
  largest magnitude is e4m3's 448, cast to ``float8_e4m3fn`` and back, and
  the product summed in fp32, as an fp8 tensor-core product with per-tensor
  scales computes it; gradients flow in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), nearest even."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 through e4m3 with a per-tensor scale; the gradient passes as it
    is (the backward's products take the rounded operands the forward
    saved, and an fp32 gradient)."""
    t = t.float()
    with torch.no_grad():
        scale = 448.0 / t.abs().max().clamp(min=1e-12)
        low = (t * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (low - t).detach()


class Precision:
    """``conv2d``, ``conv1d``, ``linear`` and ``bmm`` in one precision."""

    def __init__(self, name: str):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _ops(self, *tensors):
        if self.name == "fp8":
            return [None if t is None else _fp8_round(t) for t in tensors]
        if self.name == "tf32" and not tensors[0].is_cuda:
            return [None if t is None else _tf32_round(t) for t in tensors]
        return list(tensors)

    @contextlib.contextmanager
    def _mode(self, x):
        if not x.is_cuda:
            yield
            return
        tf32 = self.name == "tf32"
        old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old

    def conv2d(self, x, w, b, stride, padding):
        x, w = self._ops(x, w)
        with self._mode(x):
            return F.conv2d(x, w, b, stride, padding)

    def conv1d(self, x, w, b):
        x, w = self._ops(x, w)
        with self._mode(x):
            return F.conv1d(x, w, b)

    def linear(self, x, w, b):
        x, w = self._ops(x, w)
        with self._mode(x):
            return F.linear(x, w, b)

    def bmm(self, a, b):
        a, b = self._ops(a, b)
        with self._mode(a):
            return torch.bmm(a, b)


FP32, TF32, FP8 = Precision("fp32"), Precision("tf32"), Precision("fp8")
PRECISIONS = {"fp32": FP32, "tf32": TF32, "fp8": FP8}
