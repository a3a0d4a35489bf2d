"""Spatial self-attention: the CUDA kernel ``csrc/attention.cu`` and its plain version.

Replaces the TPU kernel ``pdae_tpu/ops/attention.py::_attn_kernel``. Inputs
are ``[B, H, T, D]``; the kernel takes them contiguous (the head split in
``models/blocks.py::qkv_attention`` permutes into that layout first). Scale
``D^-1/4`` on both q and k, fp32 logits and softmax, weights cast to v's
dtype, fp32 sums. The kernel is bound by bytes at the celeba64 shapes of the
UNet middle blocks and by fp32 operations at the encoder's (see the source).
Under spatial parallelism (``parallel/sp.py``) q is a rank's ``[B, H, Tq, D]``
query rows and k, v every ``[B, H, Tk, D]`` key; the kernel takes ``Tq !=
Tk`` (score rows of ``Tk``), and ``Tq == Tk`` runs what it ran before.
``attention_plan`` picks the kernel's tiling from the shape alone: query rows
per block, keys per streamed tile, rows per thread in the w.v sweep, and the
shared memory that layout needs, which grows with T + D and not with T * D.
fp32 is multiplied on the CUDA cores in full fp32; bf16 with D of 32, 64 or
128 goes to the source's second kernel, which runs both products on the
tensor cores (``mma.sync``), every other bf16 shape to the CUDA-core one in
its smallest tile. ``BUILT`` lists the tilings the source is built with.

Where a gradient is wanted, ``fused_qkv_attention`` runs as one
``torch.autograd.Function``: the same forward, and the standard attention
backward of ``pdae_tpu/ops/attention.py::_attention_core_bwd`` in plain torch
(the JAX package leaves that backward to XLA; it is no TPU kernel).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

launches = 0   # kernel launches since the last reset (pdae_torch.ops)

SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
MAX_T, MAX_D = 1024, 256     # the TPU kernel's limits, which this kernel keeps
RING_STAGES = 3              # K/V tiles in the kernel's shared-memory ring
MMA_DIMS = (32, 64, 128)     # D the bf16 tensor-core kernel is built for
MMA_ROWS = (32, 16)          # its query rows per block
# (query rows, warps) per block of the fp32 CUDA-core kernel, tallest first;
# the tiles of 32 and 64 rows exist with 64-key tiles only, and with 32-key
# tiles the 16-row tile has 4 warps
TILINGS = ((64, 8), (32, 8), (16, 8), (8, 4))
TILINGS_32_KEYS = ((16, 4), (8, 4))
# element size -> (bm, bn, warps) -> the r the source builds that tiling
# with: every combination ``attention_plan`` can return, and no other
BUILT = {4: {(64, 64, 8): (1, 2, 4), (32, 64, 8): (1, 2, 4), (16, 64, 8): (1, 2),
             (8, 64, 4): (1, 2), (16, 32, 4): (4,), (8, 32, 4): (2, 4)},
         2: {(8, 64, 4): (1, 2, 4)}}
FULL_WAVE = 128              # blocks that occupy the H100's 132 SMs to 97%
_lib = None


class AttentionPlan(NamedTuple):
    """The kernel's tiling for one ``[B*H, T, D]`` problem."""
    bm: int            # query rows per block
    bn: int            # keys per K/V tile
    warps: int         # warps per block
    r: int             # rows per thread in the w.v sweep
    blocks: int        # thread blocks of the launch
    smem_bytes: int    # dynamic shared memory per block
    mma: bool = False  # the bf16 tensor-core kernel (4 warps; bn 64, r unused)


def attention_smem_bytes(t: int, d: int, elt: int, bm: int, bn: int) -> int:
    """Shared memory of one block over ``t`` keys: ``bm`` scaled query rows,
    ``bm`` score rows in fp32 (T rounded up to 4, plus 4 floats), and the ring of
    ``RING_STAGES`` tiles (fewer where K and V together are fewer) of ``bn``
    K or V rows, each padded by 16 bytes."""
    stride = (t + 3) // 4 * 4 + 4
    slots = min(RING_STAGES, 2 * -(-t // bn))
    return bm * (d * elt + 4 * stride) + slots * bn * (d * elt + 16)


def attention_mma_smem_bytes(t: int, d: int, bm: int) -> int:
    """Shared memory of one block of the bf16 tensor-core kernel over ``t``
    keys: Q, K and V rows padded by 16 bytes, score rows of T rounded up to 32
    plus 8 floats."""
    stride = (t + 31) // 32 * 32 + 8
    slots = min(RING_STAGES, 2 * -(-t // 64))
    return bm * ((d + 8) * 2 + 4 * stride) + slots * 64 * (d + 8) * 2


def wv_rows(bm: int, warps: int, d: int) -> int:
    """Rows per thread in the w.v sweep: the most (4, 2, 1) that still gives
    every thread a (row group, float4 column) item."""
    return next((r for r in (4, 2, 1)
                 if r <= bm and (bm // r) * (d // 4) >= 32 * warps), 1)


@functools.lru_cache(maxsize=None)
def attention_plan(bh: int, t: int, d: int, elt: int, tk=None) -> AttentionPlan:
    """Tiling for ``bh`` heads of ``t`` query rows against ``tk`` keys (None:
    ``t``) of ``d`` ``elt``-byte elements; raises on what the kernel does not
    take. The query rows set the blocks, the keys the shared memory. 64-key tiles while a K/V row is at most
    512 bytes, else 32. The query tile is the tallest of ``TILINGS`` that
    fills the card: a tile of 32 or 64 rows must give every SM two blocks (one
    block's loads hide behind the other's sweeps) and fit shared memory
    twice, a tile of 16 rows one block; failing that, 8 rows. A taller tile
    re-reads K and V less often and feeds more FMAs from each shared-memory
    read (rule and thresholds measured with ``pdae_torch.tools.tune_kernels``).
    bf16 with D of 32, 64 or 128 takes the tensor-core kernel, in tiles of 16
    or 32 rows; at any other D, the CUDA-core kernel's smallest tile."""
    tk = t if tk is None else tk
    if not (1 <= t <= MAX_T and 1 <= tk <= MAX_T and 4 <= d <= MAX_D):
        raise ValueError(f"attention kernel: Tq={t}, Tk={tk}, D={d} outside T <= {MAX_T}, "
                         f"4 <= D <= {MAX_D}")
    if (d * elt) % 16:
        raise ValueError(f"attention kernel: a row of D={d} {elt}-byte elements "
                         "is not a multiple of 16 bytes (its copies are 16 bytes)")
    if elt == 2 and d in MMA_DIMS:
        # four warps a block: many small blocks hide the latency of the
        # fragment loads; 32 rows once 16 rows would give an SM 16 blocks
        bm = 32 if (-(-t // 16) * bh >= 16 * FULL_WAVE
                    and 2 * attention_mma_smem_bytes(tk, d, 32) <= SMEM_LIMIT) else 16
        return AttentionPlan(bm, 64, 4, 0, -(-t // bm) * bh,
                             attention_mma_smem_bytes(tk, d, bm), True)
    bn = 64 if d * elt <= 512 else 32
    tilings = TILINGS[-1:] if elt == 2 else TILINGS if bn == 64 else TILINGS_32_KEYS

    def plan(bm, warps):
        return AttentionPlan(bm, bn, warps, wv_rows(bm, warps, d), -(-t // bm) * bh,
                             attention_smem_bytes(tk, d, elt, bm, bn))

    for bm, warps in tilings[:-1]:
        p = plan(bm, warps)
        per_sm = 2 if bm > 16 else 1
        items = bm // p.r * (d // 4)      # of the w.v sweep: at most two per thread
        if (p.blocks >= per_sm * FULL_WAVE and per_sm * p.smem_bytes <= SMEM_LIMIT
                and items <= 2 * 32 * warps):
            return p
    return plan(*tilings[-1])


def reference_attention(q, k, v, scale):
    """Plain version, the math of ``pdae_tpu.ops.attention.reference_attention``."""
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("attention.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_attention_smem_bytes.argtypes = [ci, ci, ci, ci, ci]
        lib.pdae_attention_smem_bytes.restype = ctypes.c_size_t
        lib.pdae_attention_mma_smem_bytes.argtypes = [ci, ci, ci]
        lib.pdae_attention_mma_smem_bytes.restype = ctypes.c_size_t
        lib.pdae_attention_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                           ctypes.c_float, ci, ci, ci, ci, ci, ci, vp]
        lib.pdae_attention_fwd.restype = ci
        _lib = lib
    return _lib


def library_smem_bytes(plan: AttentionPlan, t: int, d: int, elt: int) -> int:
    """``plan``'s shared memory over ``t`` keys as the built source computes
    it: the card's check that ``attention_plan`` and the kernel lay the block
    out alike."""
    if plan.mma:
        return _kernel().pdae_attention_mma_smem_bytes(t, d, plan.bm)
    return _kernel().pdae_attention_smem_bytes(t, d, elt, plan.bm, plan.bn)


def _launch(plan: AttentionPlan, q, k, v):
    """The kernel under ``plan`` on checked q ``[B, H, Tq, D]`` and k, v
    ``[B, H, Tk, D]``."""
    global launches
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    err = _kernel().pdae_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, k.shape[2], d,
        1.0 / math.sqrt(math.sqrt(d)), dtype_code(q.dtype), plan.bm, plan.bn,
        plan.warps, plan.r, int(plan.mma), stream_handle(q))
    check_cuda_error(err, "attention kernel")
    launches += 1
    return out


def attention_cuda(q, k, v):
    """Launch the kernel on CUDA tensors q ``[B, H, Tq, D]``, k and v ``[B, H,
    Tk, D]`` under ``attention_plan``'s tiling; raises on what it does not
    take."""
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2]
            or q.shape[3] != k.shape[3]):
        raise ValueError(f"attention takes [B,H,Tq,D] q and [B,H,Tk,D] k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(a.is_cuda and a.device == q.device for a in (q, k, v)):
        raise ValueError("attention kernel: q/k/v must lie on one CUDA device")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("attention kernel takes contiguous q/k/v")
    b, h, t, d = q.shape
    dtype_code(q.dtype)              # raises on a dtype the kernels do not take
    if b * h > 65535:
        raise ValueError(f"attention kernel: B*H={b * h} exceeds the grid's 65535")
    tk = k.shape[2]
    plan = attention_plan(b * h, t, d, q.element_size(), None if tk == t else tk)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"attention kernel: Tk={tk}, D={d} needs {plan.smem_bytes} B "
                         f"of shared memory, over the {SMEM_LIMIT} B a block may use")
    return _launch(plan, q, k, v)


def _forward(q, k, v):
    if kernel_for(q):
        return attention_cuda(q, k, v)
    return reference_attention(q, k, v, 1.0 / math.sqrt(math.sqrt(q.shape[-1])))


def attention_bwd(q, k, v, g):
    """``(dq, dk, dv)``: the JAX ``_attention_core_bwd`` op by op (fp32 logits
    times ``1/sqrt(D)``, softmax, then the five products in fp32)."""
    s2 = 1.0 / math.sqrt(q.shape[-1])      # (D^-1/4)^2, on q and on k
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    w = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * s2, dim=-1)
    dv = torch.matmul(w.transpose(-1, -2), gf)
    dw = torch.matmul(gf, vf.transpose(-1, -2))
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.matmul(dl, kf) * s2
    dk = torch.matmul(dl.transpose(-1, -2), qf) * s2
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return attention_bwd(*ctx.saved_tensors, g)


def fused_qkv_attention(q, k, v):
    """``[B, H, Tq, D]`` queries against ``[B, H, Tk, D]`` keys and values: the kernel for CUDA tensors, the plain
    version for CPU tensors (see ``pdae_torch.ops.set_use_kernels``);
    differentiable through ``attention_bwd``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v)
    return _forward(q, k, v)
