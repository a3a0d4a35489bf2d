"""Spatial self-attention: the CUDA kernel ``csrc/attention.cu`` and its plain version.

Replaces the TPU kernel ``pdae_tpu/ops/attention.py::_attn_kernel``. Inputs
are ``[B, H, T, D]``; the kernel takes them contiguous (the head split in
``models/blocks.py::qkv_attention`` permutes into that layout first). Scale
``D^-1/4`` on both q and k, fp32 logits and softmax, weights cast to v's
dtype, fp32 sums. The kernel is bound by bytes at the celeba64 shapes of the
UNet middle blocks and by fp32 operations at the encoder's (see the source).

Where a gradient is wanted, ``fused_qkv_attention`` runs as one
``torch.autograd.Function``: the same forward, and the standard attention
backward of ``pdae_tpu/ops/attention.py::_attention_core_bwd`` in plain torch
(the JAX package leaves that backward to XLA; it is no TPU kernel).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

launches = 0   # kernel launches since the last reset (pdae_torch.ops)

SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
_fn = None


def reference_attention(q, k, v, scale):
    """Plain version, the math of ``pdae_tpu.ops.attention.reference_attention``."""
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("attention.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_attention_smem_bytes.argtypes = [ci, ci]
        lib.pdae_attention_smem_bytes.restype = ctypes.c_size_t
        lib.pdae_attention_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                           ctypes.c_float, ci, vp]
        lib.pdae_attention_fwd.restype = ci
        _fn = lib
    return _fn


def attention_cuda(q, k, v):
    """Launch the kernel on CUDA tensors ``[B, H, T, D]``; raises on what it
    does not take."""
    global launches
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention takes equal [B,H,T,D] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(a.is_cuda and a.device == q.device for a in (q, k, v)):
        raise ValueError("attention kernel: q/k/v must lie on one CUDA device")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("attention kernel takes contiguous q/k/v")
    b, h, t, d = q.shape
    code = dtype_code(q.dtype)
    if b * h > 65535:
        raise ValueError(f"attention kernel: B*H={b * h} exceeds the grid's 65535")
    lib = _kernel()
    smem = lib.pdae_attention_smem_bytes(t, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={t}, D={d} needs {smem} B of "
                         f"shared memory, over the {SMEM_LIMIT} B a block may use")
    out = torch.empty_like(q)
    err = lib.pdae_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), b * h, t, d,
                                 1.0 / math.sqrt(math.sqrt(d)), code,
                                 stream_handle(q))
    check_cuda_error(err, "attention kernel")
    launches += 1
    return out


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
    """``[B, H, T, D]`` attention: the kernel for CUDA tensors, the plain
    version for CPU tensors (see ``pdae_torch.ops.set_use_kernels``);
    differentiable through ``attention_bwd``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v)
    return _forward(q, k, v)
