"""GroupNorm + AdaGN (+ shift-AdaGN) + SiLU: the CUDA kernel ``csrc/groupnorm.cu``
and its two plain versions, all on NCHW tensors.

    silu((1 + z_scale) * ((GN(x) * gamma + beta) * (1 + scale) + shift) + z_shift)

Replaces the TPU kernel ``pdae_tpu/ops/groupnorm.py::_kernel``. One kernel,
two numerics modes:

* model mode (``gn_adagn_silu``) is what the port's ResBlocks run; its plain
  version ``gn_adagn_silu_fwd`` mirrors ``pdae_tpu/ops/groupnorm_train.py::_fwd``
  op by op and dtype by dtype (one-pass fp32 stats, fp32 normalize and
  affine, cast, then AdaGN and SiLU in the activation dtype);
* fold mode (``fused_gn_adagn_silu``) is the TPU kernel's numerics; its
  plain version ``reference_gn_adagn_silu`` mirrors
  ``pdae_tpu/ops/groupnorm.py::reference_gn_adagn_silu``.

``scale``/``shift`` and ``z_scale``/``z_shift`` are ``[B, C]`` (rows may be
strided, as the halves of one ``chunk``); ``None`` skips that step, which is
the same function as zeros. The kernel is bound by bytes: one read and one
write of x.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

EPS = 1e-5   # torch GroupNorm default, as the JAX package

launches = 0   # kernel launches since the last reset (pdae_torch.ops)

_fn = None


def _per_channel(v, ndim):
    """[C] -> [1, C, 1, ...] or [B, C] -> [B, C, 1, ...] over ``ndim`` dims."""
    lead = (1,) if v.dim() == 1 else (v.shape[0],)
    return v.reshape(lead + (v.shape[-1],) + (1,) * (ndim - 2))


def reference_gn_adagn_silu(x, gn_scale, gn_bias, scale, shift, z_scale,
                            z_shift, groups: int):
    """Plain version of fold mode (two-pass stats, everything in fp32)."""
    b, nd = x.shape[0], x.dim()
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=2, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    y = y * _per_channel(gn_scale, nd) + _per_channel(gn_bias, nd)
    y = y * (1.0 + _per_channel(scale, nd)) + _per_channel(shift, nd)
    y = (1.0 + _per_channel(z_scale, nd)) * y + _per_channel(z_shift, nd)
    return (y * torch.sigmoid(y)).to(x.dtype)


def gn_adagn_silu_fwd(x, gn_scale, gn_bias, scale=None, shift=None,
                      z_scale=None, z_shift=None, groups: int = 32):
    """Plain version of model mode, the op/dtype sequence of the JAX models."""
    b, nd = x.shape[0], x.dim()
    xg = x.float().reshape(b, groups, -1)
    mean = xg.mean(dim=2, keepdim=True)
    mean2 = xg.square().mean(dim=2, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    xhat = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    y = (xhat * _per_channel(gn_scale, nd) + _per_channel(gn_bias, nd)).to(x.dtype)
    if scale is not None:
        y = y * (1.0 + _per_channel(scale, nd)) + _per_channel(shift, nd)
    if z_scale is not None:
        y = (1.0 + _per_channel(z_scale, nd)) * y + _per_channel(z_shift, nd)
    return y * torch.sigmoid(y)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("groupnorm.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_gn_adagn_silu_fwd.argtypes = [
            vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, ci, ci, ci, ci,
            ctypes.c_float, ci, ci, vp]
        lib.pdae_gn_adagn_silu_fwd.restype = ci
        _fn = lib
    return _fn


def _pair(a, b, x, name):
    """Validate one (scale, shift) pair; returns (ptr_a, ptr_b, row_stride)."""
    if (a is None) != (b is None):
        raise ValueError(f"{name}: both set or both None")
    if a is None:
        return None, None, 0
    want = (x.shape[0], x.shape[1])
    for t in (a, b):
        if tuple(t.shape) != want or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: want {x.dtype} {want} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(1) != 1:
            raise ValueError(f"{name}: channels must be contiguous")
    if a.stride(0) != b.stride(0):
        raise ValueError(f"{name}: the two halves need one row stride")
    return a.data_ptr(), b.data_ptr(), a.stride(0)


def gn_cuda(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None,
            groups: int = 32, fold: bool = False):
    """Launch the kernel on a contiguous CUDA ``x`` [B, C, ...]; raises on
    what it does not take."""
    global launches
    if x.dim() < 3 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"GN kernel takes a contiguous CUDA [B, C, ...] tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    b, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"GN kernel: {c} channels do not split into {groups} groups")
    for p in (gamma, beta):
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"GN kernel: gamma/beta must be contiguous float32 "
                             f"[{c}] on {x.device}")
    code = dtype_code(x.dtype)
    s, t, st_stride = _pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = _pair(z_scale, z_shift, x, "z_scale/z_shift")
    lib = _kernel()
    out = torch.empty_like(x)
    err = lib.pdae_gn_adagn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t, st_stride, zs, zt,
        z_stride, out.data_ptr(), b, c, x[0, 0].numel(), groups, EPS, code,
        int(fold), stream_handle(x))
    check_cuda_error(err, "GN kernel")
    launches += 1
    return out


def gn_adagn_silu(x, gamma, beta, scale=None, shift=None, z_scale=None,
                  z_shift=None, groups: int = 32):
    """Model mode: the kernel for CUDA tensors, ``gn_adagn_silu_fwd`` for CPU
    tensors (see ``pdae_torch.ops.set_use_kernels``)."""
    if kernel_for(x):
        return gn_cuda(x, gamma, beta, scale, shift, z_scale, z_shift, groups)
    return gn_adagn_silu_fwd(x, gamma, beta, scale, shift, z_scale, z_shift, groups)


def fused_gn_adagn_silu(x, gn_scale, gn_bias, scale, shift, z_scale=None,
                        z_shift=None, groups: int = 32):
    """Fold mode: the kernel for CUDA tensors, ``reference_gn_adagn_silu`` for
    CPU tensors. ``z_*`` = None is the plain ResBlock."""
    if (z_scale is None) != (z_shift is None):
        raise ValueError("z_scale and z_shift must be both set or both None")
    if kernel_for(x):
        return gn_cuda(x, gn_scale, gn_bias, scale, shift, z_scale, z_shift,
                       groups, fold=True)
    if z_scale is None:
        z_scale = z_shift = torch.zeros_like(scale)
    return reference_gn_adagn_silu(x, gn_scale, gn_bias, scale, shift, z_scale,
                                   z_shift, groups)
