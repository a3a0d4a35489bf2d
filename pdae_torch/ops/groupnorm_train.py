"""The GN + AdaGN + SiLU chain with its hand-written backward.

Port of ``pdae_tpu/ops/groupnorm_train.py``. ``gn_adagn_silu_train`` is one
``torch.autograd.Function`` (the JAX package's ``custom_vjp``):

* forward: the model-mode chain of ``groupnorm.py`` (the CUDA kernel
  ``csrc/groupnorm.cu`` on the card), which also gives the fp32 ``[B, G]``
  mean and rsqrt(var + eps). Saved for the backward: ``x``, those stats and
  the small coefficient vectors; nothing else of ``[B, C, H, W]`` size.
* backward: the CUDA kernel ``csrc/groupnorm_bwd.cu``, which replaces the TPU
  kernel ``pdae_tpu/ops/groupnorm_train.py::_bwd_kernel``; its plain version
  ``gn_adagn_silu_bwd_plain`` mirrors the closed form ``_bwd`` op by op, all
  in fp32. Both give ``dx`` and the per-channel spatial sums ``dA``/``dB``
  of ``y = xhat * A + B``; ``unfold_grads`` turns those into the grads of
  ``gamma``, ``beta`` and the four AdaGN vectors, in plain torch outside the
  kernel as the JAX package does it outside Pallas.

The backward recomputes ``y`` from the fp32 fold, not from the forward's
rounding sequence (cast after the affine, AdaGN in the activation dtype):
that is the JAX package's backward, mirrored and not "fixed". ``None``
coefficients get no gradient and are never materialised as zeros; the values
equal those of a chain fed zeros. The kernel is bound by bytes: x and g read
once, dx written once.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build, groupnorm
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

launches = 0   # backward-kernel launches since the last reset (pdae_torch.ops)

_fn = None


def fold_affine(gamma, beta, scale, shift, z_scale, z_shift):
    """``y = xhat * A + B``: A, B fp32 ``[B, C]`` (``[1, C]`` for a chain
    without AdaGN), in the op order of the JAX ``_fold_affine``."""
    a, b = gamma.float()[None, :], beta.float()[None, :]
    if scale is not None:
        s1 = 1.0 + scale.float()
        a, b = a * s1, b * s1 + shift.float()
    if z_scale is not None:
        zs1 = 1.0 + z_scale.float()
        a, b = a * zs1, b * zs1 + z_shift.float()
    return a, b


def gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, scale=None, shift=None,
                            z_scale=None, z_shift=None, groups: int = 32,
                            need_dx: bool = True):
    """Plain version of the backward kernel: ``(dx, dA, dB)`` with ``dx`` in
    x's dtype (``None`` without ``need_dx``) and dA, dB fp32 ``[B, C]``."""
    b, c = x.shape[:2]
    cs = c // groups
    n = x[0].numel() // groups
    shape = (b, groups, cs, -1)
    x32, g32 = x.float().reshape(shape), g.float().reshape(shape)
    mean_g, inv_g = mean.reshape(b, groups, 1, 1), rstd.reshape(b, groups, 1, 1)
    xhat = (x32 - mean_g) * inv_g
    a, bb = fold_affine(gamma, beta, scale, shift, z_scale, z_shift)
    a = a.expand(b, c).reshape(b, groups, cs, 1)
    bb = bb.expand(b, c).reshape(b, groups, cs, 1)
    y = xhat * a + bb
    sig = torch.sigmoid(y)
    dy = g32 * (sig * (1.0 + y * (1.0 - sig)))
    d_a = (dy * xhat).sum(dim=3)                     # [B, G, cs]
    d_b = dy.sum(dim=3)
    dx = None
    if need_dx:
        m1 = (a[..., 0] * d_b).sum(dim=2) / n         # [B, G]
        m2 = (a[..., 0] * d_a).sum(dim=2) / n
        dx = inv_g * (dy * a - m1[:, :, None, None] - xhat * m2[:, :, None, None])
        dx = dx.reshape(x.shape).to(x.dtype)
    return dx, d_a.reshape(b, c), d_b.reshape(b, c)


def unfold_grads(d_a, d_b, gamma, beta, scale, shift, z_scale, z_shift, needs):
    """The grads of ``(gamma, beta, scale, shift, z_scale, z_shift)`` from
    dA, dB through ``A = gamma (1+s)(1+zs)``, ``B = (beta (1+s) + t)(1+zs) + zt``.
    ``needs`` are six flags; an unneeded or absent (``None``) input gets
    ``None``."""
    gs, gb = gamma.float()[None, :], beta.float()[None, :]
    s1 = None if scale is None else 1.0 + scale.float()
    zs1 = None if z_scale is None else 1.0 + z_scale.float()

    def times(v, *factors):
        for f in factors:
            if f is not None:
                v = v * f
        return v

    out = [None] * 6
    if needs[0]:
        out[0] = times(d_a, s1, zs1).sum(dim=0).to(gamma.dtype)
    if needs[1]:
        out[1] = times(d_b, s1, zs1).sum(dim=0).to(beta.dtype)
    if scale is not None and needs[2]:
        out[2] = (times(d_a * gs, zs1) + times(d_b * gb, zs1)).to(scale.dtype)
    if shift is not None and needs[3]:
        out[3] = times(d_b, zs1).to(shift.dtype)
    if z_scale is not None and needs[4]:
        inner = times(gb, s1)
        if shift is not None:
            inner = inner + shift.float()
        out[4] = (times(d_a * gs, s1) + d_b * inner).to(z_scale.dtype)
    if z_shift is not None and needs[5]:
        out[5] = d_b.to(z_shift.dtype)
    return out


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("groupnorm_bwd.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_gn_adagn_silu_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_adagn_silu_bwd.restype = ci
        _fn = lib
    return _fn


def gn_bwd_cuda(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                z_shift=None, groups: int = 32, need_dx: bool = True):
    """Launch the backward kernel on contiguous CUDA ``x``, ``g`` [B, C, ...];
    raises on what it does not take. Returns ``(dx, dA, dB)`` as
    ``gn_adagn_silu_bwd_plain``."""
    global launches
    groupnorm.check_gn_inputs(x, gamma, beta, groups)
    b, c = x.shape[:2]
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"GN backward kernel: the output gradient must be a "
                         f"contiguous {x.dtype} {tuple(x.shape)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    for stat in (mean, rstd):
        if (stat.dtype != torch.float32 or tuple(stat.shape) != (b, groups)
                or stat.device != x.device or not stat.is_contiguous()):
            raise ValueError(f"GN backward kernel: mean/rstd must be contiguous "
                             f"float32 [{b}, {groups}] on {x.device}")
    if c // groups > 6144:
        raise ValueError(f"GN backward kernel: {c // groups} channels per group "
                         "exceed the 6144 its shared memory holds")
    code = dtype_code(x.dtype)
    s, t, st_stride = groupnorm._pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = groupnorm._pair(z_scale, z_shift, x, "z_scale/z_shift")
    lib = _kernel()
    dx = torch.empty_like(x) if need_dx else None
    d_a = torch.empty(b, c, device=x.device, dtype=torch.float32)
    d_b = torch.empty_like(d_a)
    err = lib.pdae_gn_adagn_silu_bwd(
        x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t,
        st_stride, zs, zt, z_stride, mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr() if need_dx else None, d_a.data_ptr(), d_b.data_ptr(),
        b, c, x[0, 0].numel(), groups, code, stream_handle(x))
    check_cuda_error(err, "GN backward kernel")
    launches += 1
    return dx, d_a, d_b


class _GNAdaGNSiLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, z_scale, z_shift, groups):
        ctx.use_kernel = kernel_for(x)
        if ctx.use_kernel:
            out, mean, rstd = groupnorm.gn_cuda(
                x, gamma, beta, scale, shift, z_scale, z_shift, groups,
                save_stats=True)
        else:
            out, mean, rstd = groupnorm.gn_adagn_silu_fwd(
                x, gamma, beta, scale, shift, z_scale, z_shift, groups,
                return_stats=True)
        ctx.groups = groups
        ctx.save_for_backward(x, mean, rstd, gamma, beta, scale, shift, z_scale,
                              z_shift)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        bwd = gn_bwd_cuda if ctx.use_kernel else gn_adagn_silu_bwd_plain
        dx, d_a, d_b = bwd(x, g.contiguous(), mean, rstd, gamma, beta, scale, shift,
                           z_scale, z_shift, ctx.groups, need_dx)
        grads = unfold_grads(d_a, d_b, gamma, beta, scale, shift, z_scale, z_shift,
                             ctx.needs_input_grad[1:7])
        return (dx, *grads, None)


def gn_adagn_silu_train(x, gamma, beta, scale=None, shift=None, z_scale=None,
                        z_shift=None, groups: int = 32):
    """The differentiable model-mode chain: forward and backward kernels for
    CUDA tensors, their plain versions for CPU tensors (see
    ``pdae_torch.ops.set_use_kernels``)."""
    if (scale is None) != (shift is None) or (z_scale is None) != (z_shift is None):
        raise ValueError("scale/shift and z_scale/z_shift: both set or both None")
    return _GNAdaGNSiLU.apply(x, gamma, beta, scale, shift, z_scale, z_shift, groups)
