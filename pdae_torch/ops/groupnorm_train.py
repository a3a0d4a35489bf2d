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

The source holds two hand-written variants and ``gn_bwd_plan`` picks one from
the shape before the launch: the cluster variant splits a (batch, group) slab
pair (x and g) over a thread block cluster and keeps it in shared memory
between the sums and dx (one read of memory), the general variant takes every
shape with one block per slab. Channels-last x and g go to the third, the
NHWC variant (``nhwc_plan_for``), where dA and dB are column sums; the
Function brings the incoming gradient to x's layout where it differs, and dx
has x's layout. ``variant_launches`` counts each variant; ``launches`` is
their sum.

Under spatial parallelism (``gn_adagn_silu_split``, ``parallel/sp.py``) a
rank holds some rows of every slab. Its forward is ``groupnorm.py``'s stats
pass, one all-reduce of the ``[B, G, 2]`` sums, and the apply pass; its
backward is two passes of ``csrc/groupnorm_bwd.cu``: the moments pass (the
rank's dA, dB and the partial ``sum_c A dB``, ``sum_c A dA`` of each slab:
m1 and m2 are linear in dA and dB, so the ranks' partials add), one
all-reduce of those ``[B, G, 2]`` moments, and the dx pass, which reads the
whole slab's m1 and m2. dA and dB stay the rank's partial sums, so the
gradients of gamma, beta and the AdaGN inputs are partial, as every other
parameter gradient of a rank is. Plain versions: ``gn_bwd_moments_plain``
and ``gn_bwd_dx_plain``; ``pass_launches`` counts the two launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build, groupnorm
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

launches = 0   # backward-kernel launches since the last reset (pdae_torch.ops)
variant_launches = {"cluster": 0, "general": 0, "nhwc": 0}   # the same launches, by variant
pass_launches = {"gn_bwd_moments": 0, "gn_bwd_dx": 0}   # the split passes' launches

PAIR_BYTES = 65536      # most of a slab pair (x and g) one block of the cluster variant holds
MAX_PAIR_BYTES = 196608  # ... where 8 parts of PAIR_BYTES do not hold it (the source's limit)
BYTES_PER_THREAD = 128  # of that pair, for which the cluster variant gives a thread
MAX_THREADS = 256       # the cluster variant's largest block
MAX_CHANNELS = 128      # the most channels per group the cluster variant takes

# the NHWC variant's plan (groupnorm.nhwc_plan over x and g), measured with
# pdae_torch.tools.tune_kernels
NHWC_ROW_BYTES = 16          # the least bytes of a tile's pixel row the plan aims for
NHWC_TILE_BYTES = 32768      # ... and the least bytes of a tile (of x)
NHWC_PAIR_BYTES = 65536      # most of a tile's x and g one block holds
NHWC_MAX_PAIR_BYTES = 65536  # ... where 8 parts of NHWC_PAIR_BYTES do not hold them
NHWC_MAX_THREADS = 256

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
    # NCHW order whatever x's layout, so that the sums run in one order
    x32 = x.float().contiguous().reshape(shape)
    g32 = g.float().contiguous().reshape(shape)
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
        dx = groupnorm.like_layout(dx.reshape(x.shape).to(x.dtype), x)
    return dx, d_a.reshape(b, c), d_b.reshape(b, c)


def _point(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift, groups):
    """fp32 ``(xhat, dy, A)`` shaped ``[B, G, cs, hw]`` (A ``[B, G, cs, 1]``)
    of the backward's closed form."""
    b, c = x.shape[:2]
    cs = c // groups
    shape = (b, groups, cs, -1)
    x32, g32 = x.float().reshape(shape), g.float().reshape(shape)
    xhat = (x32 - mean.reshape(b, groups, 1, 1)) * rstd.reshape(b, groups, 1, 1)
    a, bb = fold_affine(gamma, beta, scale, shift, z_scale, z_shift)
    a = a.expand(b, c).reshape(b, groups, cs, 1)
    bb = bb.expand(b, c).reshape(b, groups, cs, 1)
    y = xhat * a + bb
    sig = torch.sigmoid(y)
    return xhat, g32 * (sig * (1.0 + y * (1.0 - sig))), a


def gn_bwd_moments_plain(x, g, mean, rstd, gamma, beta, scale=None, shift=None,
                         z_scale=None, z_shift=None, groups: int = 32):
    """Plain version of the moments pass: ``(dA, dB, moments)``, dA and dB
    fp32 ``[B, C]`` over the rank's rows and ``moments`` fp32 ``[B, G, 2]``,
    ``sum_c A dB`` and ``sum_c A dA`` of each slab (not divided by n)."""
    b, c = x.shape[:2]
    xhat, dy, a = _point(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                         groups)
    d_a = (dy * xhat).sum(dim=3)                     # [B, G, cs]
    d_b = dy.sum(dim=3)
    moments = torch.stack([(a[..., 0] * d_b).sum(dim=2), (a[..., 0] * d_a).sum(dim=2)],
                          dim=2)
    return d_a.reshape(b, c), d_b.reshape(b, c), moments


def gn_bwd_dx_plain(x, g, mean, rstd, moments, gamma, beta, scale=None, shift=None,
                    z_scale=None, z_shift=None, groups: int = 32):
    """Plain version of the dx pass: ``dx = inv (dy A - m1 - xhat m2)`` in
    x's dtype from ``moments`` fp32 ``[B, G, 2]``, the whole slab's m1 and m2
    (divided by its n)."""
    xhat, dy, a = _point(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                         groups)
    b = x.shape[0]
    inv_g = rstd.reshape(b, groups, 1, 1)
    m1 = moments[..., 0].reshape(b, groups, 1, 1)
    m2 = moments[..., 1].reshape(b, groups, 1, 1)
    return (inv_g * (dy * a - m1 - xhat * m2)).reshape(x.shape).to(x.dtype)


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


@functools.lru_cache(maxsize=None)
def gn_bwd_plan(n: int, hw: int, elt: int, need_dx: bool, x_ptr: int = 0, g_ptr: int = 0,
                dx_ptr: int = 0) -> groupnorm.GNPlan:
    """The variant for slabs of ``n`` elements of ``elt`` bytes (``n`` =
    channels per group x ``hw``) at the given addresses: the cluster variant
    with ``groupnorm.cluster_plan``'s split, each block holding at most
    ``PAIR_BYTES`` of x and g together, and a block of the smallest power of
    two of threads that gives each at most ``BYTES_PER_THREAD`` of it, from
    32 up to ``MAX_THREADS`` (all three measured with
    ``pdae_torch.tools.tune_kernels``); ``part_bytes`` is the bytes of x and
    g one block reads (and, with ``need_dx``, holds). It needs 16-byte
    aligned pointers, ``hw`` a multiple of the vector (a vector lies in one
    channel) and at most ``MAX_CHANNELS`` channels per group; every other
    slab (misaligned, ragged, too many channels, or over 8 parts of
    ``MAX_PAIR_BYTES``) goes to the general variant. A slab pair over 8 parts
    of ``PAIR_BYTES`` (1 MB in fp32 at FFHQ128's 256-channel concat at
    128x128) takes the same rule at parts of up to ``MAX_PAIR_BYTES``: one
    block an SM, the slab still read once. Without ``need_dx`` the launch is
    the same, and the part is read once and not held."""
    if x_ptr % 16 or g_ptr % 16 or dx_ptr % 16 or hw % (16 // elt) or n // hw > MAX_CHANNELS:
        return groupnorm.GENERAL
    plan = (groupnorm.cluster_plan(n, elt, PAIR_BYTES // 2, MAX_THREADS)
            or groupnorm.cluster_plan(n, elt, MAX_PAIR_BYTES // 2, MAX_THREADS))
    if plan is None:
        return groupnorm.GENERAL
    pair = 2 * plan.part_bytes
    threads = 32
    while threads < MAX_THREADS and threads * BYTES_PER_THREAD < pair:
        threads *= 2
    return plan._replace(threads=threads, part_bytes=pair)


def plan_for(x, g, dx, groups: int) -> groupnorm.GNPlan:
    """``gn_bwd_plan`` for the slabs of ``x`` [B, C, ...], the output gradient
    ``g`` and the input gradient buffer ``dx`` (None without one). The
    addresses matter modulo 16 alone, and so the cache hits."""
    hw = x.numel() // (x.shape[0] * x.shape[1])
    return gn_bwd_plan(x.shape[1] // groups * hw, hw, x.element_size(), dx is not None,
                       x.data_ptr() % 16, g.data_ptr() % 16,
                       0 if dx is None else dx.data_ptr() % 16)


def nhwc_plan_for(x, g, dx, groups: int) -> groupnorm.NHWCPlan:
    """``groupnorm.nhwc_plan`` for the backward on channels-last ``x``, ``g``
    [B, C, H, W] and the input gradient buffer ``dx`` (None without one): x
    and g read a tile, held only where dx is made."""
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, g, dx))
    return groupnorm.nhwc_plan(x.shape[1], x.shape[2] * x.shape[3], groups, x.element_size(),
                               aligned, 2, dx is not None, NHWC_ROW_BYTES, NHWC_TILE_BYTES,
                               NHWC_PAIR_BYTES, NHWC_MAX_PAIR_BYTES, NHWC_MAX_THREADS)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("groupnorm_bwd.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_gn_adagn_silu_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_adagn_silu_bwd.restype = ci
        lib.pdae_gn_bwd_moments.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp,
                                            vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_bwd_moments.restype = ci
        lib.pdae_gn_bwd_dx.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp,
                                       vp, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_bwd_dx.restype = ci
        lib.pdae_gn_adagn_silu_bwd_nhwc.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_adagn_silu_bwd_nhwc.restype = ci
        _fn = lib
    return _fn


def _launch(plan: groupnorm.GNPlan, x, g, mean, rstd, gamma, beta, scale, shift, z_scale,
            z_shift, groups: int, dx, d_a, d_b) -> None:
    """The kernel under ``plan`` from checked inputs into ``dx`` (or None),
    ``d_a`` and ``d_b``."""
    global launches
    b, c = x.shape[:2]
    s, t, st_stride = groupnorm._pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = groupnorm._pair(z_scale, z_shift, x, "z_scale/z_shift")
    err = _kernel().pdae_gn_adagn_silu_bwd(
        x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t,
        st_stride, zs, zt, z_stride, mean.data_ptr(), rstd.data_ptr(),
        None if dx is None else dx.data_ptr(), d_a.data_ptr(), d_b.data_ptr(),
        b, c, x[0, 0].numel(), groups, dtype_code(x.dtype), plan.cluster, plan.threads,
        stream_handle(x))
    check_cuda_error(err, f"GN backward kernel ({plan.variant} variant)")
    launches += 1
    variant_launches[plan.variant] += 1


def _launch_nhwc(plan: groupnorm.NHWCPlan, x, g, mean, rstd, gamma, beta, scale, shift,
                 z_scale, z_shift, groups: int, dx, d_a, d_b) -> None:
    """The NHWC variant under ``plan`` from checked channels-last inputs into
    ``dx`` (or None), ``d_a`` and ``d_b``."""
    global launches
    b, c, h, w = x.shape
    s, t, st_stride = groupnorm._pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = groupnorm._pair(z_scale, z_shift, x, "z_scale/z_shift")
    err = _kernel().pdae_gn_adagn_silu_bwd_nhwc(
        x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t,
        st_stride, zs, zt, z_stride, mean.data_ptr(), rstd.data_ptr(),
        None if dx is None else dx.data_ptr(), d_a.data_ptr(), d_b.data_ptr(),
        b, c, h * w, groups, dtype_code(x.dtype), plan.groups, plan.cluster, plan.threads,
        plan.pixels, plan.vec, int(plan.keep), stream_handle(x))
    check_cuda_error(err, "GN backward kernel (nhwc variant)")
    launches += 1
    variant_launches["nhwc"] += 1


def _check_bwd_inputs(x, g, mean, rstd, gamma, beta, groups: int, nhwc: bool = False) -> str:
    """What the backward kernels ask of their inputs; returns x's
    ``memory_layout``, which g must share."""
    layout = groupnorm.check_gn_inputs(x, gamma, beta, groups, nhwc)
    b, c = x.shape[:2]
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or groupnorm.memory_layout(g) != layout):
        raise ValueError(f"GN backward kernel: the output gradient must be a "
                         f"{x.dtype} {tuple(x.shape)} on {x.device} contiguous in x's layout "
                         f"({layout}), got {g.dtype} {tuple(g.shape)} strides {g.stride()} on "
                         f"{g.device}")
    for stat in (mean, rstd):
        if (stat.dtype != torch.float32 or tuple(stat.shape) != (b, groups)
                or stat.device != x.device or not stat.is_contiguous()):
            raise ValueError(f"GN backward kernel: mean/rstd must be contiguous "
                             f"float32 [{b}, {groups}] on {x.device}")
    if c // groups > 6144:
        raise ValueError(f"GN backward kernel: {c // groups} channels per group "
                         "exceed the 6144 its shared memory holds")
    return layout


def gn_bwd_cuda(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                z_shift=None, groups: int = 32, need_dx: bool = True):
    """Launch the backward kernel on CUDA ``x``, ``g`` [B, C, ...] of one
    layout: contiguous under ``gn_bwd_plan``'s choice, channels-last
    contiguous on the NHWC variant under ``nhwc_plan_for``'s; raises on what
    it does not take. Returns ``(dx, dA, dB)`` as ``gn_adagn_silu_bwd_plain``,
    dx in x's layout."""
    layout = _check_bwd_inputs(x, g, mean, rstd, gamma, beta, groups, nhwc=True)
    b, c = x.shape[:2]
    dx = torch.empty_like(x) if need_dx else None
    d_a = torch.empty(b, c, device=x.device, dtype=torch.float32)
    d_b = torch.empty_like(d_a)
    if layout == "nhwc":
        _launch_nhwc(nhwc_plan_for(x, g, dx, groups), x, g, mean, rstd, gamma, beta, scale,
                     shift, z_scale, z_shift, groups, dx, d_a, d_b)
    else:
        _launch(plan_for(x, g, dx, groups), x, g, mean, rstd, gamma, beta, scale, shift,
                z_scale, z_shift, groups, dx, d_a, d_b)
    return dx, d_a, d_b


def _split_args(x, g, gamma, beta, scale, shift, z_scale, z_shift):
    s, t, st_stride = groupnorm._pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = groupnorm._pair(z_scale, z_shift, x, "z_scale/z_shift")
    return (x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t, st_stride,
            zs, zt, z_stride)


def gn_bwd_moments_cuda(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                        z_shift=None, groups: int = 32):
    """Launch the moments pass on contiguous CUDA ``x``, ``g`` [B, C, ...];
    returns ``(dA, dB, moments)`` as ``gn_bwd_moments_plain``."""
    _check_bwd_inputs(x, g, mean, rstd, gamma, beta, groups)
    b, c = x.shape[:2]
    d_a = torch.empty(b, c, device=x.device, dtype=torch.float32)
    d_b = torch.empty_like(d_a)
    moments = torch.empty(b, groups, 2, device=x.device, dtype=torch.float32)
    err = _kernel().pdae_gn_bwd_moments(
        *_split_args(x, g, gamma, beta, scale, shift, z_scale, z_shift), mean.data_ptr(),
        rstd.data_ptr(), d_a.data_ptr(), d_b.data_ptr(), moments.data_ptr(), b, c,
        x[0, 0].numel(), groups, dtype_code(x.dtype), stream_handle(x))
    check_cuda_error(err, "GN backward moments pass")
    pass_launches["gn_bwd_moments"] += 1
    return d_a, d_b, moments


def gn_bwd_dx_cuda(x, g, mean, rstd, moments, gamma, beta, scale=None, shift=None,
                   z_scale=None, z_shift=None, groups: int = 32):
    """Launch the dx pass on contiguous CUDA ``x``, ``g`` [B, C, ...] with the
    whole slab's fp32 ``[B, G, 2]`` m1, m2; returns dx."""
    _check_bwd_inputs(x, g, mean, rstd, gamma, beta, groups)
    b, c = x.shape[:2]
    if (moments.dtype != torch.float32 or tuple(moments.shape) != (b, groups, 2)
            or moments.device != x.device or not moments.is_contiguous()):
        raise ValueError(f"GN dx pass: moments must be contiguous float32 [{b}, {groups}, 2] "
                         f"on {x.device}")
    dx = torch.empty_like(x)
    err = _kernel().pdae_gn_bwd_dx(
        *_split_args(x, g, gamma, beta, scale, shift, z_scale, z_shift), mean.data_ptr(),
        rstd.data_ptr(), moments.data_ptr(), dx.data_ptr(), b, c, x[0, 0].numel(), groups,
        dtype_code(x.dtype), stream_handle(x))
    check_cuda_error(err, "GN backward dx pass")
    pass_launches["gn_bwd_dx"] += 1
    return dx


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
        nhwc = groupnorm.memory_layout(x) == "nhwc"
        g = g.contiguous(memory_format=torch.channels_last if nhwc else torch.contiguous_format)
        dx, d_a, d_b = bwd(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                           ctx.groups, need_dx)
        grads = unfold_grads(d_a, d_b, gamma, beta, scale, shift, z_scale, z_shift,
                             ctx.needs_input_grad[1:7])
        return (dx, *grads, None)


def _split_forward(x, gamma, beta, scale, shift, z_scale, z_shift, groups, reduce, parts):
    """The split chain's forward: ``(out, mean, rstd)``."""
    use_kernel = kernel_for(x)
    sums = groupnorm.gn_stats(x, groups)
    if reduce is not None:
        sums = reduce(sums)
    mean, rstd = groupnorm.moments_from_sums(sums, x[0].numel() // groups * parts)
    out = groupnorm.gn_apply(x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift, groups)
    return out, mean.contiguous(), rstd.contiguous(), use_kernel


class _GNAdaGNSiLUSplit(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, z_scale, z_shift, groups, reduce, parts):
        out, mean, rstd, ctx.use_kernel = _split_forward(
            x, gamma, beta, scale, shift, z_scale, z_shift, groups, reduce, parts)
        ctx.groups, ctx.reduce, ctx.n = groups, reduce, x[0].numel() // groups * parts
        ctx.save_for_backward(x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift = ctx.saved_tensors
        g = g.contiguous()
        coefs = (gamma, beta, scale, shift, z_scale, z_shift)
        if ctx.use_kernel:
            d_a, d_b, moments = gn_bwd_moments_cuda(x, g, mean, rstd, *coefs, ctx.groups)
        else:
            d_a, d_b, moments = gn_bwd_moments_plain(x, g, mean, rstd, *coefs, ctx.groups)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.reduce is not None:
                moments = ctx.reduce(moments)
            moments = moments / ctx.n
            dx_pass = gn_bwd_dx_cuda if ctx.use_kernel else gn_bwd_dx_plain
            dx = dx_pass(x, g, mean, rstd, moments.contiguous(), *coefs, ctx.groups)
        grads = unfold_grads(d_a, d_b, *coefs, ctx.needs_input_grad[1:7])
        return (dx, *grads, None, None, None)


def gn_adagn_silu_split(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None,
                        groups: int = 32, reduce=None, parts: int = 1):
    """The model-mode chain on a rank's rows of each slab (``parts`` ranks
    hold equal rows of every slab): the stats pass, ``reduce`` (the sum of a
    ``[B, G, 2]`` fp32 tensor over the ranks, returned), the apply pass; where
    a gradient is wanted, differentiable through the moments and dx passes,
    whose moments ``reduce`` sums too. Kernels for CUDA tensors, their plain
    versions for CPU ones."""
    if (scale is None) != (shift is None) or (z_scale is None) != (z_shift is None):
        raise ValueError("scale/shift and z_scale/z_shift: both set or both None")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, gamma, beta, scale, shift, z_scale, z_shift)):
        return _GNAdaGNSiLUSplit.apply(x, gamma, beta, scale, shift, z_scale, z_shift, groups,
                                       reduce, parts)
    return _split_forward(x, gamma, beta, scale, shift, z_scale, z_shift, groups, reduce,
                          parts)[0]


def gn_adagn_silu_train(x, gamma, beta, scale=None, shift=None, z_scale=None,
                        z_shift=None, groups: int = 32):
    """The differentiable model-mode chain: forward and backward kernels for
    CUDA tensors, their plain versions for CPU tensors (see
    ``pdae_torch.ops.set_use_kernels``)."""
    if (scale is None) != (shift is None) or (z_scale is None) != (z_shift is None):
        raise ValueError("scale/shift and z_scale/z_shift: both set or both None")
    return _GNAdaGNSiLU.apply(x, gamma, beta, scale, shift, z_scale, z_shift, groups)
