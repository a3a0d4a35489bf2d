"""GroupNorm + AdaGN (+ shift-AdaGN) + SiLU: the CUDA kernel ``csrc/groupnorm.cu``
and its two plain versions, on NCHW tensors or (model mode) channels-last ones.

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

The source holds two hand-written variants and ``gn_plan`` picks one from the
shape before the launch: the cluster variant splits a (batch, group) slab over
a thread block cluster and keeps it in shared memory between the stats and
the apply (one read of memory), the general variant takes every shape with
one block per slab. A channels-last contiguous x (the bf16 models' layout,
``models/blocks.py``) goes to the third, the NHWC variant, under ``nhwc_plan``
(a cluster per tile of groups of one batch element, its blocks splitting the
pixels); an x contiguous both ways (H*W = 1 or C = 1) counts as NCHW, and
every other stride raises. The output has x's layout, and so does the plain
version's. ``variant_launches`` counts each variant; ``launches`` is their
sum.

For training, both the kernel (``save_stats``) and ``gn_adagn_silu_fwd``
(``return_stats``) also give the fp32 ``[B, G]`` mean and rsqrt(var + eps),
the residuals of the JAX ``_fwd``; ``gn_adagn_silu`` routes through the
autograd Function of ``groupnorm_train.py`` whenever a gradient is wanted.

Under spatial parallelism a rank holds some rows of every slab, and model
mode runs as two passes of the same source with one all-reduce between
them (``groupnorm_train.gn_adagn_silu_split``): ``gn_stats`` (the fp32
partial sums of x and x^2 of each slab, ``[B, G, 2]``), then ``gn_apply``
(the chain from a given ``[B, G]`` mean and rstd, which ``moments_from_sums``
forms from the ranks' summed sums by the one-pass formula). Their plain
versions are ``gn_stats_plain`` and ``gn_apply_plain``; ``pass_launches``
counts the launches of each pass under its own name.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from ._dispatch import check_cuda_error, dtype_code, kernel_for, stream_handle

EPS = 1e-5   # torch GroupNorm default, as the JAX package

launches = 0   # kernel launches since the last reset (pdae_torch.ops)
variant_launches = {"cluster": 0, "general": 0, "nhwc": 0}   # the same launches, by variant
pass_launches = {"gn_stats": 0, "gn_apply": 0}    # the split passes' launches

PART_BYTES = 65536       # most of a slab one block of the cluster variant holds
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_THREADS = 512        # the cluster variant's largest block

_fn = None


class GNPlan(NamedTuple):
    """Which variant serves a slab, and the cluster variant's launch."""
    variant: str       # "cluster" or "general"
    cluster: int       # blocks per slab (0 for the general variant)
    threads: int       # threads per block
    part_bytes: int    # bytes of the slab one block holds (0 for general)


GENERAL = GNPlan("general", 0, 512, 0)

# the NHWC variant's plan (``nhwc_plan``), measured with pdae_torch.tools.tune_kernels
NHWC_ROW_BYTES = 32          # the least bytes of a tile's pixel row the plan aims for
NHWC_TILE_BYTES = 2048       # ... and the least bytes of a tile
NHWC_PART_BYTES = 65536      # most of a tile one block holds
NHWC_MAX_PART_BYTES = 131072  # ... where 8 parts of NHWC_PART_BYTES do not hold it
NHWC_MAX_THREADS = 256
NHWC_SMEM_BYTES = 232448 - 1024   # what the kernels' launchers let a block use


class NHWCPlan(NamedTuple):
    """The NHWC variant's launch: a cluster per tile of ``groups`` groups of
    one batch element, its blocks splitting the pixels."""
    groups: int        # groups a tile (k)
    cluster: int       # blocks a tile
    threads: int       # threads a block, a multiple of the tile's vectors a pixel
    pixels: int        # pixels a block
    vec: int           # elements a thread's column: 16 bytes, or 1
    keep: bool         # the part held in shared memory between the passes
    part_bytes: int    # bytes of the tile (of each operand) one block reads
    smem_bytes: int    # the block's dynamic shared memory


def nhwc_smem_bytes(w: int, k: int, vec: int, threads: int, pixels: int, elt: int,
                    operands: int, keep: bool) -> int:
    """The NHWC kernels' dynamic shared memory (their launchers' sum): the
    parts held, column_totals's scratch, the per-channel table and sums (10
    floats a channel in the forward, 12 in the backward) and the per-group
    sums (4 floats a group, 2)."""
    r = w // vec
    slots = threads // 32 * r if r < 32 and 32 % r == 0 and threads % 32 == 0 else threads
    per_channel, per_group = (10, 4) if operands == 1 else (12, 2)
    part = operands * pixels * w * elt if keep else 0
    return part + 4 * (-(-slots * vec * 2 // 4) * 4 + per_channel * w + per_group * k)


@functools.lru_cache(maxsize=None)
def nhwc_plan(c: int, hw: int, groups: int, elt: int, vec_ok: bool = True, operands: int = 1,
              keep_ok: bool = True, row_bytes: int = NHWC_ROW_BYTES,
              tile_bytes: int = NHWC_TILE_BYTES, part_bytes: int = NHWC_PART_BYTES,
              max_part_bytes: int = NHWC_MAX_PART_BYTES,
              max_threads: int = NHWC_MAX_THREADS) -> NHWCPlan:
    """The NHWC variant's launch for ``[B, hw, c]`` channels-last tensors of
    ``elt`` bytes in ``groups`` groups, ``operands`` of them read a tile (x,
    or x and g). A thread's column is a 16-byte vector where ``vec_ok`` (the
    pointers aligned) and a pixel's ``c`` channels make whole vectors, else
    one element. A tile takes the fewest groups whose pixel row is at least
    ``row_bytes`` and whose tile is at least ``tile_bytes`` (else the most
    that one block's threads cover). It is split over the smallest cluster
    whose part of each operand is at most ``part_bytes`` (else
    ``max_part_bytes``) and held in shared memory where ``keep_ok``; a tile
    over 8 of those, or a 1-element column, is read twice instead, over the
    smallest cluster whose part is at most ``part_bytes`` (else 8). A part of
    32 KB or more gets ``max_threads`` threads, a smaller one a thread per
    vector up to half of that, in multiples of the warp and of the vectors a
    pixel. A part that would take the block over ``NHWC_SMEM_BYTES`` is read
    twice instead."""
    cs = c // groups
    vec = 16 // elt if vec_ok and c * elt % 16 == 0 else 1
    ks = [k for k in range(1, groups + 1)
          if groups % k == 0 and k * cs % vec == 0 and k * cs // vec <= max_threads]
    if not ks:
        raise ValueError(f"GN kernel (NHWC): {cs} channels a group are more than a block's "
                         f"{max_threads} threads cover")
    k = next((k for k in ks if k * cs * elt >= row_bytes and hw * k * cs * elt >= tile_bytes),
             ks[-1])
    row = k * cs * elt * operands

    def split(limit):
        return next((cl for cl in CLUSTER_SIZES if -(-hw // cl) * row <= limit), None)

    keep = keep_ok and vec > 1
    cluster = (split(part_bytes) or split(max_part_bytes)) if keep else None
    if cluster is None:
        keep, cluster = False, split(part_bytes) or CLUSTER_SIZES[-1]
    pixels = -(-hw // cluster)
    r = k * cs // vec
    unit = math.lcm(r, 32)
    unit = unit if unit <= max_threads else r
    want = max_threads if pixels * row >= 32768 else min(max_threads // 2, pixels * r)
    threads = max(unit, min(max_threads // unit * unit, -(-want // unit) * unit))

    def smem(keep):
        return nhwc_smem_bytes(k * cs, k, vec, threads, pixels, elt, operands, keep)
    keep = keep and smem(True) <= NHWC_SMEM_BYTES
    return NHWCPlan(k, cluster, threads, pixels, vec, keep, pixels * row // operands,
                    smem(keep))


def cluster_plan(n: int, elt: int, part_bytes: int, max_threads: int):
    """The smallest cluster whose even part of a slab of ``n`` elements of
    ``elt`` bytes is at most ``part_bytes`` and a multiple of 16 bytes, or
    None. A part of 32 KB or more gets ``max_threads`` threads, a smaller one
    a thread per 16-byte vector up to half of that."""
    vec = 16 // elt
    for cluster in CLUSTER_SIZES:
        if n % (cluster * vec) == 0 and n // cluster * elt <= part_bytes:
            part = n // cluster * elt
            threads = (max_threads if part >= 32768
                       else min(max_threads // 2, -(-part // 16 // 32) * 32))
            return GNPlan("cluster", cluster, threads, part)
    return None


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, hw: int, elt: int, x_ptr: int = 0, out_ptr: int = 0) -> GNPlan:
    """The variant for slabs of ``n`` elements of ``elt`` bytes (``n`` =
    channels per group x ``hw``) at the given addresses: the cluster variant
    with ``cluster_plan``'s launch at parts of ``PART_BYTES`` and blocks of
    ``MAX_THREADS`` (both measured with ``pdae_torch.tools.tune_kernels``).
    It needs 16-byte aligned pointers and ``hw`` a multiple of the vector, so
    that a vector lies in one channel; every other slab (misaligned, ragged,
    or over 8 parts of ``PART_BYTES``) goes to the general variant."""
    if x_ptr % 16 or out_ptr % 16 or hw % (16 // elt):
        return GENERAL
    return cluster_plan(n, elt, PART_BYTES, MAX_THREADS) or GENERAL


def plan_for(x, out, groups: int) -> GNPlan:
    """``gn_plan`` for the slabs of ``x`` [B, C, ...] and the output buffer
    ``out``. The addresses matter modulo 16 alone, and so the cache hits."""
    hw = x.numel() // (x.shape[0] * x.shape[1])
    return gn_plan(x.shape[1] // groups * hw, hw, x.element_size(),
                   x.data_ptr() % 16, out.data_ptr() % 16)


def nhwc_plan_for(x, out, groups: int) -> NHWCPlan:
    """``nhwc_plan`` for a channels-last ``x`` [B, C, H, W] and the output
    buffer ``out``."""
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return nhwc_plan(x.shape[1], x.shape[2] * x.shape[3], groups, x.element_size(), aligned,
                     1, True, NHWC_ROW_BYTES, NHWC_TILE_BYTES, NHWC_PART_BYTES,
                     NHWC_MAX_PART_BYTES, NHWC_MAX_THREADS)


def memory_layout(x):
    """``"nchw"`` for a contiguous tensor, ``"nhwc"`` for a channels-last
    contiguous [B, C, H, W] one (a shape that is both, H*W = 1 or C = 1, is
    ``"nchw"``), else None."""
    if x.is_contiguous():
        return "nchw"
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return None


def like_layout(t, x):
    """``t`` (x's shape) in x's memory layout: channels-last where x is."""
    if memory_layout(x) == "nhwc":
        return t.contiguous(memory_format=torch.channels_last)
    return t


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
                      z_scale=None, z_shift=None, groups: int = 32,
                      return_stats: bool = False):
    """Plain version of model mode, the op/dtype sequence of the JAX models.
    With ``return_stats`` it returns ``(out, mean, rstd)``, the stats fp32
    ``[B, G]`` as the JAX ``_stats`` gives them."""
    b = x.shape[0]
    xg = x.float().reshape(b, groups, -1)
    mean = xg.mean(dim=2, keepdim=True)
    mean2 = xg.square().mean(dim=2, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + EPS)
    out = gn_apply_plain(x, mean, rstd, gn_scale, gn_bias, scale, shift, z_scale, z_shift,
                         groups)
    if return_stats:
        return out, mean.reshape(b, groups), rstd.reshape(b, groups)
    return out


def gn_apply_plain(x, mean, rstd, gn_scale, gn_bias, scale=None, shift=None,
                   z_scale=None, z_shift=None, groups: int = 32):
    """Plain version of the apply pass: model mode's chain from the fp32
    ``[B, G]`` (or ``[B, G, 1]``) ``mean`` and ``rstd``."""
    b, nd = x.shape[0], x.dim()
    xg = x.float().reshape(b, groups, -1)
    xhat = ((xg - mean.reshape(b, groups, 1)) * rstd.reshape(b, groups, 1)).reshape(x.shape)
    y = (xhat * _per_channel(gn_scale, nd) + _per_channel(gn_bias, nd)).to(x.dtype)
    if scale is not None:
        y = y * (1.0 + _per_channel(scale, nd)) + _per_channel(shift, nd)
    if z_scale is not None:
        y = (1.0 + _per_channel(z_scale, nd)) * y + _per_channel(z_shift, nd)
    return like_layout(y * torch.sigmoid(y), x)


def gn_stats_plain(x, groups: int):
    """Plain version of the stats pass: fp32 ``[B, G, 2]``, the sums of x
    and of x^2 over each (batch, group) slab of ``x``."""
    xg = x.float().reshape(x.shape[0], groups, -1)
    return torch.stack([xg.sum(dim=2), xg.square().sum(dim=2)], dim=2)


def moments_from_sums(sums, n: int):
    """``(mean, rstd)`` fp32 ``[B, G]`` from the ``[B, G, 2]`` sums of x
    and x^2 over slabs of ``n`` elements, by the one-pass formula of
    ``pdae_tpu/ops/groupnorm_train.py::_stats`` (``var = max(E[x^2] -
    mean^2, 0)``)."""
    mean = sums[..., 0] / n
    var = torch.clamp(sums[..., 1] / n - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + EPS)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("groupnorm.cu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pdae_gn_adagn_silu_fwd.argtypes = [
            vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci,
            ctypes.c_float, ci, ci, ci, ci, vp]
        lib.pdae_gn_adagn_silu_fwd.restype = ci
        lib.pdae_launch_empty.argtypes = [vp]
        lib.pdae_launch_empty.restype = ci
        lib.pdae_gn_stats.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_stats.restype = ci
        lib.pdae_gn_apply.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, ci, ci,
                                      ci, ci, ci, vp]
        lib.pdae_gn_apply.restype = ci
        lib.pdae_gn_adagn_silu_nhwc_fwd.argtypes = [
            vp, vp, vp, vp, vp, ci, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci,
            ctypes.c_float, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.pdae_gn_adagn_silu_nhwc_fwd.restype = ci
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


def check_gn_inputs(x, gamma, beta, groups: int, nhwc: bool = False) -> str:
    """What both GN kernels ask of ``x`` and the GroupNorm parameters; returns
    x's ``memory_layout``. ``nhwc``: a channels-last x is taken (the fused
    kernels' NHWC variants), else only a contiguous one."""
    layout = memory_layout(x) if x.dim() >= 3 and x.is_cuda else None
    if layout is None or (layout == "nhwc" and not nhwc):
        raise ValueError(f"GN kernel takes a contiguous"
                         f"{' or channels-last contiguous' if nhwc else ''} CUDA [B, C, ...] "
                         f"tensor, got {tuple(x.shape)} strides {x.stride()} on {x.device}")
    b, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"GN kernel: {c} channels do not split into {groups} groups")
    for p in (gamma, beta):
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"GN kernel: gamma/beta must be contiguous float32 "
                             f"[{c}] on {x.device}")
    return layout


def launch_empty(device) -> None:
    """Launch the source's empty kernel on ``device``'s current stream: its
    device time is the floor under every small launch."""
    err = _kernel().pdae_launch_empty(torch.cuda.current_stream(device).cuda_stream)
    check_cuda_error(err, "empty kernel")


def _launch(plan: GNPlan, x, out, gamma, beta, scale, shift, z_scale, z_shift,
            groups: int, fold: bool, mean=None, rstd=None) -> None:
    """The kernel under ``plan`` from a checked ``x`` into ``out`` (and the
    fp32 ``[B, G]`` ``mean``/``rstd``, where given)."""
    global launches
    b, c = x.shape[:2]
    s, t, st_stride = _pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = _pair(z_scale, z_shift, x, "z_scale/z_shift")
    err = _kernel().pdae_gn_adagn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t, st_stride, zs, zt,
        z_stride, out.data_ptr(), None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), b, c, x.numel() // (b * c), groups,
        EPS, dtype_code(x.dtype), int(fold), plan.cluster, plan.threads,
        stream_handle(x))
    check_cuda_error(err, f"GN kernel ({plan.variant} variant)")
    launches += 1
    variant_launches[plan.variant] += 1


def _launch_nhwc(plan: NHWCPlan, x, out, gamma, beta, scale, shift, z_scale, z_shift,
                 groups: int, mean=None, rstd=None) -> None:
    """The NHWC variant (model mode) under ``plan`` from a checked
    channels-last ``x`` into ``out`` (and ``mean``/``rstd``, where given)."""
    global launches
    b, c, h, w = x.shape
    s, t, st_stride = _pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = _pair(z_scale, z_shift, x, "z_scale/z_shift")
    err = _kernel().pdae_gn_adagn_silu_nhwc_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t, st_stride, zs, zt,
        z_stride, out.data_ptr(), None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), b, c, h * w, groups, EPS,
        dtype_code(x.dtype), plan.groups, plan.cluster, plan.threads, plan.pixels, plan.vec,
        int(plan.keep), stream_handle(x))
    check_cuda_error(err, "GN kernel (nhwc variant)")
    launches += 1
    variant_launches["nhwc"] += 1


def gn_cuda(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None,
            groups: int = 32, fold: bool = False, save_stats: bool = False):
    """Launch the kernel on a CUDA ``x`` [B, C, ...]: a contiguous one under
    ``gn_plan``'s choice, a channels-last contiguous one (model mode) on the
    NHWC variant under ``nhwc_plan``'s; raises on what it does not take. The
    output has x's layout. With ``save_stats`` it returns ``(out, mean,
    rstd)``, the stats fp32 ``[B, G]``."""
    layout = check_gn_inputs(x, gamma, beta, groups, nhwc=True)
    if layout == "nhwc" and fold:
        raise ValueError("GN kernel: fold mode takes a contiguous (NCHW) tensor")
    out = torch.empty_like(x)
    mean = rstd = None
    if save_stats:
        mean = torch.empty(x.shape[0], groups, device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    if layout == "nhwc":
        _launch_nhwc(nhwc_plan_for(x, out, groups), x, out, gamma, beta, scale, shift,
                     z_scale, z_shift, groups, mean, rstd)
    else:
        _launch(plan_for(x, out, groups), x, out, gamma, beta, scale, shift, z_scale,
                z_shift, groups, fold, mean, rstd)
    return (out, mean, rstd) if save_stats else out


def gn_stats_cuda(x, groups: int):
    """Launch the stats pass on a contiguous CUDA ``x`` [B, C, ...]: fp32
    ``[B, G, 2]`` as ``gn_stats_plain``."""
    if x.dim() < 3 or not x.is_cuda or not x.is_contiguous() or x.shape[1] % groups:
        raise ValueError(f"GN stats pass takes a contiguous CUDA [B, C, ...] tensor whose "
                         f"channels split into {groups} groups, got {tuple(x.shape)} on "
                         f"{x.device}")
    b, c = x.shape[:2]
    sums = torch.empty(b, groups, 2, device=x.device, dtype=torch.float32)
    err = _kernel().pdae_gn_stats(x.data_ptr(), sums.data_ptr(), b, c, x.numel() // (b * c),
                                  groups, dtype_code(x.dtype), stream_handle(x))
    check_cuda_error(err, "GN stats pass")
    pass_launches["gn_stats"] += 1
    return sums


def gn_apply_cuda(x, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                  z_shift=None, groups: int = 32):
    """Launch the apply pass on a contiguous CUDA ``x`` [B, C, ...] with the
    fp32 ``[B, G]`` ``mean`` and ``rstd``."""
    check_gn_inputs(x, gamma, beta, groups)
    b, c = x.shape[:2]
    for stat in (mean, rstd):
        if (stat.dtype != torch.float32 or tuple(stat.shape) != (b, groups)
                or stat.device != x.device or not stat.is_contiguous()):
            raise ValueError(f"GN apply pass: mean/rstd must be contiguous float32 "
                             f"[{b}, {groups}] on {x.device}")
    s, t, st_stride = _pair(scale, shift, x, "scale/shift")
    zs, zt, z_stride = _pair(z_scale, z_shift, x, "z_scale/z_shift")
    out = torch.empty_like(x)
    err = _kernel().pdae_gn_apply(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s, t, st_stride, zs, zt, z_stride,
        out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, c, x.numel() // (b * c), groups,
        dtype_code(x.dtype), stream_handle(x))
    check_cuda_error(err, "GN apply pass")
    pass_launches["gn_apply"] += 1
    return out


def gn_stats(x, groups: int):
    """The stats pass: the kernel for a CUDA ``x``, ``gn_stats_plain`` for a
    CPU one."""
    if kernel_for(x):
        return gn_stats_cuda(x, groups)
    return gn_stats_plain(x, groups)


def gn_apply(x, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
             z_shift=None, groups: int = 32):
    """The apply pass: the kernel for a CUDA ``x``, ``gn_apply_plain`` for a
    CPU one."""
    if kernel_for(x):
        return gn_apply_cuda(x, mean.contiguous(), rstd.contiguous(), gamma, beta, scale,
                             shift, z_scale, z_shift, groups)
    return gn_apply_plain(x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift, groups)


def gn_adagn_silu(x, gamma, beta, scale=None, shift=None, z_scale=None,
                  z_shift=None, groups: int = 32):
    """Model mode: the kernel for CUDA tensors, ``gn_adagn_silu_fwd`` for CPU
    tensors (see ``pdae_torch.ops.set_use_kernels``). Where grad is enabled
    and an input requires it, the chain runs as the autograd Function of
    ``groupnorm_train.py`` (forward and backward kernels on the card)."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, gamma, beta, scale, shift, z_scale, z_shift)):
        from .groupnorm_train import gn_adagn_silu_train
        return gn_adagn_silu_train(x, gamma, beta, scale, shift, z_scale, z_shift,
                                   groups)
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
