// GroupNorm + AdaGN (+ shift-AdaGN) + SiLU forward for Hopper (sm_90a),
// fp32 or bf16 activations, NCHW.
//
//   out = silu((1 + z_scale) * ((GN(x) * gamma + beta) * (1 + scale) + shift) + z_shift)
//
// Replaces the TPU kernel pdae_tpu/ops/groupnorm.py::_kernel. Two numerics
// modes, one template flag:
//
//   model (kFold = false): the op and dtype sequence of
//     pdae_tpu/ops/groupnorm_train.py::_fwd, which is what the JAX models
//     run. One-pass fp32 stats (mean = E[x], var = max(E[x^2] - mean^2, 0)),
//     fp32 normalize and gamma/beta, a cast to the activation dtype, then
//     the AdaGN steps and the SiLU in that dtype, rounded after every op as
//     PyTorch rounds them. The affine chain is NOT folded: the fold is not
//     the same function in bf16.
//   fold (kFold = true): the TPU kernel's numerics. Two-pass fp32 stats and
//     y = xhat * A + B with A = gamma (1+s)(1+zs), B = (beta (1+s) + t)(1+zs) + zt
//     folded in fp32.
//
// Null scale/shift (or z_scale/z_shift) pointers skip that AdaGN step, which
// gives the same values as passing zeros.
//
// For training the kernel also writes the fp32 [B, G] mean and
// rsqrt(var + eps) it has computed (the residuals of
// pdae_tpu/ops/groupnorm_train.py::_fwd) where mean_out/rstd_out are given;
// the backward kernel (groupnorm_bwd.cu) reads them. Null pointers (serving)
// write nothing and leave the output as it was.
//
// Design: in NCHW one (batch, group) is one contiguous slab of
// (C/G)*H*W elements. One 512-thread block owns one slab: it reduces the
// stats (one pass in model mode, two in fold mode), then applies the chain
// in a last pass. The TPU kernel kept the whole [H*W, C] slab of a batch
// element in VMEM; here the repeated passes read the slab back from L2 (the
// largest slab on the celeba64 path, 64x64 with 12 channels per group, is
// 192 KB in fp32, and the ~2 blocks in flight per SM keep well inside the
// 50 MB L2).
//
// Bound: bytes. Each element is read once and written once (8 bytes in
// fp32, 4 in bf16) for ~15 flops, far below the card's ops-per-byte ridge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One op in the activation dtype: computed in fp32, rounded to T.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the result. red holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(kThreads)
gn_adagn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const T* __restrict__ scale,
                     const T* __restrict__ shift, int st_stride,
                     const T* __restrict__ z_scale, const T* __restrict__ z_shift,
                     int z_stride, T* __restrict__ out, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int c, int hw, int groups,
                     float eps) {
  __shared__ float red[33];
  const int bg = blockIdx.x;
  const int b = bg / groups;
  const int cs = c / groups;
  const int c0 = (bg - b * groups) * cs;
  const int n = cs * hw;
  const T* xs = x + (size_t)bg * n;
  T* os = out + (size_t)bg * n;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_f(xs[i]);
    s1 += v;
    if (!kFold) s2 = fmaf(v, v, s2);
  }
  const float mean = block_sum(s1, red) / (float)n;
  float var;
  if (kFold) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float dv = to_f(xs[i]) - mean;
      s2 = fmaf(dv, dv, s2);
    }
    var = block_sum(s2, red) / (float)n;
  } else {
    const float mean2 = block_sum(s2, red) / (float)n;
    var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  }
  const float inv = rsqrtf(var + eps);
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = inv;
  }

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ch = c0 + i / hw;
    const size_t st = (size_t)b * st_stride + ch;
    const size_t zt = (size_t)b * z_stride + ch;
    const float xhat = __fmul_rn(__fsub_rn(to_f(xs[i]), mean), inv);
    float y;
    if (kFold) {
      const float s1p = scale ? 1.f + to_f(scale[st]) : 1.f;
      const float z1p = z_scale ? 1.f + to_f(z_scale[zt]) : 1.f;
      const float a = __fmul_rn(__fmul_rn(gamma[ch], s1p), z1p);
      float bb = __fmul_rn(beta[ch], s1p);
      if (shift) bb = __fadd_rn(bb, to_f(shift[st]));
      bb = __fmul_rn(bb, z1p);
      if (z_shift) bb = __fadd_rn(bb, to_f(z_shift[zt]));
      y = __fadd_rn(__fmul_rn(xhat, a), bb);
      os[i] = from_f<T>(__fmul_rn(y, 1.f / (1.f + expf(-y))));
    } else {
      y = rnd<T>(__fadd_rn(__fmul_rn(xhat, gamma[ch]), beta[ch]));
      if (scale) {
        y = rnd<T>(__fmul_rn(y, rnd<T>(1.f + to_f(scale[st]))));
        y = rnd<T>(__fadd_rn(y, to_f(shift[st])));
      }
      if (z_scale) {
        y = rnd<T>(__fmul_rn(rnd<T>(1.f + to_f(z_scale[zt])), y));
        y = rnd<T>(__fadd_rn(y, to_f(z_shift[zt])));
      }
      const float sig = rnd<T>(1.f / (1.f + expf(-y)));
      os[i] = from_f<T>(__fmul_rn(y, sig));
    }
  }
}

template <typename T, bool kFold>
int launch(const void* x, const float* gamma, const float* beta, const void* scale,
           const void* shift, int st_stride, const void* z_scale, const void* z_shift,
           int z_stride, void* out, float* mean_out, float* rstd_out, int b, int c,
           int hw, int groups, float eps, cudaStream_t stream) {
  gn_adagn_silu_kernel<T, kFold><<<b * groups, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(scale),
      static_cast<const T*>(shift), st_stride, static_cast<const T*>(z_scale),
      static_cast<const T*>(z_shift), z_stride, static_cast<T*>(out), mean_out, rstd_out,
      c, hw, groups, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: contiguous [b, c, hw]; gamma, beta: fp32 [c]; scale/shift: rows of
// c at st_stride (or both null), z_scale/z_shift likewise at z_stride.
// mean_out, rstd_out: fp32 [b * groups], or both null.
// dtype: 0 = float32, 1 = bfloat16. fold: 0 = model mode, 1 = fold mode.
// Returns cudaGetLastError() after the launch.
int pdae_gn_adagn_silu_fwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, int st_stride,
                           const void* z_scale, const void* z_shift, int z_stride,
                           void* out, void* mean_out, void* rstd_out, int b, int c,
                           int hw, int groups, float eps, int dtype, int fold,
                           void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mo = static_cast<float*>(mean_out);
  float* ro = static_cast<float*>(rstd_out);
  if ((mo == nullptr) != (ro == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !fold)
    return launch<float, false>(x, g, be, scale, shift, st_stride, z_scale, z_shift,
                                z_stride, out, mo, ro, b, c, hw, groups, eps, s);
  if (dtype == 0 && fold)
    return launch<float, true>(x, g, be, scale, shift, st_stride, z_scale, z_shift,
                               z_stride, out, mo, ro, b, c, hw, groups, eps, s);
  if (dtype == 1 && !fold)
    return launch<__nv_bfloat16, false>(x, g, be, scale, shift, st_stride, z_scale,
                                        z_shift, z_stride, out, mo, ro, b, c, hw, groups, eps, s);
  if (dtype == 1 && fold)
    return launch<__nv_bfloat16, true>(x, g, be, scale, shift, st_stride, z_scale,
                                       z_shift, z_stride, out, mo, ro, b, c, hw, groups, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
