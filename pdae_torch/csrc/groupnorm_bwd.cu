// Backward of the GroupNorm + AdaGN (+ shift-AdaGN) + SiLU chain for Hopper
// (sm_90a), fp32 or bf16 activations, NCHW.
//
// Replaces the TPU kernel pdae_tpu/ops/groupnorm_train.py::_bwd_kernel and
// computes what the closed form pdae_tpu/ops/groupnorm_train.py::_bwd
// computes, all in fp32, from the [B, G] mean and rsqrt(var + eps) that the
// forward kernel saved (the statistics are never reduced again):
//
//   A  = gamma (1 + scale)(1 + z_scale)
//   B  = (beta (1 + scale) + shift)(1 + z_scale) + z_shift
//   xhat = (x - mean) * inv          y = xhat * A + B
//   dy = g * sig(y) * (1 + y * (1 - sig(y)))
//   dA[b, c] = sum_hw dy * xhat      dB[b, c] = sum_hw dy
//   m1 = sum_{c in group} A dB / n   m2 = sum_{c in group} A dA / n
//   dx = inv * (dy * A - m1 - xhat * m2)
//
// y is recomputed from the fp32 fold, not from the forward's rounding
// sequence: that is the JAX package's backward, mirrored here. The grads of
// gamma, beta and the four AdaGN vectors are unfolded from dA and dB outside
// the kernel (pdae_torch/ops/groupnorm_train.py), as the JAX package unfolds
// them outside Pallas. Null scale/shift (or z_scale/z_shift) pointers stand
// for zeros; a null dx skips the input gradient (a chain whose input needs
// none) and with it the second pass.
//
// Design: the TPU kernel holds one batch element's [H*W, C] slab in VMEM and
// sums groups with a one-hot [C, G] matmul. In NCHW a (batch, group) is one
// contiguous slab of cs = C/G rows of H*W elements, so one 512-thread block
// owns one slab. Pass 1: the slab is cut into tasks (a channel row, or a
// segment of one where there are fewer rows than warps); each warp reduces
// its tasks' dA and dB with shuffles into shared memory, the block then sums
// the segments per channel in a fixed order (no atomics: the result does not
// change from run to run) and m1, m2 over the group. Pass 2 reads x and g
// again (from L2: the largest slab pair on the celeba64 path is 2 x 192 KB)
// and writes dx.
//
// Bound: bytes. x and g are read once and dx written once (12 bytes per
// element in fp32) for ~30 flops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
    v = lane < kWarps ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// dy and xhat of one element, from the fp32 fold.
__device__ __forceinline__ void point(float x, float g, float mean, float inv, float a,
                                      float b, float* dy, float* xhat) {
  *xhat = __fmul_rn(__fsub_rn(x, mean), inv);
  const float y = __fadd_rn(__fmul_rn(*xhat, a), b);
  const float sig = 1.f / (1.f + expf(-y));
  *dy = g * (sig * (1.f + y * (1.f - sig)));
}

// Shared memory: coef_a[cs], coef_b[cs], part_a[tasks], part_b[tasks].
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_adagn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const T* __restrict__ scale, const T* __restrict__ shift,
                         int st_stride, const T* __restrict__ z_scale,
                         const T* __restrict__ z_shift, int z_stride,
                         const float* __restrict__ mean_bg, const float* __restrict__ rstd_bg,
                         T* __restrict__ dx, float* __restrict__ d_a, float* __restrict__ d_b,
                         int c, int hw, int groups, int segs) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int bg = blockIdx.x;
  const int b = bg / groups;
  const int cs = c / groups;
  const int c0 = (bg - b * groups) * cs;
  const int n = cs * hw;
  const int tasks = cs * segs;
  const int seg_len = (hw + segs - 1) / segs;
  float* coef_a = smem;
  float* coef_b = smem + cs;
  float* part_a = smem + 2 * cs;
  float* part_b = part_a + tasks;
  const T* xs = x + (size_t)bg * n;
  const T* gs = g + (size_t)bg * n;
  const float mean = mean_bg[bg];
  const float inv = rstd_bg[bg];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the fold of this group's channels, in the order of _fold_affine
  for (int j = threadIdx.x; j < cs; j += kThreads) {
    const int ch = c0 + j;
    const size_t st = (size_t)b * st_stride + ch;
    const size_t zt = (size_t)b * z_stride + ch;
    const float s1 = scale ? 1.f + to_f(scale[st]) : 1.f;
    const float zs1 = z_scale ? 1.f + to_f(z_scale[zt]) : 1.f;
    coef_a[j] = __fmul_rn(__fmul_rn(gamma[ch], s1), zs1);
    float bb = __fmul_rn(beta[ch], s1);
    if (shift) bb = __fadd_rn(bb, to_f(shift[st]));
    bb = __fmul_rn(bb, zs1);
    if (z_shift) bb = __fadd_rn(bb, to_f(z_shift[zt]));
    coef_b[j] = bb;
  }
  __syncthreads();

  // pass 1: per-task partial sums of dy * xhat and dy
  for (int task = warp; task < tasks; task += kWarps) {
    const int j = task / segs;
    const int lo = (task - j * segs) * seg_len;
    const int hi = min(hw, lo + seg_len);
    const float a = coef_a[j], bb = coef_b[j];
    const T* xr = xs + (size_t)j * hw;
    const T* gr = gs + (size_t)j * hw;
    float sa = 0.f, sb = 0.f;
    for (int i = lo + lane; i < hi; i += 32) {
      float dy, xhat;
      point(to_f(xr[i]), to_f(gr[i]), mean, inv, a, bb, &dy, &xhat);
      sa = fmaf(dy, xhat, sa);
      sb += dy;
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      part_a[task] = sa;
      part_b[task] = sb;
    }
  }
  __syncthreads();

  // per channel: the segments in order; then the two group moments
  float m1 = 0.f, m2 = 0.f;
  for (int j = threadIdx.x; j < cs; j += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int s = 0; s < segs; ++s) {
      sa += part_a[j * segs + s];
      sb += part_b[j * segs + s];
    }
    d_a[(size_t)b * c + c0 + j] = sa;
    d_b[(size_t)b * c + c0 + j] = sb;
    m1 = fmaf(coef_a[j], sb, m1);
    m2 = fmaf(coef_a[j], sa, m2);
  }
  if (dx == nullptr) return;
  m1 = block_sum(m1, red) / (float)n;
  m2 = block_sum(m2, red) / (float)n;

  // pass 2: dx
  T* dxs = dx + (size_t)bg * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = i / hw;
    float dy, xhat;
    point(to_f(xs[i]), to_f(gs[i]), mean, inv, coef_a[j], coef_b[j], &dy, &xhat);
    dxs[i] = from_f<T>(inv * (dy * coef_a[j] - m1 - xhat * m2));
  }
}

template <typename T>
int launch(const void* x, const void* g, const float* gamma, const float* beta,
           const void* scale, const void* shift, int st_stride, const void* z_scale,
           const void* z_shift, int z_stride, const float* mean, const float* rstd,
           void* dx, float* d_a, float* d_b, int b, int c, int hw, int groups,
           cudaStream_t stream) {
  const int cs = c / groups;
  // fewer rows than warps: cut each row into segments, one warp each
  int segs = kWarps / cs;
  const int max_segs = (hw + 31) / 32;
  if (segs > max_segs) segs = max_segs;
  if (segs < 1) segs = 1;
  const size_t smem = (size_t)(2 * cs + 2 * cs * segs) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  gn_adagn_silu_bwd_kernel<T><<<b * groups, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), gamma, beta,
      static_cast<const T*>(scale), static_cast<const T*>(shift), st_stride,
      static_cast<const T*>(z_scale), static_cast<const T*>(z_shift), z_stride, mean, rstd,
      static_cast<T*>(dx), d_a, d_b, c, hw, groups, segs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, g, dx: contiguous [b, c, hw] (dx may be null); gamma, beta: fp32 [c];
// scale/shift: rows of c at st_stride (or both null), z_scale/z_shift likewise
// at z_stride; mean, rstd: fp32 [b * groups]; d_a, d_b: fp32 [b, c].
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for more than 6144 channels per group.
int pdae_gn_adagn_silu_bwd(const void* x, const void* g, const void* gamma,
                           const void* beta, const void* scale, const void* shift,
                           int st_stride, const void* z_scale, const void* z_shift,
                           int z_stride, const void* mean, const void* rstd, void* dx,
                           void* d_a, void* d_b, int b, int c, int hw, int groups,
                           int dtype, void* stream) {
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* me = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* da = static_cast<float*>(d_a);
  float* db = static_cast<float*>(d_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, ga, be, scale, shift, st_stride, z_scale, z_shift, z_stride,
                         me, rs, dx, da, db, b, c, hw, groups, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, ga, be, scale, shift, st_stride, z_scale, z_shift,
                                 z_stride, me, rs, dx, da, db, b, c, hw, groups, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
