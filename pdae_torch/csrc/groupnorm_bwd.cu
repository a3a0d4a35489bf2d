// Backward of the GroupNorm + AdaGN (+ shift-AdaGN) + SiLU chain for Hopper
// (sm_90a), fp32 or bf16 activations, NCHW (contiguous) or NHWC
// (channels-last).
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
// Bound: bytes. x and g are read once and dx written once: 12 bytes per
// element in fp32 (6 in bf16) with dx, 8 (4) without, for ~30 flops, far
// below the card's ops-per-byte ridge. dx needs m1 and m2, which need the
// sums over the whole (batch, group) slab, so every element is touched twice:
// the question is where it waits between the two passes. In NCHW a (batch,
// group) is one contiguous slab of cs = C/G rows of H*W elements. Two kernels,
// chosen by the wrapper from the shape before the launch
// (pdae_torch/ops/groupnorm_train.py::gn_bwd_plan):
//
//   cluster variant (gn_adagn_silu_bwd_cluster_kernel): the slab pair (x and
//     g) is split evenly over a thread block cluster of 1, 2, 4 or 8 blocks.
//     With dx, each block copies its contiguous part of x and of g into
//     shared memory once with 16-byte cp.async copies, sent off in four
//     groups so that the sums of the first run while the last are in flight;
//     a thread reads back only what it copied itself. Pass 1 spreads the
//     part's 16-byte vectors evenly over all threads (no warp idles for want
//     of a channel row) and takes a vector's channel once, with a shift where
//     H*W is a power of two. Each warp adds its sums into its own row of
//     per-channel bins: where a warp's 32 vectors lie in one channel it sums
//     in registers until the channel changes, elsewhere it runs a segmented
//     scan over its lanes. The bins are added in warp order, the blocks
//     exchange those partials through distributed shared memory and add them
//     in rank order: no atomics, so every block and every run gets the same
//     dA, dB, m1 and m2 (they feed the parameter gradients). Exactly one
//     block writes each channel's dA and dB. Pass 2 computes dx from shared
//     memory and writes it with 16-byte stores: x and g are read from memory
//     once and dx written once, which is what the bound counts. In fp32, pass
//     1 overwrites the part with xhat and dy, so pass 2 needs no second expf
//     (8-14% faster on an H100 than recomputing them at the train step's
//     32x32 and 64x64 slabs);
//     in bf16 the part would round them, and pass 2 recomputes. Without dx
//     nothing is kept: each vector goes from memory to registers once.
//     It needs 16-byte aligned x, g and dx, a part that is a multiple of 16
//     bytes, H*W a multiple of the vector and at most kMaxChannels rows;
//   general variant (gn_adagn_silu_bwd_kernel): one 512-thread block per
//     slab, element by element; a warp per channel row (or a segment of one
//     where there are fewer rows than warps) reduces dA and dB, the block adds
//     them in a fixed order, and pass 2 reads x and g from memory again. It
//     takes every shape up to 6144 channels per group. The second read comes
//     from L2 only while the slabs in flight fit there, which at the large
//     slabs of the celeba64 train step they do not: [32,384,64,64] holds
//     ~528 slab pairs of 384 KB in flight, ~200 MB against 50 MB of L2, and
//     moves ~20 bytes per element in fp32 where the bound counts 12.
//
// Channels-last x and g (the bf16 models) go to a third kernel, chosen by
// the wrapper from x's strides (pdae_torch/ops/groupnorm_train.py::
// nhwc_plan_for):
//
//   NHWC variant (gn_adagn_silu_bwd_nhwc_kernel): a cluster per tile of k
//     groups of one batch element, its blocks splitting the pixels, each
//     thread one 16-byte column of channels, dA and dB column sums; the
//     design is in the kernel's note below.
//
// The split passes (spatial parallelism, pdae_torch/parallel/sp.py): a rank
// holds some rows of each slab, so m1 and m2 span ranks. Two kernels take
// the fused one's place:
//
//   moments pass (the general variant with kMoments): dA and dB of the
//     rank's rows, and the partial sums sum_c A dB and sum_c A dA of each
//     (batch, group), [B, G, 2], not yet divided by n; the wrapper adds the
//     ranks' moments (one all-reduce) and divides by the whole slab's n.
//     Bound: bytes, one read of x and g;
//   dx pass (gn_bwd_dx_kernel): dx = inv * (dy * A - m1 - xhat * m2) of each
//     element from the given fp32 [B, G, 2] m1, m2, recomputing dy and xhat
//     as the fused kernels do, 16 bytes a thread where H*W is a multiple of
//     the vector. Bound: bytes, one read of x and g, one write of dx.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;           // the general variant's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClusterThreads = 512;
constexpr int kMaxChannels = 128;       // channels per group the cluster variant takes
constexpr int kMaxPairBytes = 196608;   // x and g of one block's part, at most
constexpr int kMaxSmem = 232448;        // what a block may use on sm_90
constexpr int kLoadGroups = 4;          // cp.async groups a part is loaded in

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

// The fold of channel ch of batch element b, in the order of _fold_affine.
template <typename T>
__device__ __forceinline__ void fold(const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     const T* __restrict__ scale, const T* __restrict__ shift,
                                     size_t st, const T* __restrict__ z_scale,
                                     const T* __restrict__ z_shift, size_t zt, int ch,
                                     float* a, float* b) {
  const float s1 = scale ? 1.f + to_f(scale[st]) : 1.f;
  const float zs1 = z_scale ? 1.f + to_f(z_scale[zt]) : 1.f;
  *a = __fmul_rn(__fmul_rn(gamma[ch], s1), zs1);
  float bb = __fmul_rn(beta[ch], s1);
  if (shift) bb = __fadd_rn(bb, to_f(shift[st]));
  bb = __fmul_rn(bb, zs1);
  if (z_shift) bb = __fadd_rn(bb, to_f(z_shift[zt]));
  *b = bb;
}

// ---------------------------------------------------------------- general

// Shared memory: coef_a[cs], coef_b[cs], part_a[tasks], part_b[tasks].
// kMoments: the moments pass (no dx; the unnormalised m1, m2 to moments).
template <typename T, bool kMoments>
__global__ void __launch_bounds__(kThreads)
gn_adagn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const T* __restrict__ scale, const T* __restrict__ shift,
                         int st_stride, const T* __restrict__ z_scale,
                         const T* __restrict__ z_shift, int z_stride,
                         const float* __restrict__ mean_bg, const float* __restrict__ rstd_bg,
                         T* __restrict__ dx, float* __restrict__ d_a, float* __restrict__ d_b,
                         float* __restrict__ moments, int c, int hw, int groups, int segs) {
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

  for (int j = threadIdx.x; j < cs; j += kThreads) {
    const int ch = c0 + j;
    fold(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
         (size_t)b * z_stride + ch, ch, &coef_a[j], &coef_b[j]);
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
  if (kMoments) {
    m1 = block_sum(m1, red);
    m2 = block_sum(m2, red);
    if (threadIdx.x == 0) {
      moments[2 * bg] = m1;
      moments[2 * bg + 1] = m2;
    }
    return;
  }
  if (dx == nullptr) return;
  m1 = block_sum(m1, red) / (float)n;
  m2 = block_sum(m2, red) / (float)n;

  // pass 2: dx, reading x and g from memory again
  T* dxs = dx + (size_t)bg * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = i / hw;
    float dy, xhat;
    point(to_f(xs[i]), to_f(gs[i]), mean, inv, coef_a[j], coef_b[j], &dy, &xhat);
    dxs[i] = from_f<T>(inv * (dy * coef_a[j] - m1 - xhat * m2));
  }
}

// ---------------------------------------------------------------- dx pass

template <typename T, int V>
__global__ void __launch_bounds__(256)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const T* __restrict__ scale, const T* __restrict__ shift, int st_stride,
                 const T* __restrict__ z_scale, const T* __restrict__ z_shift, int z_stride,
                 const float* __restrict__ mean_bg, const float* __restrict__ rstd_bg,
                 const float* __restrict__ moments, T* __restrict__ dx, int c, int hw,
                 int groups, long long nvec) {
  const int cs = c / groups;
  for (long long vi = (long long)blockIdx.x * blockDim.x + threadIdx.x; vi < nvec;
       vi += (long long)gridDim.x * blockDim.x) {
    const long long e = vi * V;
    const long long row = e / hw;              // b * c + channel: a vector lies in one row
    const int b = (int)(row / c);
    const int ch = (int)(row - (long long)b * c);
    const int bg = b * groups + ch / cs;
    float a, bb;
    fold(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
         (size_t)b * z_stride + ch, ch, &a, &bb);
    const float mean = mean_bg[bg], inv = rstd_bg[bg];
    const float m1 = moments[2 * bg], m2 = moments[2 * bg + 1];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float dy, xhat;
      point(to_f(x[e + u]), to_f(g[e + u]), mean, inv, a, bb, &dy, &xhat);
      dx[e + u] = from_f<T>(inv * (dy * a - m1 - xhat * m2));
    }
  }
}

// ---------------------------------------------------------------- cluster

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const size_t src = __cvta_generic_to_global(gmem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The halves of cluster.sync(), so that work can sit between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of T as fp32, from shared or global memory, and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void unpack(float4 r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static __forceinline__ void load(const float* p, float* v) {
    unpack(*reinterpret_cast<const float4*>(p), v);
  }
  __device__ static __forceinline__ void load_global(const float* p, float* v) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), v);
  }
  __device__ static __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void unpack(uint4 r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static __forceinline__ void load_global(const __nv_bfloat16* p, float* v) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Dynamic shared memory of the cluster variant, in this order: the x part
// and the g part (kKeep only), then floats: coef_a[cs], coef_b[cs] (the
// fold), tot_a[cs], tot_b[cs] (the cluster's sums), slot_a[cs], slot_b[cs]
// (this block's sums, which the other blocks read), bins[warps][2][nloc].
//
// kKeep: dx is made, so the part waits in shared memory between the passes.
template <typename T, bool kKeep>
__global__ void __launch_bounds__(kMaxClusterThreads)
gn_adagn_silu_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, const T* __restrict__ scale,
                                 const T* __restrict__ shift, int st_stride,
                                 const T* __restrict__ z_scale, const T* __restrict__ z_shift,
                                 int z_stride, const float* __restrict__ mean_bg,
                                 const float* __restrict__ rstd_bg, T* __restrict__ dx,
                                 float* __restrict__ d_a, float* __restrict__ d_b, int c,
                                 int hw, int hw_shift, int groups, int part) {
  constexpr int VEC = Vec<T>::kN;
  // fp32 keeps xhat and dy from pass 1 in place of x and g
  constexpr bool kStash = kKeep && sizeof(T) == sizeof(float);
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ float moments[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int bg = blockIdx.x / csize;
  const int b = bg / groups;
  const int cs = c / groups;
  const int c0 = (bg - b * groups) * cs;
  const int n = cs * hw;                         // = csize * part
  const int e0 = rank * part;                    // this block's first element of the slab
  const int nvec = part / VEC;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T* xg = x + (size_t)bg * n + e0;
  const T* gg = g + (size_t)bg * n + e0;
  auto channel = [&](int e) { return hw_shift >= 0 ? e >> hw_shift : e / hw; };
  const int j_first = channel(e0);
  const int nloc = channel(e0 + part - 1) - j_first + 1;   // channels this part touches

  T* xs = reinterpret_cast<T*>(raw);
  T* gs = xs + (kKeep ? part : 0);
  float* coef_a = reinterpret_cast<float*>(gs + (kKeep ? part : 0));
  float* coef_b = coef_a + cs;
  float* tot_a = coef_b + cs;
  float* tot_b = tot_a + cs;
  float* slot_a = tot_b + cs;
  float* slot_b = slot_a + cs;
  float* bins = slot_b + cs;
  float* bin_a = bins + warp * 2 * nloc;         // this warp's bins
  float* bin_b = bin_a + nloc;

  // vector tid + it * nthr, it in [0, iters), in kLoadGroups groups of `per`
  const int iters = (nvec + nthr - 1) / nthr;
  const int per = (iters + kLoadGroups - 1) / kLoadGroups;
  if (kKeep) {
#pragma unroll
    for (int grp = 0; grp < kLoadGroups; ++grp) {
      for (int it = grp * per; it < min((grp + 1) * per, iters); ++it) {
        const int vi = it * nthr + tid;
        if (vi < nvec) {
          cp_async16(xs + vi * VEC, xg + vi * VEC);
          cp_async16(gs + vi * VEC, gg + vi * VEC);
        }
      }
      cp_async_commit();
    }
  }

  // under the copies: the fold of the group's channels, this warp's bins
  for (int j = tid; j < cs; j += nthr) {
    const int ch = c0 + j;
    fold(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
         (size_t)b * z_stride + ch, ch, &coef_a[j], &coef_b[j]);
  }
  for (int k = lane; k < 2 * nloc; k += 32) bin_a[k] = 0.f;
  const float mean = mean_bg[bg];
  const float inv = rstd_bg[bg];
  __syncthreads();

  // pass 1. Where each warp's 32 vectors lie in one channel (uniform), a
  // thread sums in registers and the warp flushes into its bin when the
  // channel changes; elsewhere a segmented scan over the lanes gives each
  // run of one channel's lanes its sum, which the run's first lane adds.
  const bool uniform = hw % (32 * VEC) == 0 && part % (32 * VEC) == 0;
  int cur = -1;
  float ca = 0.f, cb = 0.f;
  auto flush = [&]() {                           // uniform: warp-uniform call
    const float fa = warp_sum(ca), fb = warp_sum(cb);
    if (lane == 0) {
      bin_a[cur] += fa;
      bin_b[cur] += fb;
    }
    ca = cb = 0.f;
  };
  auto pass1 = [&](int it) {
    const int vi = it * nthr + tid;
    const bool valid = vi < nvec;
    if (uniform && !valid) return;               // the whole warp is past the end
    int jl = INT_MAX;
    float sa = 0.f, sb = 0.f;
    if (valid) {
      const int j = channel(e0 + vi * VEC);
      jl = j - j_first;
      const float a = coef_a[j], bb = coef_b[j];
      float xv[VEC], gv[VEC];
      if (kKeep) {
        Vec<T>::load(xs + vi * VEC, xv);
        Vec<T>::load(gs + vi * VEC, gv);
      } else {
        Vec<T>::load_global(xg + vi * VEC, xv);
        Vec<T>::load_global(gg + vi * VEC, gv);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float dy, xhat;
        point(xv[i], gv[i], mean, inv, a, bb, &dy, &xhat);
        sa = fmaf(dy, xhat, sa);
        sb += dy;
        xv[i] = xhat;
        gv[i] = dy;
      }
      if (kStash) {
        Vec<T>::store(xs + vi * VEC, xv);
        Vec<T>::store(gs + vi * VEC, gv);
      }
    }
    if (uniform) {
      if (jl != cur) {
        if (cur >= 0) flush();
        cur = jl;
      }
      ca += sa;
      cb += sb;
      return;
    }
    for (int off = 1; off < 32; off <<= 1) {     // suffix sums within a run
      const float oa = __shfl_down_sync(0xffffffffu, sa, off);
      const float ob = __shfl_down_sync(0xffffffffu, sb, off);
      const int ok = __shfl_down_sync(0xffffffffu, jl, off);
      if (lane + off < 32 && ok == jl) {
        sa += oa;
        sb += ob;
      }
    }
    const int before = __shfl_up_sync(0xffffffffu, jl, 1);
    if (jl != INT_MAX && (lane == 0 || before != jl)) {
      bin_a[jl] += sa;
      bin_b[jl] += sb;
    }
  };
  auto pass1_group = [&](int grp) {
    for (int it = grp * per; it < min((grp + 1) * per, iters); ++it) pass1(it);
  };
  if (kKeep) {
    cp_async_wait<3>(); pass1_group(0);
    cp_async_wait<2>(); pass1_group(1);
    cp_async_wait<1>(); pass1_group(2);
    cp_async_wait<0>(); pass1_group(3);
  } else {
    for (int it = 0; it < iters; ++it) pass1(it);
  }
  if (uniform && cur >= 0) flush();
  __syncthreads();

  // this block's sums per channel: the warps' bins in warp order
  const int warps = nthr >> 5;
  for (int k = tid; k < nloc; k += nthr) {
    float sa = 0.f, sb = 0.f;
    for (int w = 0; w < warps; ++w) {
      sa += bins[w * 2 * nloc + k];
      sb += bins[w * 2 * nloc + nloc + k];
    }
    slot_a[j_first + k] = sa;
    slot_b[j_first + k] = sb;
  }
  // the cluster's sums: the blocks whose parts touch channel j, in rank order
  if (csize > 1) cluster.sync();
  else __syncthreads();
  for (int j = tid; j < cs; j += nthr) {
    float sa = 0.f, sb = 0.f;
    const int r_hi = ((j + 1) * hw - 1) / part;
    for (int r = j * hw / part; r <= r_hi; ++r) {
      const float* ra = csize > 1 ? cluster.map_shared_rank(slot_a, r) : slot_a;
      const float* rb = csize > 1 ? cluster.map_shared_rank(slot_b, r) : slot_b;
      sa += ra[j];
      sb += rb[j];
    }
    tot_a[j] = sa;
    tot_b[j] = sb;
    if (j % (int)csize == (int)rank) {
      d_a[(size_t)b * c + c0 + j] = sa;
      d_b[(size_t)b * c + c0 + j] = sb;
    }
  }
  // no block may leave while another still reads its slots: arrive now, wait last
  if (csize > 1) cluster_arrive();

  if (kKeep) {
    __syncthreads();
    if (warp == 0) {
      float p1 = 0.f, p2 = 0.f;
      for (int j = lane; j < cs; j += 32) {
        p1 = fmaf(coef_a[j], tot_b[j], p1);
        p2 = fmaf(coef_a[j], tot_a[j], p2);
      }
      p1 = warp_sum(p1);
      p2 = warp_sum(p2);
      if (lane == 0) {
        moments[0] = p1 / (float)n;
        moments[1] = p2 / (float)n;
      }
    }
    __syncthreads();
    const float m1 = moments[0], m2 = moments[1];

    // pass 2: dx from shared memory, 16-byte stores
    T* dxg = dx + (size_t)bg * n + e0;
    for (int it = 0; it < iters; ++it) {
      const int vi = it * nthr + tid;
      if (vi >= nvec) break;
      const int j = channel(e0 + vi * VEC);
      const float a = coef_a[j];
      float xv[VEC], gv[VEC], out[VEC];
      Vec<T>::load(xs + vi * VEC, xv);
      Vec<T>::load(gs + vi * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float dy = gv[i], xhat = xv[i];
        if (!kStash) point(xv[i], gv[i], mean, inv, a, coef_b[j], &dy, &xhat);
        out[i] = inv * (dy * a - m1 - xhat * m2);
      }
      Vec<T>::store(dxg + vi * VEC, out);
    }
  }
  if (csize > 1) cluster_wait();
}

// ------------------------------------------------------------------- NHWC

#include "gn_nhwc.cuh"

// point() with one difference in bf16: the sigmoid's reciprocal is
// __fdividef's (2 ulp in fp32, beside dx's rounding to bf16; on an H100 it
// took 7% off the NHWC backward of the bf16 FFHQ128 step). fp32 divides
// exactly.
template <typename T>
__device__ __forceinline__ void point_nhwc(float x, float g, float mean, float inv, float a,
                                           float b, float* dy, float* xhat) {
  *xhat = __fmul_rn(__fsub_rn(x, mean), inv);
  const float y = __fadd_rn(__fmul_rn(*xhat, a), b);
  const float d = 1.f + expf(-y);
  const float sig = sizeof(T) == 2 ? __fdividef(1.f, d) : 1.f / d;
  *dy = g * (sig * (1.f + y * (1.f - sig)));
}

// Channels-last variant (gn_adagn_silu_bwd_nhwc_kernel). A cluster owns a
// tile of k groups of one batch element, [H*W, W = k*cs] channels of x and
// of g, whose blocks split the pixels, as the NHWC forward's do. Thread t
// owns one 16-byte column of V channels (t % R) over every P-th pixel
// of the block's part and sums dy * xhat and dy per channel in registers; it
// keeps its channels' fold (A, B), mean and rstd in registers too, read once
// from a table in shared memory (8 floats a channel), where pass 2 reads each
// group's m1 and m2 (a float2 broadcast an element), so that three blocks
// share an SM. dA and dB are column sums in this layout: column_totals gives
// the block's, the blocks exchange them through distributed shared memory
// and add them in rank order (no atomics: every block and every run gets the
// same dA, dB, m1 and m2), and block `rank` writes the channels w with w %
// csize == rank. m1 and m2 are each group's channels in order. kKeep (dx is
// made and the pair fits): the block's part of x and g is copied into shared
// memory once (16-byte cp.async, four groups) and pass 2 computes dx
// from there, recomputing dy and xhat; so x and g are read from memory once
// and dx written once. Without it (no dx, a pair over the cluster's shared
// memory, or V = 1) pass 2 reads x and g again. Shared memory: the x and g
// parts (kKeep), scratch (column_totals's), rec [W][8], chan_a, chan_b,
// tot_a, tot_b [W], moments [2k].
template <typename T, int V, bool kKeep>
__global__ void __launch_bounds__(kNhwcThreads, kNhwcMinBlocks)
gn_adagn_silu_bwd_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const T* __restrict__ scale, const T* __restrict__ shift,
                              int st_stride, const T* __restrict__ z_scale,
                              const T* __restrict__ z_shift, int z_stride,
                              const float* __restrict__ mean_bg,
                              const float* __restrict__ rstd_bg, T* __restrict__ dx,
                              float* __restrict__ d_a, float* __restrict__ d_b, int c, int hw,
                              int groups, int k, int npx) {
  extern __shared__ __align__(16) unsigned char raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tiles = groups / k;
  const int bt = blockIdx.x / csize;
  const int b = bt / tiles;
  const int tile = bt - b * tiles;
  const int cs = c / groups;
  const int w_ch = k * cs;                       // the tile's channels
  const int r = w_ch / V;                        // vectors a pixel row
  const int c0 = tile * w_ch;
  const int g0 = tile * k;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid % r;                         // this thread's column
  const int step_px = nthr / r;
  const int p0 = rank * npx;
  const int np = max(0, min(npx, hw - p0));      // this block's pixels
  const size_t at = ((size_t)b * hw + p0) * c + c0 + j * V;
  const T* xg = x + at;
  const T* gg = g + at;

  const size_t part = kKeep ? (size_t)npx * w_ch : 0;
  T* xs = reinterpret_cast<T*>(raw);
  T* gs = xs + part;
  float* scratch = reinterpret_cast<float*>(gs + part);
  float* rec = scratch + align4((size_t)scratch_slots(r, nthr) * V * 2);
  float* chan_a = rec + 8 * w_ch;
  float* chan_b = chan_a + w_ch;
  float* tot_a = chan_b + w_ch;
  float* tot_b = tot_a + w_ch;
  float* moments = tot_b + w_ch;

  // pixel tid / r + it * step_px, it in [0, iters), in kLoadGroups groups of `per`
  const int first = tid / r;
  const int iters = (npx + step_px - 1) / step_px;
  const int per = (iters + kLoadGroups - 1) / kLoadGroups;
  if (kKeep) {
#pragma unroll
    for (int grp = 0; grp < kLoadGroups; ++grp) {
      for (int it = grp * per; it < min((grp + 1) * per, iters); ++it) {
        const int p = first + it * step_px;
        if (p < np) {
          cp_async16(xs + (size_t)p * w_ch + j * V, xg + (size_t)p * c);
          cp_async16(gs + (size_t)p * w_ch + j * V, gg + (size_t)p * c);
        }
      }
      cp_async_commit();
    }
  }

  // under the copies: each channel's fold, mean and rstd (rec[w] = A, B, mean, rstd)
  for (int w = tid; w < w_ch; w += nthr) {
    const int ch = c0 + w;
    float* e = rec + 8 * w;
    fold(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
         (size_t)b * z_stride + ch, ch, &e[0], &e[1]);
    e[2] = mean_bg[(size_t)b * groups + g0 + w / cs];
    e[3] = rstd_bg[(size_t)b * groups + g0 + w / cs];
  }
  __syncthreads();
  // this thread's channels' A, B, mean and rstd in registers; m1 and m2 (pass
  // 2) read from the table
  const float* table = rec + 8 * j * V;
  float ca[V], cb[V], mean[V], inv[V], sa[V], sb[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float4 e = table_entry(table + 8 * u);
    ca[u] = e.x; cb[u] = e.y; mean[u] = e.z; inv[u] = e.w;
    sa[u] = sb[u] = 0.f;
  }

  // pass 1: this thread's sums of dy * xhat and dy per channel
  auto pass1 = [&](int lo, int hi) {
    for (int it = lo; it < hi; ++it) {
      const int p = first + it * step_px;
      if (p < np) {
        float xv[V], gv[V];
        if (kKeep) {
          load_frag<T, V>(xs + (size_t)p * w_ch + j * V, xv);
          load_frag<T, V>(gs + (size_t)p * w_ch + j * V, gv);
        } else {
          load_frag<T, V>(xg + (size_t)p * c, xv);
          load_frag<T, V>(gg + (size_t)p * c, gv);
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          float dy, xhat;
          point_nhwc<T>(xv[u], gv[u], mean[u], inv[u], ca[u], cb[u], &dy, &xhat);
          sa[u] = fmaf(dy, xhat, sa[u]);
          sb[u] += dy;
        }
      }
    }
  };
  if (kKeep) {
    cp_async_wait<3>(); pass1(0, min(per, iters));
    cp_async_wait<2>(); pass1(per, min(2 * per, iters));
    cp_async_wait<1>(); pass1(2 * per, min(3 * per, iters));
    cp_async_wait<0>(); pass1(3 * per, iters);
  } else {
    pass1(0, iters);
  }
  column_totals<V>(sa, sb, r, scratch, chan_a, chan_b);

  // the cluster's sums per channel, in rank order
  if (csize > 1) cluster.sync();
  for (int w = tid; w < w_ch; w += nthr) {
    float ta = 0.f, tb = 0.f;
    for (unsigned q = 0; q < csize; ++q) {
      const float* ra = csize > 1 ? cluster.map_shared_rank(chan_a, q) : chan_a;
      const float* rb = csize > 1 ? cluster.map_shared_rank(chan_b, q) : chan_b;
      ta += ra[w];
      tb += rb[w];
    }
    tot_a[w] = ta;
    tot_b[w] = tb;
    if (w % (int)csize == (int)rank) {
      d_a[(size_t)b * c + c0 + w] = ta;
      d_b[(size_t)b * c + c0 + w] = tb;
    }
  }
  // no block may leave while another still reads its sums: arrive now, wait last
  if (csize > 1) cluster_arrive();

  if (dx != nullptr) {
    __syncthreads();
    const float n = (float)(cs * hw);
    for (int q = tid; q < k; q += nthr) {
      float m1 = 0.f, m2 = 0.f;
      for (int w = q * cs; w < (q + 1) * cs; ++w) {
        m1 = fmaf(rec[8 * w], tot_b[w], m1);
        m2 = fmaf(rec[8 * w], tot_a[w], m2);
      }
      moments[2 * q] = m1 / n;
      moments[2 * q + 1] = m2 / n;
    }
    __syncthreads();
    for (int w = tid; w < w_ch; w += nthr) {
      rec[8 * w + 4] = moments[2 * (w / cs)];
      rec[8 * w + 5] = moments[2 * (w / cs) + 1];
    }
    __syncthreads();

    // pass 2: dx, from shared memory (kKeep) or memory
    T* dxg = dx + at;
    for (int it = 0; it < iters; ++it) {
      const int p = first + it * step_px;
      if (p >= np) break;
      float xv[V], gv[V], out[V];
      if (kKeep) {
        load_frag<T, V>(xs + (size_t)p * w_ch + j * V, xv);
        load_frag<T, V>(gs + (size_t)p * w_ch + j * V, gv);
      } else {
        load_frag<T, V>(xg + (size_t)p * c, xv);
        load_frag<T, V>(gg + (size_t)p * c, gv);
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float2 m = table_entry2(table + 8 * u + 4);
        float dy, xhat;
        point_nhwc<T>(xv[u], gv[u], mean[u], inv[u], ca[u], cb[u], &dy, &xhat);
        out[u] = inv[u] * (dy * ca[u] - m.x - xhat * m.y);
      }
      store_frag<T, V>(dxg + (size_t)p * c, out);
    }
  }
  if (csize > 1) cluster_wait();
}

// ---------------------------------------------------------------- launchers

constexpr int kMaxDevices = 64;

template <typename T, bool kKeep>
cudaError_t ensure_cluster_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gn_adagn_silu_bwd_cluster_kernel<T, kKeep>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - 1024);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Args {
  const void *x, *g, *scale, *shift, *z_scale, *z_shift;
  const float *gamma, *beta, *mean, *rstd;
  void* dx;
  float *d_a, *d_b;
  int st_stride, z_stride, b, c, hw, groups, cluster, threads;
  cudaStream_t stream;
};

template <typename T, bool kMoments = false>
int launch_general(const Args& a, float* moments = nullptr) {
  const int cs = a.c / a.groups;
  // fewer rows than warps: cut each row into segments, one warp each
  int segs = kWarps / cs;
  const int max_segs = (a.hw + 31) / 32;
  if (segs > max_segs) segs = max_segs;
  if (segs < 1) segs = 1;
  const size_t smem = (size_t)(2 * cs + 2 * cs * segs) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  gn_adagn_silu_bwd_kernel<T, kMoments><<<a.b * a.groups, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.beta,
      static_cast<const T*>(a.scale), static_cast<const T*>(a.shift), a.st_stride,
      static_cast<const T*>(a.z_scale), static_cast<const T*>(a.z_shift), a.z_stride,
      a.mean, a.rstd, static_cast<T*>(a.dx), a.d_a, a.d_b, moments, a.c, a.hw, a.groups,
      segs);
  return (int)cudaGetLastError();
}

template <typename T, bool kKeep>
int launch_cluster(const Args& a, int hw_shift, int part, size_t smem) {
  cudaError_t err = ensure_cluster_smem<T, kKeep>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(a.b * a.groups * a.cluster));
  config.blockDim = dim3((unsigned)a.threads);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, gn_adagn_silu_bwd_cluster_kernel<T, kKeep>,
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.beta,
      static_cast<const T*>(a.scale), static_cast<const T*>(a.shift), a.st_stride,
      static_cast<const T*>(a.z_scale), static_cast<const T*>(a.z_shift), a.z_stride,
      a.mean, a.rstd, static_cast<T*>(a.dx), a.d_a, a.d_b, a.c, a.hw, hw_shift, a.groups,
      part);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  if (a.cluster == 0) return launch_general<T>(a);
  constexpr int VEC = 16 / (int)sizeof(T);
  const int cs = a.c / a.groups;
  const long long n = (long long)cs * a.hw;
  const long long part = n / a.cluster;
  const bool keep = a.dx != nullptr;
  const bool cluster_ok = a.cluster == 1 || a.cluster == 2 || a.cluster == 4 || a.cluster == 8;
  if (!cluster_ok || part * a.cluster != n || part % VEC != 0 || a.hw % VEC != 0
      || cs > kMaxChannels || 2 * part * (long long)sizeof(T) > kMaxPairBytes
      || a.threads < 32 || a.threads > kMaxClusterThreads || a.threads % 32 != 0
      || reinterpret_cast<uintptr_t>(a.x) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.g) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int hw_shift = -1;
  if ((a.hw & (a.hw - 1)) == 0)
    for (hw_shift = 0; (1 << hw_shift) < a.hw; ++hw_shift) {}
  // a part of `part` elements touches at most this many channels
  long long nloc = (part + a.hw - 1) / a.hw + 1;
  if (nloc > cs) nloc = cs;
  const size_t smem = (keep ? 2 * part * sizeof(T) : 0)
                      + (6 * cs + 2 * (a.threads / 32) * nloc) * sizeof(float);
  if (smem > (size_t)(kMaxSmem - 1024)) return (int)cudaErrorInvalidValue;
  if (!keep) return launch_cluster<T, false>(a, hw_shift, (int)part, smem);
  return launch_cluster<T, true>(a, hw_shift, (int)part, smem);
}

template <typename T>
int launch_dx(const Args& a, const float* moments) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int kDxThreads = 256, kDxBlocks = 132 * 8;
  const long long total = (long long)a.b * a.c * a.hw;
  const bool vec = a.hw % VEC == 0;
  const long long nvec = vec ? total / VEC : total;
  long long blocks = (nvec + kDxThreads - 1) / kDxThreads;
  if (blocks > kDxBlocks) blocks = kDxBlocks;
  if (blocks < 1) blocks = 1;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* scale = static_cast<const T*>(a.scale);
  const T* shift = static_cast<const T*>(a.shift);
  const T* z_scale = static_cast<const T*>(a.z_scale);
  const T* z_shift = static_cast<const T*>(a.z_shift);
  T* dx = static_cast<T*>(a.dx);
  if (vec)
    gn_bwd_dx_kernel<T, VEC><<<(unsigned)blocks, kDxThreads, 0, a.stream>>>(
        x, g, a.gamma, a.beta, scale, shift, a.st_stride, z_scale, z_shift, a.z_stride, a.mean,
        a.rstd, moments, dx, a.c, a.hw, a.groups, nvec);
  else
    gn_bwd_dx_kernel<T, 1><<<(unsigned)blocks, kDxThreads, 0, a.stream>>>(
        x, g, a.gamma, a.beta, scale, shift, a.st_stride, z_scale, z_shift, a.z_stride, a.mean,
        a.rstd, moments, dx, a.c, a.hw, a.groups, nvec);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kKeep>
int launch_nhwc_as(const Args& a, const NhwcPlan& p) {
  const int w_ch = p.k * (a.c / a.groups);
  const size_t smem = (kKeep ? 2 * (size_t)p.npx * w_ch * sizeof(T) : 0)
                      + (align4((size_t)scratch_slots(w_ch / V, p.threads) * V * 2)
                         + 12 * (size_t)w_ch + 2 * (size_t)p.k) * sizeof(float);
  return launch_clusters<gn_adagn_silu_bwd_nhwc_kernel<T, V, kKeep>>(
      p, a.b * (a.groups / p.k), smem, a.stream, static_cast<const T*>(a.x),
      static_cast<const T*>(a.g), a.gamma, a.beta, static_cast<const T*>(a.scale),
      static_cast<const T*>(a.shift), a.st_stride, static_cast<const T*>(a.z_scale),
      static_cast<const T*>(a.z_shift), a.z_stride, a.mean, a.rstd, static_cast<T*>(a.dx),
      a.d_a, a.d_b, a.c, a.hw, a.groups, p.k, p.npx);
}

// The NHWC variant's launch; p.keep asks for dx.
template <typename T>
int launch_nhwc(const Args& a, const NhwcPlan& p) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (!nhwc_plan_ok(p, a.c, a.hw, a.groups, VEC) || (p.keep && a.dx == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.vec == 1) return launch_nhwc_as<T, 1, false>(a, p);
  if (a.c % VEC != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.g) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.keep) return launch_nhwc_as<T, VEC, true>(a, p);
  return launch_nhwc_as<T, VEC, false>(a, p);
}

Args split_args(const void* x, const void* g, const void* gamma, const void* beta,
                const void* scale, const void* shift, int st_stride, const void* z_scale,
                const void* z_shift, int z_stride, const void* mean, const void* rstd, int b,
                int c, int hw, int groups, void* stream) {
  Args a = {};
  a.x = x; a.g = g; a.scale = scale; a.shift = shift; a.z_scale = z_scale;
  a.z_shift = z_shift;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.st_stride = st_stride; a.z_stride = z_stride;
  a.b = b; a.c = c; a.hw = hw; a.groups = groups;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

// The moments pass: d_a, d_b fp32 [b, c] of the rank's rows and moments fp32
// [b * groups, 2] (sum_c A dB, sum_c A dA, not divided by n); the other
// arguments as pdae_gn_adagn_silu_bwd's. Returns the launch's error code.
int pdae_gn_bwd_moments(const void* x, const void* g, const void* gamma, const void* beta,
                        const void* scale, const void* shift, int st_stride,
                        const void* z_scale, const void* z_shift, int z_stride,
                        const void* mean, const void* rstd, void* d_a, void* d_b,
                        void* moments, int b, int c, int hw, int groups, int dtype,
                        void* stream) {
  Args a = split_args(x, g, gamma, beta, scale, shift, st_stride, z_scale, z_shift, z_stride,
                      mean, rstd, b, c, hw, groups, stream);
  a.d_a = static_cast<float*>(d_a);
  a.d_b = static_cast<float*>(d_b);
  if (c % groups != 0) return (int)cudaErrorInvalidValue;
  float* m = static_cast<float*>(moments);
  if (dtype == 0) return launch_general<float, true>(a, m);
  if (dtype == 1) return launch_general<__nv_bfloat16, true>(a, m);
  return (int)cudaErrorInvalidValue;
}

// The dx pass: dx [b, c, hw] from x, g and moments fp32 [b * groups, 2]
// (m1, m2: the whole slab's, divided by its n).
int pdae_gn_bwd_dx(const void* x, const void* g, const void* gamma, const void* beta,
                   const void* scale, const void* shift, int st_stride, const void* z_scale,
                   const void* z_shift, int z_stride, const void* mean, const void* rstd,
                   const void* moments, void* dx, int b, int c, int hw, int groups, int dtype,
                   void* stream) {
  Args a = split_args(x, g, gamma, beta, scale, shift, st_stride, z_scale, z_shift, z_stride,
                      mean, rstd, b, c, hw, groups, stream);
  a.dx = dx;
  if (c % groups != 0) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(moments);
  if (dtype == 0) return launch_dx<float>(a, m);
  if (dtype == 1) return launch_dx<__nv_bfloat16>(a, m);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx: contiguous [b, c, hw] (dx may be null); gamma, beta: fp32 [c];
// scale/shift: rows of c at st_stride (or both null), z_scale/z_shift likewise
// at z_stride; mean, rstd: fp32 [b * groups]; d_a, d_b: fp32 [b, c].
// dtype: 0 = float32, 1 = bfloat16. cluster: 0 = the general variant; 1, 2,
// 4 or 8 = the cluster variant with that many blocks of `threads` threads per
// slab (what it asks of the shape is in the header). Returns the launch's
// error code, 0 on success, or cudaErrorInvalidValue for a shape the variant
// does not take.
int pdae_gn_adagn_silu_bwd(const void* x, const void* g, const void* gamma,
                           const void* beta, const void* scale, const void* shift,
                           int st_stride, const void* z_scale, const void* z_shift,
                           int z_stride, const void* mean, const void* rstd, void* dx,
                           void* d_a, void* d_b, int b, int c, int hw, int groups,
                           int dtype, int cluster, int threads, void* stream) {
  Args a;
  a.x = x; a.g = g; a.scale = scale; a.shift = shift; a.z_scale = z_scale;
  a.z_shift = z_shift;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.dx = dx;
  a.d_a = static_cast<float*>(d_a);
  a.d_b = static_cast<float*>(d_b);
  a.st_stride = st_stride; a.z_stride = z_stride;
  a.b = b; a.c = c; a.hw = hw; a.groups = groups; a.cluster = cluster; a.threads = threads;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// The NHWC variant: x, g, dx channels-last [b, hw, c] (dx may be null); the
// other tensors as pdae_gn_adagn_silu_bwd's; k, cluster, threads, npx, vec
// and keep as pdae_gn_adagn_silu_nhwc_fwd's (groupnorm.cu), keep only with dx.
// Returns the launch's error code, 0 on success, or cudaErrorInvalidValue for
// a launch the variant does not take.
int pdae_gn_adagn_silu_bwd_nhwc(const void* x, const void* g, const void* gamma,
                                const void* beta, const void* scale, const void* shift,
                                int st_stride, const void* z_scale, const void* z_shift,
                                int z_stride, const void* mean, const void* rstd, void* dx,
                                void* d_a, void* d_b, int b, int c, int hw, int groups,
                                int dtype, int k, int cluster, int threads, int npx, int vec,
                                int keep, void* stream) {
  Args a = split_args(x, g, gamma, beta, scale, shift, st_stride, z_scale, z_shift, z_stride,
                      mean, rstd, b, c, hw, groups, stream);
  a.dx = dx;
  a.d_a = static_cast<float*>(d_a);
  a.d_b = static_cast<float*>(d_b);
  if (c % groups != 0) return (int)cudaErrorInvalidValue;
  const NhwcPlan p = {k, cluster, threads, npx, vec, keep};
  if (dtype == 0) return launch_nhwc<float>(a, p);
  if (dtype == 1) return launch_nhwc<__nv_bfloat16>(a, p);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
