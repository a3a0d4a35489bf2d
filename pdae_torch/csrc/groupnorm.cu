// GroupNorm + AdaGN (+ shift-AdaGN) + SiLU forward for Hopper (sm_90a),
// fp32 or bf16 activations, NCHW (contiguous) or NHWC (channels-last).
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
// (C/G)*H*W elements. The TPU kernel kept the whole [H*W, C] slab of a batch
// element in VMEM between the stats and the apply; two kernels here do the
// same with what a Hopper block has, chosen by the wrapper from the shape
// (pdae_torch/ops/groupnorm.py::gn_plan) before the launch:
//
//   cluster variant (gn_adagn_silu_cluster_kernel): the slab is split evenly
//     over a thread block cluster of 1, 2, 4 or 8 blocks. Each block brings
//     its part (at most 64 KB) into shared memory once with 16-byte cp.async
//     copies, sent off in four groups so that the sums of the first run while
//     the last are in flight, and a thread reads back only what it copied
//     itself; the coefficients of its first vector are fetched under the
//     copies. The
//     blocks exchange their partial sums through distributed shared memory
//     and add them in rank order, so every block and every run gets the same
//     stats (fold mode exchanges a second time for the centred squares, taken
//     from shared memory). The chain is then applied from shared memory and
//     written with 16-byte stores: the slab is read from memory once and
//     written once, which is what the bound counts. The channel of a 16-byte
//     vector is computed once per vector, with a shift where H*W is a power
//     of two. It needs 16-byte aligned x and out, a part that is a multiple
//     of 16 bytes and H*W a multiple of the vector;
//   general variant (gn_adagn_silu_kernel): one 512-thread block per slab,
//     element by element, one stats pass (two in fold mode) and an apply pass
//     over global memory. It takes every shape; its later passes come from
//     L2 only while the input and the output written so far fit there, which
//     at the large slabs of the celeba64 path ([8,256,64,64]: 33.5 MB in,
//     33.5 MB out, all blocks resident at once, 50 MB of L2) they do not.
//
// A channels-last x (the bf16 models keep their activations NHWC, the layout
// of cuDNN's bf16 kernels on sm90) goes to a third kernel, chosen by the
// wrapper from x's strides (pdae_torch/ops/groupnorm.py::nhwc_plan), model
// mode only:
//
//   NHWC variant (gn_adagn_silu_nhwc_kernel): a cluster per tile of k groups
//     of one batch element, its blocks splitting the pixels, each thread one
//     16-byte column of channels; the design is in the kernel's note below.
//
// Bound: bytes. Each element is read once and written once (8 bytes in
// fp32, 4 in bf16) for ~15 flops, far below the card's ops-per-byte ridge.
// The slabs of 16 KB and under are bound by the latency of a launch instead.
//
// The split passes (model mode; spatial parallelism, pdae_torch/parallel/sp.py):
// a rank holds some rows of each slab, so the statistics span ranks and the
// fused kernel above cannot compute them alone. Two kernels take its place:
//
//   stats pass (gn_stats_kernel): one block per (batch, group) slab of the
//     rank's rows writes the fp32 partial sums of x and of x^2, [B, G, 2];
//     the wrapper adds the ranks' sums (one all-reduce) and forms the mean
//     and rsqrt(var + eps) with the one-pass formula above. Bound: bytes,
//     one read of x;
//   apply pass (gn_apply_kernel): the model-mode chain of each element from
//     a given fp32 [B, G] mean and rstd (the Chain of the fused kernel, so
//     the same mean and rstd give the same bits), 16 bytes a thread where
//     H*W is a multiple of the vector, else one element. Bound: bytes, one
//     read of x and one write.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;          // the general variant's block
constexpr int kMaxClusterThreads = 512;
constexpr int kMaxPartBytes = 65536;   // the cluster variant's shared-memory cap per block
constexpr int kLoadGroups = 4;         // cp.async groups a part is loaded in
constexpr int kApplyThreads = 256;     // the apply pass's block
constexpr int kApplyBlocks = 132 * 8;  // the most blocks of the apply pass (a grid-stride loop)

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
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// The chain's coefficients of one channel of one batch element, and the
// chain on one element. Both variants apply it, so their values are equal.
template <typename T, bool kFold>
struct Chain {
  float a, b;          // fold: y = xhat * a + b; model: gamma, beta
  float s1, sh;        // model: 1 + scale (rounded), shift
  float z1, zsh;       // model: 1 + z_scale (rounded), z_shift

  __device__ __forceinline__ void load(const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const T* __restrict__ scale,
                                       const T* __restrict__ shift, size_t st,
                                       const T* __restrict__ z_scale,
                                       const T* __restrict__ z_shift, size_t zt, int ch) {
    if (kFold) {
      const float s1p = scale ? 1.f + to_f(scale[st]) : 1.f;
      const float z1p = z_scale ? 1.f + to_f(z_scale[zt]) : 1.f;
      a = __fmul_rn(__fmul_rn(gamma[ch], s1p), z1p);
      float bb = __fmul_rn(beta[ch], s1p);
      if (shift) bb = __fadd_rn(bb, to_f(shift[st]));
      bb = __fmul_rn(bb, z1p);
      if (z_shift) bb = __fadd_rn(bb, to_f(z_shift[zt]));
      b = bb;
    } else {
      a = gamma[ch];
      b = beta[ch];
      if (scale) {
        s1 = rnd<T>(1.f + to_f(scale[st]));
        sh = to_f(shift[st]);
      }
      if (z_scale) {
        z1 = rnd<T>(1.f + to_f(z_scale[zt]));
        zsh = to_f(z_shift[zt]);
      }
    }
  }

  __device__ __forceinline__ float apply(float xv, float mean, float inv, bool has_st,
                                         bool has_z) const {
    const float xhat = __fmul_rn(__fsub_rn(xv, mean), inv);
    if (kFold) {
      const float y = __fadd_rn(__fmul_rn(xhat, a), b);
      return __fmul_rn(y, 1.f / (1.f + expf(-y)));
    }
    float y = rnd<T>(__fadd_rn(__fmul_rn(xhat, a), b));
    if (has_st) {
      y = rnd<T>(__fmul_rn(y, s1));
      y = rnd<T>(__fadd_rn(y, sh));
    }
    if (has_z) {
      y = rnd<T>(__fmul_rn(z1, y));
      y = rnd<T>(__fadd_rn(y, zsh));
    }
    const float sig = rnd<T>(1.f / (1.f + expf(-y)));
    return __fmul_rn(y, sig);
  }
};

// ---------------------------------------------------------------- general

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
    Chain<T, kFold> chain;
    chain.load(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
               (size_t)b * z_stride + ch, ch);
    os[i] = from_f<T>(chain.apply(to_f(xs[i]), mean, inv, scale != nullptr,
                                  z_scale != nullptr));
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

// 16 bytes of T from shared memory as fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
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

// Two sums over the block in one pass; every thread gets both. red holds 66
// floats.
__device__ float2 block_sum2(float a, float b, float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) {
    red[warp] = a;
    red[33 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (blockDim.x >> 5);
    a = warp_sum(in ? red[lane] : 0.f);
    b = warp_sum(in ? red[33 + lane] : 0.f);
    if (lane == 0) {
      red[32] = a;
      red[65] = b;
    }
  }
  __syncthreads();
  return make_float2(red[32], red[65]);
}

// The cluster's totals of each block's `mine`, added in rank order by every
// block alike; every thread gets them. `slot` is this block's pair of shared
// floats that the other blocks read, `red` as in block_sum2. A slot is used
// once.
__device__ float2 cluster_total(float2 mine, float* slot, float* red, unsigned csize) {
  if (csize == 1) return mine;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    slot[0] = mine.x;
    slot[1] = mine.y;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float2 tot = make_float2(0.f, 0.f);
    for (unsigned r = 0; r < csize; ++r) {
      const float* theirs = cluster.map_shared_rank(slot, r);
      tot.x += theirs[0];
      tot.y += theirs[1];
    }
    red[32] = tot.x;
    red[65] = tot.y;
  }
  __syncthreads();
  return make_float2(red[32], red[65]);
}

template <typename T, bool kFold>
__global__ void __launch_bounds__(kMaxClusterThreads)
gn_adagn_silu_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const T* __restrict__ scale,
                  const T* __restrict__ shift, int st_stride,
                  const T* __restrict__ z_scale, const T* __restrict__ z_shift,
                  int z_stride, T* __restrict__ out, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int c, int hw, int hw_shift, int groups,
                  int part, float eps) {
  constexpr int VEC = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char raw[];
  T* xs = reinterpret_cast<T*>(raw);             // this block's part of the slab
  __shared__ float red[66];
  __shared__ float slots[4];                     // partial sums the other blocks read
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
  const T* xg = x + (size_t)bg * n + e0;
  T* og = out + (size_t)bg * n + e0;

  // vector tid + it * nthr, it in [0, iters), in kLoadGroups groups of `per`
  const int iters = (nvec + nthr - 1) / nthr;
  const int per = (iters + kLoadGroups - 1) / kLoadGroups;
#pragma unroll
  for (int g = 0; g < kLoadGroups; ++g) {
    for (int it = g * per; it < min((g + 1) * per, iters); ++it) {
      const int vi = it * nthr + tid;
      if (vi < nvec) cp_async16(xs + vi * VEC, xg + vi * VEC);
    }
    cp_async_commit();
  }

  // The coefficients of a vector's channel (hw % VEC == 0: one channel per
  // vector). The first vector's are fetched here, under the copies: a small
  // slab has no other, and its apply then waits for no second trip to
  // memory. (Fetching every later one an iteration ahead too made the large
  // slabs 7% slower.)
  const bool has_st = scale != nullptr, has_z = z_scale != nullptr;
  auto coefficients = [&](int vi) {
    Chain<T, kFold> chain = {};
    if (vi < nvec) {
      const int e = e0 + vi * VEC;
      const int ch = c0 + (hw_shift >= 0 ? e >> hw_shift : e / hw);
      chain.load(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
                 (size_t)b * z_stride + ch, ch);
    }
    return chain;
  };
  Chain<T, kFold> chain = coefficients(tid);

  float s1 = 0.f, s2 = 0.f;
  auto sums = [&](int g) {
    for (int it = g * per; it < min((g + 1) * per, iters); ++it) {
      const int vi = it * nthr + tid;
      if (vi < nvec) {
        float v[VEC];
        Vec<T>::load(xs + vi * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s1 += v[i];
          if (!kFold) s2 = fmaf(v[i], v[i], s2);
        }
      }
    }
  };
  cp_async_wait<3>(); sums(0);
  cp_async_wait<2>(); sums(1);
  cp_async_wait<1>(); sums(2);
  cp_async_wait<0>(); sums(3);

  // model mode: both sums in one block reduction and one exchange
  const float2 tot = cluster_total(block_sum2(s1, s2, red), &slots[0], red, csize);
  const float mean = tot.x / (float)n;
  float var;
  if (kFold) {
    s2 = 0.f;
    for (int it = 0; it < iters; ++it) {
      const int vi = it * nthr + tid;
      if (vi < nvec) {
        float v[VEC];
        Vec<T>::load(xs + vi * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float dv = v[i] - mean;
          s2 = fmaf(dv, dv, s2);
        }
      }
    }
    var = cluster_total(block_sum2(s2, 0.f, red), &slots[2], red, csize).x / (float)n;
  } else {
    const float mean2 = tot.y / (float)n;
    var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  }
  // no block may leave while another still reads its slots: arrive now, wait last
  if (csize > 1) cluster_arrive();
  const float inv = rsqrtf(var + eps);
  if (mean_out != nullptr && rank == 0 && tid == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = inv;
  }

  for (int it = 0; it < iters; ++it) {
    const int vi = it * nthr + tid;
    if (it > 0) chain = coefficients(vi);
    if (vi < nvec) {
      float v[VEC];
      Vec<T>::load(xs + vi * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = chain.apply(v[i], mean, inv, has_st, has_z);
      Vec<T>::store(og + vi * VEC, v);
    }
  }
  if (csize > 1) cluster_wait();
}

// ---------------------------------------------------------- split passes

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ sums, int n, int vec) {
  __shared__ float red[66];
  const int bg = blockIdx.x;
  const T* xs = x + (size_t)bg * n;
  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    constexpr int VEC = Vec<T>::kN;
    for (int i = threadIdx.x * VEC; i < n; i += kThreads * VEC) {
      float v[VEC];
      Vec<T>::load(xs + i, v);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        s1 += v[u];
        s2 = fmaf(v[u], v[u], s2);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f(xs[i]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  const float2 tot = block_sum2(s1, s2, red);
  if (threadIdx.x == 0) {
    sums[2 * bg] = tot.x;
    sums[2 * bg + 1] = tot.y;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ scale,
                const T* __restrict__ shift, int st_stride, const T* __restrict__ z_scale,
                const T* __restrict__ z_shift, int z_stride, T* __restrict__ out,
                const float* __restrict__ mean, const float* __restrict__ rstd, int c, int hw,
                int groups, long long nvec) {
  const int cs = c / groups;
  const bool has_st = scale != nullptr, has_z = z_scale != nullptr;
  for (long long vi = (long long)blockIdx.x * blockDim.x + threadIdx.x; vi < nvec;
       vi += (long long)gridDim.x * blockDim.x) {
    const long long e = vi * V;
    const long long row = e / hw;              // b * c + channel: a vector lies in one row
    const int b = (int)(row / c);
    const int ch = (int)(row - (long long)b * c);
    const int bg = b * groups + ch / cs;
    Chain<T, false> chain;
    chain.load(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
               (size_t)b * z_stride + ch, ch);
    const float m = mean[bg], inv = rstd[bg];
    float v[V];
    if constexpr (V > 1) {
      Vec<T>::load(x + e, v);
    } else {
      v[0] = to_f(x[e]);
    }
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = chain.apply(v[u], m, inv, has_st, has_z);
    if constexpr (V > 1) {
      Vec<T>::store(out + e, v);
    } else {
      out[e] = from_f<T>(v[0]);
    }
  }
}

__global__ void empty_kernel() {}

// ------------------------------------------------------------------- NHWC

#include "gn_nhwc.cuh"

// Chain<T, false>::apply on one element from its coefficients, with one
// difference in bf16: the sigmoid's reciprocal is __fdividef's (2 ulp in
// fp32, where the sigmoid is then rounded to bf16's 8 bits; on an H100 it took
// 14% off the NHWC forward at FFHQ128's 128x128 maps). fp32 divides exactly.
template <typename T>
__device__ __forceinline__ float nhwc_chain(float xv, float mean, float inv, float a, float b,
                                            float s1, float sh, float z1, float zsh,
                                            bool has_st, bool has_z) {
  const float xhat = __fmul_rn(__fsub_rn(xv, mean), inv);
  float y = rnd<T>(__fadd_rn(__fmul_rn(xhat, a), b));
  if (has_st) {
    y = rnd<T>(__fmul_rn(y, s1));
    y = rnd<T>(__fadd_rn(y, sh));
  }
  if (has_z) {
    y = rnd<T>(__fmul_rn(z1, y));
    y = rnd<T>(__fadd_rn(y, zsh));
  }
  const float d = 1.f + expf(-y);
  const float r = sizeof(T) == 2 ? __fdividef(1.f, d) : 1.f / d;
  return __fmul_rn(y, rnd<T>(r));
}

// Channels-last variant (gn_adagn_silu_nhwc_kernel, model mode). In NHWC a
// (batch, group) is cs = C/G channels strided over every pixel: at FFHQ128's
// top level 4 channels, 8 bytes of bf16 a pixel. So a cluster owns a tile of
// k groups of one batch element, [H*W, W = k*cs] channels, whose pixel rows
// are W*elt contiguous bytes, and its blocks split the pixels. Thread t owns
// one column of V channels (t % R, R = W / V 16-byte columns a row)
// over every P-th pixel of the block's part, and sums x and x^2 per channel
// in registers; the columns' sums go through shared memory (column_totals)
// to per-group sums, which the cluster exchanges through distributed shared
// memory and adds in rank order, as the NCHW cluster variant does: no
// atomics, one order. A vector holds V channels where the NCHW variant's
// holds one, so each element needs its own coefficients: a thread keeps its
// channels' gamma, beta, mean and rstd in registers and reads the AdaGN
// factors from a table in shared memory (a float4 broadcast an element, only
// where the chain has them). All of them in registers took over 100 a
// thread, and so few warps an SM that the chain's long dependent arithmetic
// (the apply is bound by it, not by memory: on an H100 the apply without its
// stores took 135 of the 215 us of [32,128,128,128]) went unhidden. kKeep:
// the part is copied into shared memory once (16-byte cp.async, four
// groups) and the chain applied from there, so x is read once and out
// written once; without it (a tile over the cluster's shared memory, or V =
// 1: unaligned or ragged channel rows) the apply reads x from memory again.
// Shared memory: the part (kKeep), scratch (column_totals's), coef [W][8],
// chan [2W], slots [2k], stats [2k].
template <typename T, int V, bool kKeep>
__global__ void __launch_bounds__(kNhwcThreads, kNhwcMinBlocks)
gn_adagn_silu_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const T* __restrict__ scale,
                          const T* __restrict__ shift, int st_stride,
                          const T* __restrict__ z_scale, const T* __restrict__ z_shift,
                          int z_stride, T* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int c, int hw, int groups, int k,
                          int npx, float eps) {
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
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid % r;                         // this thread's column
  const int step_px = nthr / r;
  const int p0 = rank * npx;
  const int np = max(0, min(npx, hw - p0));      // this block's pixels
  const T* xg = x + ((size_t)b * hw + p0) * c + c0 + j * V;
  T* og = out + ((size_t)b * hw + p0) * c + c0 + j * V;

  T* xs = reinterpret_cast<T*>(raw);
  float* scratch = reinterpret_cast<float*>(raw + (kKeep ? (size_t)npx * w_ch * sizeof(T) : 0));
  float* coef = scratch + align4((size_t)scratch_slots(r, nthr) * V * 2);
  float* chan_a = coef + 8 * w_ch;
  float* chan_b = chan_a + w_ch;
  float* slots = chan_b + w_ch;
  float* stats = slots + 2 * k;

  // pixel tid / r + it * step_px, it in [0, iters), in kLoadGroups groups of `per`
  const int first = tid / r;
  const int iters = (npx + step_px - 1) / step_px;
  const int per = (iters + kLoadGroups - 1) / kLoadGroups;
  if (kKeep) {
#pragma unroll
    for (int grp = 0; grp < kLoadGroups; ++grp) {
      for (int it = grp * per; it < min((grp + 1) * per, iters); ++it) {
        const int p = first + it * step_px;
        if (p < np) cp_async16(xs + (size_t)p * w_ch + j * V, xg + (size_t)p * c);
      }
      cp_async_commit();
    }
  }

  // under the copies: the table of the tile's coefficients (gamma, beta,
  // mean, rstd, 1 + scale, shift, 1 + z_scale, z_shift a channel)
  const bool has_st = scale != nullptr, has_z = z_scale != nullptr;
  for (int w = tid; w < w_ch; w += nthr) {
    const int ch = c0 + w;
    Chain<T, false> chain = {};
    chain.load(gamma, beta, scale, shift, (size_t)b * st_stride + ch, z_scale, z_shift,
               (size_t)b * z_stride + ch, ch);
    float* e = coef + 8 * w;
    e[0] = chain.a; e[1] = chain.b; e[4] = chain.s1; e[5] = chain.sh;
    e[6] = chain.z1; e[7] = chain.zsh;
  }

  float s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s1[u] = s2[u] = 0.f;
  auto sums = [&](int lo, int hi) {
    for (int it = lo; it < hi; ++it) {
      const int p = first + it * step_px;
      if (p < np) {
        float v[V];
        if (kKeep) load_frag<T, V>(xs + (size_t)p * w_ch + j * V, v);
        else load_frag<T, V>(xg + (size_t)p * c, v);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          s1[u] += v[u];
          s2[u] = fmaf(v[u], v[u], s2[u]);
        }
      }
    }
  };
  if (kKeep) {
    cp_async_wait<3>(); sums(0, min(per, iters));
    cp_async_wait<2>(); sums(per, min(2 * per, iters));
    cp_async_wait<1>(); sums(2 * per, min(3 * per, iters));
    cp_async_wait<0>(); sums(3 * per, iters);
  } else {
    sums(0, iters);
  }
  column_totals<V>(s1, s2, r, scratch, chan_a, chan_b);

  // the block's sums per group (its channels in order), then the cluster's in rank order
  for (int g = tid; g < k; g += nthr) {
    float a = 0.f, bb = 0.f;
    for (int w = g * cs; w < (g + 1) * cs; ++w) {
      a += chan_a[w];
      bb += chan_b[w];
    }
    slots[2 * g] = a;
    slots[2 * g + 1] = bb;
  }
  if (csize > 1) cluster.sync();
  else __syncthreads();
  const float n = (float)(cs * hw);
  for (int g = tid; g < k; g += nthr) {
    float t1 = 0.f, t2 = 0.f;
    for (unsigned q = 0; q < csize; ++q) {
      const float* theirs = csize > 1 ? cluster.map_shared_rank(slots, q) : slots;
      t1 += theirs[2 * g];
      t2 += theirs[2 * g + 1];
    }
    const float mean = t1 / n;
    const float var = fmaxf(__fsub_rn(t2 / n, __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(var + eps);
    stats[2 * g] = mean;
    stats[2 * g + 1] = inv;
    if (mean_out != nullptr && rank == 0) {
      mean_out[(size_t)b * groups + tile * k + g] = mean;
      rstd_out[(size_t)b * groups + tile * k + g] = inv;
    }
  }
  // no block may leave while another still reads its slots: arrive now, wait last
  if (csize > 1) cluster_arrive();
  __syncthreads();
  for (int w = tid; w < w_ch; w += nthr) {
    coef[8 * w + 2] = stats[2 * (w / cs)];
    coef[8 * w + 3] = stats[2 * (w / cs) + 1];
  }
  __syncthreads();

  // gamma, beta, mean and rstd of this thread's channels in registers; the
  // AdaGN factors read from the table where the chain has them
  const float* table = coef + 8 * j * V;
  float ga[V], be[V], mean[V], inv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float4 e = table_entry(table + 8 * u);
    ga[u] = e.x; be[u] = e.y; mean[u] = e.z; inv[u] = e.w;
  }
  for (int it = 0; it < iters; ++it) {
    const int p = first + it * step_px;
    if (p >= np) break;
    float v[V];
    if (kKeep) load_frag<T, V>(xs + (size_t)p * w_ch + j * V, v);
    else load_frag<T, V>(xg + (size_t)p * c, v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_st || has_z) e = table_entry(table + 8 * u + 4);
      v[u] = nhwc_chain<T>(v[u], mean[u], inv[u], ga[u], be[u], e.x, e.y, e.z, e.w, has_st,
                           has_z);
    }
    store_frag<T, V>(og + (size_t)p * c, v);
  }
  if (csize > 1) cluster_wait();
}

// ---------------------------------------------------------------- launchers

constexpr int kMaxDevices = 64;

template <typename T, bool kFold>
cudaError_t ensure_cluster_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gn_adagn_silu_cluster_kernel<T, kFold>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxPartBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

struct Args {
  const void *x, *scale, *shift, *z_scale, *z_shift;
  const float *gamma, *beta;
  void* out;
  float *mean_out, *rstd_out;
  int st_stride, z_stride, b, c, hw, groups, cluster, threads;
  float eps;
  cudaStream_t stream;
};

template <typename T, bool kFold>
int launch(const Args& a) {
  const T* x = static_cast<const T*>(a.x);
  const T* scale = static_cast<const T*>(a.scale);
  const T* shift = static_cast<const T*>(a.shift);
  const T* z_scale = static_cast<const T*>(a.z_scale);
  const T* z_shift = static_cast<const T*>(a.z_shift);
  T* out = static_cast<T*>(a.out);
  if (a.cluster == 0) {
    gn_adagn_silu_kernel<T, kFold><<<a.b * a.groups, kThreads, 0, a.stream>>>(
        x, a.gamma, a.beta, scale, shift, a.st_stride, z_scale, z_shift, a.z_stride, out,
        a.mean_out, a.rstd_out, a.c, a.hw, a.groups, a.eps);
    return (int)cudaGetLastError();
  }
  constexpr int VEC = 16 / (int)sizeof(T);
  const long long n = (long long)(a.c / a.groups) * a.hw;
  const long long part = n / a.cluster;
  const bool cluster_ok = a.cluster == 1 || a.cluster == 2 || a.cluster == 4 || a.cluster == 8;
  if (!cluster_ok || part * a.cluster != n || part % VEC != 0 || a.hw % VEC != 0
      || part * (long long)sizeof(T) > kMaxPartBytes || a.threads < 32
      || a.threads > kMaxClusterThreads || a.threads % 32 != 0
      || reinterpret_cast<uintptr_t>(a.x) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_cluster_smem<T, kFold>();
  if (err != cudaSuccess) return (int)err;
  int hw_shift = -1;
  if ((a.hw & (a.hw - 1)) == 0)
    for (hw_shift = 0; (1 << hw_shift) < a.hw; ++hw_shift) {}
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(a.b * a.groups * a.cluster));
  config.blockDim = dim3((unsigned)a.threads);
  config.dynamicSmemBytes = (size_t)part * sizeof(T);
  config.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, gn_adagn_silu_cluster_kernel<T, kFold>, x, a.gamma,
                           a.beta, scale, shift, a.st_stride, z_scale, z_shift,
                           a.z_stride, out, a.mean_out, a.rstd_out, a.c, a.hw, hw_shift,
                           a.groups, (int)part, a.eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const void* x, float* sums, int b, int c, int hw, int groups,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int n = c / groups * hw;
  const int vec = n % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  gn_stats_kernel<T><<<b * groups, kThreads, 0, stream>>>(static_cast<const T*>(x), sums, n,
                                                           vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const Args& a, const float* mean, const float* rstd) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const long long total = (long long)a.b * a.c * a.hw;
  const bool vec = a.hw % VEC == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const long long nvec = vec ? total / VEC : total;
  long long blocks = (nvec + kApplyThreads - 1) / kApplyThreads;
  if (blocks > kApplyBlocks) blocks = kApplyBlocks;
  if (blocks < 1) blocks = 1;
  const T* x = static_cast<const T*>(a.x);
  const T* scale = static_cast<const T*>(a.scale);
  const T* shift = static_cast<const T*>(a.shift);
  const T* z_scale = static_cast<const T*>(a.z_scale);
  const T* z_shift = static_cast<const T*>(a.z_shift);
  T* out = static_cast<T*>(a.out);
  if (vec)
    gn_apply_kernel<T, VEC><<<(unsigned)blocks, kApplyThreads, 0, a.stream>>>(
        x, a.gamma, a.beta, scale, shift, a.st_stride, z_scale, z_shift, a.z_stride, out, mean,
        rstd, a.c, a.hw, a.groups, nvec);
  else
    gn_apply_kernel<T, 1><<<(unsigned)blocks, kApplyThreads, 0, a.stream>>>(
        x, a.gamma, a.beta, scale, shift, a.st_stride, z_scale, z_shift, a.z_stride, out, mean,
        rstd, a.c, a.hw, a.groups, nvec);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kKeep>
int launch_nhwc_as(const Args& a, const NhwcPlan& p) {
  const int w_ch = p.k * (a.c / a.groups);
  const size_t smem = (kKeep ? (size_t)p.npx * w_ch * sizeof(T) : 0)
                      + (align4((size_t)scratch_slots(w_ch / V, p.threads) * V * 2)
                         + 10 * (size_t)w_ch + 4 * (size_t)p.k) * sizeof(float);
  return launch_clusters<gn_adagn_silu_nhwc_kernel<T, V, kKeep>>(
      p, a.b * (a.groups / p.k), smem, a.stream, static_cast<const T*>(a.x), a.gamma, a.beta,
      static_cast<const T*>(a.scale), static_cast<const T*>(a.shift), a.st_stride,
      static_cast<const T*>(a.z_scale), static_cast<const T*>(a.z_shift), a.z_stride,
      static_cast<T*>(a.out), a.mean_out, a.rstd_out, a.c, a.hw, a.groups, p.k, p.npx, a.eps);
}

template <typename T>
int launch_nhwc(const Args& a, const NhwcPlan& p) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (!nhwc_plan_ok(p, a.c, a.hw, a.groups, VEC)) return (int)cudaErrorInvalidValue;
  if (p.vec == 1) return launch_nhwc_as<T, 1, false>(a, p);
  if (a.c % VEC != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0
      || reinterpret_cast<uintptr_t>(a.out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.keep) return launch_nhwc_as<T, VEC, true>(a, p);
  return launch_nhwc_as<T, VEC, false>(a, p);
}

}  // namespace

extern "C" {

// The stats pass: sums fp32 [b * groups, 2] (sum of x, sum of x^2 over each
// slab of the contiguous [b, c, hw] x). dtype as below. Returns the launch's
// error code, 0 on success.
int pdae_gn_stats(const void* x, void* sums, int b, int c, int hw, int groups, int dtype,
                  void* stream) {
  if (c % groups != 0) return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(sums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stats<float>(x, s, b, c, hw, groups, st);
  if (dtype == 1) return launch_stats<__nv_bfloat16>(x, s, b, c, hw, groups, st);
  return (int)cudaErrorInvalidValue;
}

// The apply pass (model mode): out from x as pdae_gn_adagn_silu_fwd's
// arguments, with the statistics read from mean, rstd fp32 [b * groups].
int pdae_gn_apply(const void* x, const void* gamma, const void* beta, const void* scale,
                  const void* shift, int st_stride, const void* z_scale, const void* z_shift,
                  int z_stride, void* out, const void* mean, const void* rstd, int b, int c,
                  int hw, int groups, int dtype, void* stream) {
  Args a = {};
  a.x = x; a.scale = scale; a.shift = shift; a.z_scale = z_scale; a.z_shift = z_shift;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
  a.st_stride = st_stride; a.z_stride = z_stride;
  a.b = b; a.c = c; a.hw = hw; a.groups = groups;
  a.stream = static_cast<cudaStream_t>(stream);
  if (c % groups != 0) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  if (dtype == 0) return launch_apply<float>(a, m, r);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(a, m, r);
  return (int)cudaErrorInvalidValue;
}

// x, out: contiguous [b, c, hw]; gamma, beta: fp32 [c]; scale/shift: rows of
// c at st_stride (or both null), z_scale/z_shift likewise at z_stride.
// mean_out, rstd_out: fp32 [b * groups], or both null.
// dtype: 0 = float32, 1 = bfloat16. fold: 0 = model mode, 1 = fold mode.
// cluster: 0 = the general variant; 1, 2, 4 or 8 = the cluster variant with
// that many blocks of `threads` threads per slab (what it asks of the shape
// is in the header; a shape it does not take returns cudaErrorInvalidValue).
// Returns the launch's error code, 0 on success.
int pdae_gn_adagn_silu_fwd(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, int st_stride,
                           const void* z_scale, const void* z_shift, int z_stride,
                           void* out, void* mean_out, void* rstd_out, int b, int c,
                           int hw, int groups, float eps, int dtype, int fold,
                           int cluster, int threads, void* stream) {
  Args a;
  a.x = x; a.scale = scale; a.shift = shift; a.z_scale = z_scale; a.z_shift = z_shift;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
  a.mean_out = static_cast<float*>(mean_out);
  a.rstd_out = static_cast<float*>(rstd_out);
  a.st_stride = st_stride; a.z_stride = z_stride;
  a.b = b; a.c = c; a.hw = hw; a.groups = groups; a.cluster = cluster; a.threads = threads;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  if ((a.mean_out == nullptr) != (a.rstd_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !fold) return launch<float, false>(a);
  if (dtype == 0 && fold) return launch<float, true>(a);
  if (dtype == 1 && !fold) return launch<__nv_bfloat16, false>(a);
  if (dtype == 1 && fold) return launch<__nv_bfloat16, true>(a);
  return (int)cudaErrorInvalidValue;
}

// The NHWC variant (model mode): x, out channels-last [b, hw, c]; the other
// tensors as pdae_gn_adagn_silu_fwd's. k groups a tile, `cluster` blocks of
// `threads` threads a tile with npx pixels each, vec 1 or the 16-byte vector,
// keep: the part held in shared memory (what each asks is in the kernel's
// note; a launch it does not take returns cudaErrorInvalidValue).
int pdae_gn_adagn_silu_nhwc_fwd(const void* x, const void* gamma, const void* beta,
                                const void* scale, const void* shift, int st_stride,
                                const void* z_scale, const void* z_shift, int z_stride,
                                void* out, void* mean_out, void* rstd_out, int b, int c,
                                int hw, int groups, float eps, int dtype, int k, int cluster,
                                int threads, int npx, int vec, int keep, void* stream) {
  Args a = {};
  a.x = x; a.scale = scale; a.shift = shift; a.z_scale = z_scale; a.z_shift = z_shift;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
  a.mean_out = static_cast<float*>(mean_out);
  a.rstd_out = static_cast<float*>(rstd_out);
  a.st_stride = st_stride; a.z_stride = z_stride;
  a.b = b; a.c = c; a.hw = hw; a.groups = groups;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  if (c % groups != 0 || (a.mean_out == nullptr) != (a.rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const NhwcPlan p = {k, cluster, threads, npx, vec, keep};
  if (dtype == 0) return launch_nhwc<float>(a, p);
  if (dtype == 1) return launch_nhwc<__nv_bfloat16>(a, p);
  return (int)cudaErrorInvalidValue;
}

// A kernel that does nothing, launched as the kernels above are: its device
// time is the floor under every small launch.
int pdae_launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
