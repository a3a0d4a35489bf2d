// Spatial self-attention forward for Hopper (sm_90a), fp32 or bf16 in and out.
//
// Replaces the TPU kernel pdae_tpu/ops/attention.py::_attn_kernel, with its
// math in the same order: q and k are each scaled by D^-1/4 (rounded to the
// input dtype, as the plain version rounds them) and taken to fp32, the
// logits q.k^T are summed in fp32, the softmax is fp32 over the full row
// (max-subtract, exp, divide by the sum), the weights are cast to v's dtype,
// and w.v is summed in fp32 and cast to the output dtype.
//
// Layout: q, k, v, out are contiguous [B*H, T, D]: or, under spatial
// parallelism, q and out [B*H, Tq, D] (a rank's query rows) against k and v
// [B*H, Tk, D] (every key, gathered), where the score rows are [BM, Tk]
// and Tq sets the grid; Tq == Tk runs the same instructions as before; the wrapper
// (pdae_torch/ops/attention.py) permutes the head split into that layout and
// picks the tiling (attention_plan) that this file's launcher dispatches on.
//
// Design. The TPU kernel kept one whole [T, T] logits tile per (batch, head)
// in VMEM; a Hopper block has 227 KB, and at the shapes of the celeba64 path
// the work is so small (67 MFLOP at [8,4,64,128]) that the time is latency
// and occupancy, not flops. So:
//   * one block of 4 or 8 warps owns BM (8 to 64) query rows of one (batch,
//     head); the wrapper takes the tallest tile that still fills the card,
//     since a taller tile re-reads K and V less often and reuses each value
//     read from shared memory in more FMAs;
//   * K and then V stream through a three-slot ring of BN-key tiles in shared
//     memory, filled by 16-byte cp.async copies (rows past T zero-filled by
//     the copy itself); the V tiles are in flight while the logits and the
//     softmax are computed. The query tile comes in the same way with the
//     first K tile (a loop of plain loads would wait out one trip to memory
//     per iteration). The thread that copied a chunk of Q or K scales it in
//     place when it has landed, so the logits loop is loads and FMAs alone.
//     Shared memory is BM rows of Q and of fp32 scores plus the ring: it
//     does not grow with T*D, and T <= 1024, D <= 256 fit;
//   * the block keeps its [BM, T] fp32 scores in shared memory and makes two
//     sweeps over the key tiles, K for the logits and V for w.v, with the
//     softmax of the TPU kernel (no online rescaling) between them;
//   * register tiles: in the logits sweep a warp owns BM/warps query rows
//     (read as float4 that its lanes share) and a lane BN/32 keys (rows
//     padded by 16 bytes, so a quarter-warp's float4 reads hit 32 banks):
//     BM/warps x BN/32 accumulators per thread; in the w.v sweep a thread
//     owns R rows x one float4 of output columns and walks the keys four at
//     a time. (A 64-row tile of 4 warps with 8 x 4 accumulators per thread
//     was tried and was slower at every path shape: four warps do not hide
//     the latency of their own loads.)
// fp32 inputs are multiplied on the CUDA cores in full fp32 (a TF32 mma
// would keep 10 bits of mantissa). bf16 with D of 32, 64 or 128 goes to a
// second kernel further down with both products on the tensor cores
// (mma.sync m16n8k16); at any other D the bf16 instantiation runs this
// kernel on the CUDA cores in its smallest tile. What holds the CUDA-core sweeps back where the card
// is full (b32) is shared memory's return path: a 16-byte read costs a warp
// four cycles of it whether or not its lanes share the address, and a
// thread's (r + c) reads feed only 4*r*c FMAs; 8 x 8 register tiles, or an
// error-compensated tensor-core product, would lift that.
//
// Bound: 4*B*H*T*D*elt bytes (q, k, v read once, out written once) against
// 4*B*H*T*T*D flops on the fp32 CUDA cores. Every query tile re-reads its
// head's K and V through L2, which the bound does not count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;     // ring slots; two tiles are in flight ahead of the one computed on
constexpr int kItems = 2;      // (row group, float4 column) items of the w.v sweep per thread

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive elements as fp32 (generic pointer: global or shared).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 16 bytes global -> shared, asynchronously; with valid false the 16 bytes
// are zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const size_t src = __cvta_generic_to_global(gmem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Score row stride in floats: T rounded up to 4 (the w.v sweep reads four
// weights at a time) plus 4, so that neighbouring rows start 4 banks apart.
__host__ __device__ constexpr int score_stride(int t) { return ((t + 3) & ~3) + 4; }

// A thread's walk over the 16-byte chunks of a [rows][d] tile: chunk tid,
// tid + threads, ... as (row, chunk in row), advanced without a divide.
struct ChunkWalk {
  int cpr, r_init, c_init, r_step, c_step;
  __device__ ChunkWalk(int chunks_per_row, int tid, int threads)
      : cpr(chunks_per_row), r_init(tid / chunks_per_row),
        c_init(tid - r_init * chunks_per_row), r_step(threads / chunks_per_row),
        c_step(threads - r_step * chunks_per_row) {}
  template <typename F> __device__ __forceinline__ void each(int nrows, F f) const {
    int r = r_init, c = c_init;
    while (r < nrows) {
      f(r, c);
      r += r_step;
      c += c_step;
      if (c >= cpr) { c -= cpr; ++r; }
    }
  }
};

// Rows first .. first + nrows - 1 of src [t][d] into dst rows of dst_stride
// elements, asynchronously; rows past t are zero-filled. No commit.
template <typename T>
__device__ __forceinline__ void copy_rows(const ChunkWalk& w, T* dst, int dst_stride,
                                          const T* src, int d, int first, int nrows, int t) {
  constexpr int VEC = 16 / (int)sizeof(T);
  w.each(nrows, [&](int r, int c) {
    const bool ok = first + r < t;
    cp_async16(dst + r * dst_stride + c * VEC,
               src + (size_t)(ok ? first + r : 0) * d + c * VEC, ok);
  });
}

// x * scale in place over the chunks this thread copied (the same walk),
// rounded to T as the plain version rounds q * scale and k * scale.
template <typename T>
__device__ __forceinline__ void scale_rows(const ChunkWalk& w, T* rows, int stride,
                                           int nrows, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  w.each(nrows, [&](int r, int c) {
    T* p = rows + r * stride + c * VEC;
#pragma unroll
    for (int u = 0; u < VEC; u += 4) {
      float4 x = load4(p + u);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      store4(p + u, x);
    }
  });
}

// The full-row softmax of nrows score rows by one warp: max, exp, divide by
// the sum, the weights rounded to T; columns [t, tpad) are set to zero.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* rows, int ts, int nrows, int t,
                                             int tpad, int lane) {
  for (int rr = 0; rr < nrows; ++rr) {
    float* row = rows + rr * ts;
    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < t; j += 32) row[j] = rnd<T>(row[j] / sum);
    for (int j = t + lane; j < tpad; j += 32) row[j] = 0.f;
  }
}

template <typename T, int BM, int BN, int NW, int R>
__global__ void __launch_bounds__(NW * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     int nq, int nk, int d, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int kThreads = NW * 32;
  constexpr int RW = BM / NW;                // query rows per warp
  constexpr int CK = BN / 32;                // keys per lane, logits sweep
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = score_stride(nk);
  const int kv_stride = d + VEC;             // K/V row in shared memory, 16 bytes of padding
  const int tile_elems = BN * kv_stride;
  T* qs = reinterpret_cast<T*>(smem);                // [BM][d] scaled query rows
  float* sc = reinterpret_cast<float*>(qs + BM * d); // [BM][ts] scores, then weights
  T* ring = reinterpret_cast<T*>(sc + BM * ts);      // [kStages][BN][kv_stride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const size_t qbase = (size_t)blockIdx.y * nq * d;
  const size_t kbase = (size_t)blockIdx.y * nk * d;
  const int nt = (nk + BN - 1) / BN;         // key tiles; tiles [0,nt) are K, [nt,2nt) are V

  const ChunkWalk walk(d / VEC, tid, kThreads);
  auto fetch = [&](int tile) {
    if (tile < 2 * nt) {
      const bool is_k = tile < nt;
      copy_rows(walk, ring + (tile % kStages) * tile_elems, kv_stride,
                (is_k ? k : v) + kbase, d, (is_k ? tile : tile - nt) * BN, BN, nk);
    }
    cp_async_commit();   // an empty group keeps the wait counts uniform
  };

  // The query tile, in the first K tile's group; rows past T are zeros
  // (their scores are computed and never stored).
  copy_rows(walk, qs, d, q + qbase, d, row0, BM, nq);
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  // The w.v sweep's items: (group of R rows, float4 of output columns).
  const int col4 = d >> 2;
  const int items = (BM / R) * col4;
  int it_row[kItems], it_col[kItems];
  bool it_ok[kItems];
  float4 acc[kItems][R];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int item = tid + u * kThreads;
    it_ok[u] = item < items;
    const int rg = item / col4;
    it_row[u] = rg * R;
    it_col[u] = (item - rg * col4) * 4;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc[u][rr] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = 0; i < 2 * nt; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed (this thread's copies)
    T* tile = ring + (i % kStages) * tile_elems;
    if (i == 0) scale_rows(walk, qs, d, BM, scale);
    if (i < nt) scale_rows(walk, tile, kv_stride, BN, scale);
    __syncthreads();                // ... everyone's; and tile i-1 is done with
    fetch(i + kStages - 1);         // into the slot tile i-1 has left

    if (i < nt) {
      // logits of BM rows against this tile's BN keys
      const int j0 = i * BN;
      float a[RW][CK];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
#pragma unroll
        for (int cc = 0; cc < CK; ++cc) a[rr][cc] = 0.f;
      const T* qrow = qs + warp * RW * d;
      for (int c = 0; c < d; c += 4) {
        float4 kk[CK];
#pragma unroll
        for (int cc = 0; cc < CK; ++cc) {
          kk[cc] = load4(tile + (lane + 32 * cc) * kv_stride + c);
        }
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const float4 qq = load4(qrow + rr * d + c);
#pragma unroll
          for (int cc = 0; cc < CK; ++cc) {
            a[rr][cc] = fmaf(qq.x, kk[cc].x, a[rr][cc]);
            a[rr][cc] = fmaf(qq.y, kk[cc].y, a[rr][cc]);
            a[rr][cc] = fmaf(qq.z, kk[cc].z, a[rr][cc]);
            a[rr][cc] = fmaf(qq.w, kk[cc].w, a[rr][cc]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
#pragma unroll
        for (int cc = 0; cc < CK; ++cc) {
          const int j = j0 + lane + 32 * cc;
          if (j < nk) sc[(warp * RW + rr) * ts + j] = a[rr][cc];
        }

      if (i == nt - 1) {
        // the full-row softmax; a warp owns its RW rows
        __syncthreads();
        softmax_rows<T>(sc + warp * RW * ts, ts, RW, nk, (nk + 3) & ~3, lane);
        // the next iteration's __syncthreads publishes the weights
      }
    } else {
      // w.v over this tile's keys, four at a time; rows past T are zero in
      // the tile and their weights are zero in the padding
      const int j0 = (i - nt) * BN;
      const int jn = min(BN, ((nk - j0) + 3) & ~3);
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (!it_ok[u]) continue;
        const float* prow = sc + it_row[u] * ts + j0;
        const T* vcol = tile + it_col[u];
        for (int jj = 0; jj < jn; jj += 4) {
          float4 vv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) vv[x] = load4(vcol + (jj + x) * kv_stride);
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float4 pp = *reinterpret_cast<const float4*>(prow + rr * ts + jj);
            float4 o = acc[u][rr];
            o.x = fmaf(pp.x, vv[0].x, o.x); o.y = fmaf(pp.x, vv[0].y, o.y);
            o.z = fmaf(pp.x, vv[0].z, o.z); o.w = fmaf(pp.x, vv[0].w, o.w);
            o.x = fmaf(pp.y, vv[1].x, o.x); o.y = fmaf(pp.y, vv[1].y, o.y);
            o.z = fmaf(pp.y, vv[1].z, o.z); o.w = fmaf(pp.y, vv[1].w, o.w);
            o.x = fmaf(pp.z, vv[2].x, o.x); o.y = fmaf(pp.z, vv[2].y, o.y);
            o.z = fmaf(pp.z, vv[2].z, o.z); o.w = fmaf(pp.z, vv[2].w, o.w);
            o.x = fmaf(pp.w, vv[3].x, o.x); o.y = fmaf(pp.w, vv[3].y, o.y);
            o.z = fmaf(pp.w, vv[3].z, o.z); o.w = fmaf(pp.w, vv[3].w, o.w);
            acc[u][rr] = o;
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (!it_ok[u]) continue;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = row0 + it_row[u] + rr;
      if (row < nq) store4(out + qbase + (size_t)row * d + it_col[u], acc[u][rr]);
    }
  }
}


// ------------------------------------------------- bf16 on the tensor cores

// Four (two) 8x8 b16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8, and gets the two elements 2 * (l % 4) and
// 2 * (l % 4) + 1 of row l / 4 of each matrix (with .trans, of column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Score row stride of the tensor-core kernel: T rounded up to 32 plus 8
// floats, so that the 8-byte fragment reads and writes of 8 rows x 4 column
// pairs hit 32 banks.
__host__ __device__ constexpr int mma_score_stride(int t) { return ((t + 31) & ~31) + 8; }

// The same two sweeps for bf16 with both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), D = DH in {32, 64, 128}.
// One block of 4 warps owns MT tiles of 16 query rows. Q, K and V rows sit
// in shared memory as bf16 with 16 bytes of padding (ldmatrix then reads 8
// rows from 8 different bank groups); q and k are scaled and rounded to
// bf16 in place, as the plain version rounds them. In the logits sweep a
// warp owns 16 of a tile's 64 keys (two 8-key fragments of K, read once per
// 16 values of D and used for every row tile); the scores go to shared
// memory as fp32 and the full-row softmax is the CUDA-core kernel's. In the
// w.v sweep the weights, already rounded to bf16 as the TPU kernel casts
// them, are packed into A fragments from shared memory, V comes through
// ldmatrix.trans, and a warp owns DH/4 of the output columns.
template <int MT, int DH>
__global__ void __launch_bounds__(128)
attention_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int nq, int nk,
                              float scale) {
  using T = __nv_bfloat16;
  constexpr int BM = 16 * MT, BN = 64, NW = 4;
  constexpr int STR = DH + 8;                // a Q, K or V row in shared memory
  constexpr int NPW = DH / 32;               // 8-column output fragments per warp
  constexpr int tile_elems = BN * STR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = mma_score_stride(nk);
  T* qs = reinterpret_cast<T*>(smem);                   // [BM][STR]
  float* sc = reinterpret_cast<float*>(qs + BM * STR);  // [BM][ts]
  T* ring = reinterpret_cast<T*>(sc + BM * ts);         // [kStages][BN][STR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;    // fragment row and column pair
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix and row this lane addresses
  const int row0 = blockIdx.x * BM;
  const size_t qbase = (size_t)blockIdx.y * nq * DH;
  const size_t kbase = (size_t)blockIdx.y * nk * DH;
  const int nt = (nk + BN - 1) / BN;

  const ChunkWalk walk(DH / 8, tid, NW * 32);
  auto fetch = [&](int tile) {
    if (tile < 2 * nt) {
      const bool is_k = tile < nt;
      copy_rows(walk, ring + (tile % kStages) * tile_elems, STR, (is_k ? k : v) + kbase,
                DH, (is_k ? tile : tile - nt) * BN, BN, nk);
    }
    cp_async_commit();
  };
  copy_rows(walk, qs, STR, q + qbase, DH, row0, BM, nq);
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float acc[MT][NPW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int np = 0; np < NPW; ++np)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][np][x] = 0.f;

  for (int i = 0; i < 2 * nt; ++i) {
    cp_async_wait<kStages - 2>();
    T* tile = ring + (i % kStages) * tile_elems;
    if (i == 0) scale_rows(walk, qs, STR, BM, scale);
    if (i < nt) scale_rows(walk, tile, STR, BN, scale);
    __syncthreads();
    fetch(i + kStages - 1);

    if (i < nt) {
      // logits: this warp's keys are 16 * warp .. + 15 of the tile
      const int j0 = i * BN + 16 * warp;
      float c[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 4; ++x) c[mt][h][x] = 0.f;
      // K fragments: matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15),
      // (keys 8-15, d 0-7), (keys 8-15, d 8-15); Q fragments: (rows 0-7,
      // d 0-7), (rows 8-15, d 0-7), (rows 0-7, d 8-15), (rows 8-15, d 8-15)
      const T* b_row = tile + (16 * warp + (lm >> 1) * 8 + lr) * STR + (lm & 1) * 8;
      const T* a_row = qs + ((lm & 1) * 8 + lr) * STR + (lm >> 1) * 8;
#pragma unroll
      for (int k0 = 0; k0 < DH; k0 += 16) {
        uint32_t kf[4];
        ldmatrix_x4(kf, b_row + k0);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t qf[4];
          ldmatrix_x4(qf, a_row + mt * 16 * STR + k0);
          mma_bf16(c[mt][0], qf, kf[0], kf[1]);
          mma_bf16(c[mt][1], qf, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = j0 + h * 8 + 2 * tq;
          float* lo = sc + (mt * 16 + g) * ts + col;
          float* hi = lo + 8 * ts;
          if (col < nk) { lo[0] = c[mt][h][0]; hi[0] = c[mt][h][2]; }
          if (col + 1 < nk) { lo[1] = c[mt][h][1]; hi[1] = c[mt][h][3]; }
        }

      if (i == nt - 1) {
        __syncthreads();
        softmax_rows<T>(sc + warp * (BM / NW) * ts, ts, BM / NW, nk, (nk + 15) & ~15, lane);
      }
    } else {
      // w.v: 16 keys a step; rows past T are zero in the tile and their
      // weights are zero in the padding
      const int j0 = (i - nt) * BN;
      const int jn = min(BN, ((nk - j0) + 15) & ~15);
      for (int kk = 0; kk < jn; kk += 16) {
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p = sc + (mt * 16 + g) * ts + j0 + kk + 2 * tq;
          const float2 p0 = *reinterpret_cast<const float2*>(p);
          const float2 p1 = *reinterpret_cast<const float2*>(p + 8 * ts);
          const float2 p2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 p3 = *reinterpret_cast<const float2*>(p + 8 * ts + 8);
          pf[mt][0] = pack_bf16(p0.x, p0.y);
          pf[mt][1] = pack_bf16(p1.x, p1.y);
          pf[mt][2] = pack_bf16(p2.x, p2.y);
          pf[mt][3] = pack_bf16(p3.x, p3.y);
        }
        // V fragments through ldmatrix.trans: matrices (keys 0-7, columns of
        // one fragment), (keys 8-15, the same columns), then the next fragment
        const T* v_row = tile + (kk + (lm & 1) * 8 + lr) * STR + warp * NPW * 8;
        if constexpr (NPW == 1) {
          uint32_t vf[2];
          ldmatrix_x2_trans(vf, v_row);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][0], pf[mt], vf[0], vf[1]);
        } else {
#pragma unroll
          for (int np = 0; np < NPW; np += 2) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, v_row + (np + (lm >> 1)) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][np], pf[mt], vf[0], vf[1]);
              mma_bf16(acc[mt][np + 1], pf[mt], vf[2], vf[3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int np = 0; np < NPW; ++np) {
      const int col = (warp * NPW + np) * 8 + 2 * tq;
      const int row = row0 + mt * 16 + g;
      if (row < nq)
        *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row * DH + col) =
            pack_bf16(acc[mt][np][0], acc[mt][np][1]);
      if (row + 8 < nq)
        *reinterpret_cast<uint32_t*>(out + qbase + (size_t)(row + 8) * DH + col) =
            pack_bf16(acc[mt][np][2], acc[mt][np][3]);
    }
}

size_t mma_smem_bytes(int t, int dh, int bm) {
  const int tiles = 2 * ((t + 63) / 64);
  return (size_t)bm * ((size_t)(dh + 8) * 2 + sizeof(float) * mma_score_stride(t))
         + (size_t)(tiles < kStages ? tiles : kStages) * 64 * (size_t)(dh + 8) * 2;
}

// A ring slot is left out where K and V together are fewer tiles than slots.
size_t smem_bytes(int t, int d, int elt, int bm, int bn) {
  const int tiles = 2 * ((t + bn - 1) / bn);
  return (size_t)bm * ((size_t)d * elt + sizeof(float) * score_stride(t))
         + (size_t)(tiles < kStages ? tiles : kStages) * bn * ((size_t)d * elt + 16);
}

constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory cap on the current device only
// when a launch needs more than was set before, so the host pays for
// cudaFuncSetAttribute once per (instantiation, device, larger size).
template <typename T, int BM, int BN, int NW, int R>
cudaError_t ensure_smem(size_t smem) {
  static size_t set_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(attention_fwd_kernel<T, BM, BN, NW, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) set_bytes[dev] = smem;
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int bh, nq, nk, d, elt;
  float scale;
  cudaStream_t stream;
};

template <typename T, int BM, int BN, int NW, int R>
int launch(const Args& a) {
  if ((BM / R) * (a.d / 4) > kItems * NW * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.nk, a.d, (int)sizeof(T), BM, BN);
  cudaError_t err = ensure_smem<T, BM, BN, NW, R>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + BM - 1) / BM, a.bh);
  attention_fwd_kernel<T, BM, BN, NW, R><<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.nq, a.nk, a.d, a.scale);
  return (int)cudaGetLastError();
}

// The tilings that are built, each with the rows per thread of the w.v sweep
// (r) that the wrapper's attention_plan can ask of it for some D <= 256, and
// no other: fp32 with (bm, warps) in (64,8) (32,8) (16,8) (8,4) on 64-key
// tiles and (16,4) (8,4) on 32-key tiles; bf16, whose path shapes go to the
// tensor-core kernel, in the smallest tile alone.
#define PDAE_TILING(T, BM, BN, NW, R)                                         \
  if ((int)sizeof(T) == a.elt && bm == BM && bn == BN && warps == NW && r == R) \
    return launch<T, BM, BN, NW, R>(a)

int launch_tiles(const Args& a, int bm, int bn, int warps, int r) {
  PDAE_TILING(float, 64, 64, 8, 1);
  PDAE_TILING(float, 64, 64, 8, 2);
  PDAE_TILING(float, 64, 64, 8, 4);
  PDAE_TILING(float, 32, 64, 8, 1);
  PDAE_TILING(float, 32, 64, 8, 2);
  PDAE_TILING(float, 32, 64, 8, 4);
  PDAE_TILING(float, 16, 64, 8, 1);
  PDAE_TILING(float, 16, 64, 8, 2);
  PDAE_TILING(float, 8, 64, 4, 1);
  PDAE_TILING(float, 8, 64, 4, 2);
  PDAE_TILING(float, 16, 32, 4, 4);
  PDAE_TILING(float, 8, 32, 4, 2);
  PDAE_TILING(float, 8, 32, 4, 4);
  PDAE_TILING(__nv_bfloat16, 8, 64, 4, 1);
  PDAE_TILING(__nv_bfloat16, 8, 64, 4, 2);
  PDAE_TILING(__nv_bfloat16, 8, 64, 4, 4);
  return (int)cudaErrorInvalidValue;
}

#undef PDAE_TILING

template <int MT, int DH>
int launch_mma(const Args& a) {
  static size_t set_bytes[kMaxDevices] = {};
  const size_t smem = mma_smem_bytes(a.nk, DH, 16 * MT);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > set_bytes[dev]) {
    err = cudaFuncSetAttribute(attention_fwd_bf16_mma_kernel<MT, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) set_bytes[dev] = smem;
  }
  dim3 grid((a.nq + 16 * MT - 1) / (16 * MT), a.bh);
  attention_fwd_bf16_mma_kernel<MT, DH><<<grid, 128, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out), a.nq,
      a.nk, a.scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_mma_rows(const Args& a, int bm) {
  if (bm == 16) return launch_mma<1, DH>(a);
  if (bm == 32) return launch_mma<2, DH>(a);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core tilings that are built: bm in {16, 32}, d in {32, 64, 128}.
// (64 rows were slower at every path shape: with four warps a block, small
// blocks in numbers hide the latency of the fragment loads, tall ones do not.)
int launch_mma_tiles(const Args& a, int bm) {
  if (a.d == 32) return launch_mma_rows<32>(a, bm);
  if (a.d == 64) return launch_mma_rows<64>(a, bm);
  if (a.d == 128) return launch_mma_rows<128>(a, bm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block needs for t keys of [*, t, d] of elt-byte elements
// with bm query rows and bn-key tiles; the wrapper's attention_plan computes the same
// number and checks it against the card's per-block limit before it launches.
size_t pdae_attention_smem_bytes(int t, int d, int elt, int bm, int bn) {
  return smem_bytes(t, d, elt, bm, bn);
}

// The same for the bf16 tensor-core kernel (t keys, 64-key tiles).
size_t pdae_attention_mma_smem_bytes(int t, int d, int bm) {
  return mma_smem_bytes(t, d, bm);
}

// q, out: [bh, nq, d]; k, v: [bh, nk, d] (nq < nk: a rank's query rows
// against every key, the spatial split of models/blocks.py; nq == nk is the
// kernel of one process, computed by the same instructions).
// dtype: 0 = float32, 1 = bfloat16. (bm, warps): query rows and warps per
// block, bn: keys per tile, r: rows per thread in the w.v sweep, with
// (bm / r) * (d / 4) at most twice the block's threads (the combinations
// that are built are listed at launch_tiles; any other returns
// cudaErrorInvalidValue). d * elt must be a
// multiple of 16 and d at most 256. mma = 1 takes the bf16 tensor-core
// kernel instead (dtype 1, d in {32, 64, 128}, bm in {16, 32}; bn,
// warps and r are then not read). Returns cudaGetLastError() after the
// launch.
int pdae_attention_fwd(const void* q, const void* k, const void* v, void* out,
                       int bh, int nq, int nk, int d, float scale, int dtype, int bm,
                       int bn, int warps, int r, int mma, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.bh = bh; a.nq = nq; a.nk = nk; a.d = d; a.elt = dtype == 0 ? 4 : 2;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nk < 1 || d < 4 || d > 256 || (d * a.elt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma) return dtype == 1 ? launch_mma_tiles(a, bm) : (int)cudaErrorInvalidValue;
  return launch_tiles(a, bm, bn, warps, r);
}

}  // extern "C"
