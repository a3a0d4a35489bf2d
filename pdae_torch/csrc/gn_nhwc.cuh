// What the NHWC variants of the GN kernels share: groupnorm.cu's forward
// (gn_adagn_silu_nhwc_kernel) and groupnorm_bwd.cu's backward
// (gn_adagn_silu_bwd_nhwc_kernel). Each file includes it inside its anonymous
// namespace at the head of its NHWC section, after its to_f, from_f and
// Vec<T>, so that each library stays one nvcc call on one source.

constexpr int kNhwcThreads = 256;      // the NHWC variants' largest block
constexpr int kNhwcMinBlocks = 3;      // ... and their register budget: 3 such blocks an SM
constexpr int kNhwcMaxSmem = 232448 - 1024;   // what a block may use on sm_90, less the reserve
constexpr int kNhwcMaxDevices = 64;

// V elements of T (V = 1, or the 16-byte vector) from shared or global
// memory as fp32, and back.
template <typename T, int V>
__device__ __forceinline__ void load_frag(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f(*p);
  } else {
    Vec<T>::load(p, v);
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_frag(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else {
    Vec<T>::store(p, v);
  }
}

// The block's totals of each of the W = R * V channels of a tile, added in
// thread order. Thread t owns column t % R (V channels) and holds its partial
// sums of two quantities in sa, sb. Where R divides the warp, the lanes of
// one column are added first by a butterfly, and each warp's first R lanes
// hand on the warp's sums. scratch holds scratch_slots(R, blockDim.x) * V * 2
// floats; every thread sees chan_a, chan_b [W] on return.
__host__ __device__ __forceinline__ bool lanes_share_columns(int r, int nthr) {
  return r < 32 && 32 % r == 0 && nthr % 32 == 0;
}
// The slots of column_totals's scratch: one a thread, or R a warp.
__host__ __device__ __forceinline__ int scratch_slots(int r, int nthr) {
  return lanes_share_columns(r, nthr) ? nthr / 32 * r : nthr;
}

template <int V>
__device__ __forceinline__ void column_totals(float* sa, float* sb, int r, float* scratch,
                                              float* chan_a, float* chan_b) {
  const int t = threadIdx.x, nthr = blockDim.x;
  const bool shfl = lanes_share_columns(r, nthr);
  if (shfl) {
    for (int o = 16; o >= r; o >>= 1) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        sa[u] += __shfl_xor_sync(0xffffffffu, sa[u], o);
        sb[u] += __shfl_xor_sync(0xffffffffu, sb[u], o);
      }
    }
  }
  // slot of this thread (its warp's, where the lanes were added); column j's
  // slots are j, j + r, j + 2r, ...
  const int slot = shfl ? (t >> 5) * r + (t & 31) : t;
  const int slots = scratch_slots(r, nthr);
  if (!shfl || (t & 31) < r) {                  // [u][2][slot]: no bank conflicts
#pragma unroll
    for (int u = 0; u < V; ++u) {
      scratch[(2 * u) * slots + slot] = sa[u];
      scratch[(2 * u + 1) * slots + slot] = sb[u];
    }
  }
  __syncthreads();
  for (int w = t; w < r * V; w += nthr) {
    const int j = w / V, u = w - j * V;
    float a = 0.f, b = 0.f;
    for (int s = j; s < slots; s += r) {
      a += scratch[(2 * u) * slots + s];
      b += scratch[(2 * u + 1) * slots + s];
    }
    chan_a[w] = a;
    chan_b[w] = b;
  }
  __syncthreads();
}

// Floats rounded up to a whole 16-byte vector, so that what follows them in
// shared memory is aligned for float4.
__host__ __device__ __forceinline__ size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

// A float4 (float2) of a table in shared memory, read where it is used: the
// volatile load is not hoisted out of the pixel loop into registers.
__device__ __forceinline__ float4 table_entry(const float* p) {
  float4 v;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 table_entry2(const float* p) {
  float2 v;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// An NHWC variant's launch (ops/groupnorm.py::nhwc_plan): k groups a tile,
// `cluster` blocks of `threads` threads a tile, each with npx pixels, vec
// elements a thread's column (16 bytes, or 1), keep: the block's part held
// in shared memory.
struct NhwcPlan {
  int k, cluster, threads, npx, vec, keep;
};

// Whether p tiles a [hw, c] map of `groups` groups whose 16-byte vector holds
// `vec_full` elements: whole groups a tile, a cluster of 1, 2, 4 or 8 blocks
// covering the pixels, whole columns a block, and no kept part under 1-element
// columns (cp.async copies 16 bytes).
bool nhwc_plan_ok(const NhwcPlan& p, int c, int hw, int groups, int vec_full) {
  if (p.k < 1 || groups % p.k != 0) return false;
  const int w_ch = p.k * (c / groups);
  const bool cluster_ok = p.cluster == 1 || p.cluster == 2 || p.cluster == 4 || p.cluster == 8;
  if (!cluster_ok || (p.vec != 1 && p.vec != vec_full) || w_ch % p.vec != 0) return false;
  const int r = w_ch / p.vec;
  return p.threads >= r && p.threads <= kNhwcThreads && p.threads % r == 0 && p.npx >= 1
         && (long long)p.npx * p.cluster >= hw && !(p.vec == 1 && p.keep);
}

// Launch Kernel over `tiles` clusters of p.cluster blocks of p.threads threads
// with `smem` bytes of dynamic shared memory each, raising its limit to
// kNhwcMaxSmem once a device.
template <auto Kernel, typename... A>
int launch_clusters(const NhwcPlan& p, int tiles, size_t smem, cudaStream_t stream,
                    A... args) {
  if (smem > (size_t)kNhwcMaxSmem) return (int)cudaErrorInvalidValue;
  static bool done[kNhwcMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kNhwcMaxDevices || !done[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kNhwcMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kNhwcMaxDevices) done[dev] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(tiles * p.cluster));
  config.blockDim = dim3((unsigned)p.threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, Kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
