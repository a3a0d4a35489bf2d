// Spatial self-attention forward for Hopper (sm_90a), fp32 or bf16 in and out.
//
// Replaces the TPU kernel pdae_tpu/ops/attention.py::_attn_kernel, with its
// math in the same order: q and k are cast to fp32 and each scaled by
// D^-1/4, the logits q.k^T are summed in fp32, the softmax is fp32
// (max-subtract, exp, divide by the sum), the weights are cast to v's dtype,
// and w.v is summed in fp32 and cast to the output dtype.
//
// Layout: q, k, v, out are contiguous [B*H, T, D]; the wrapper
// (pdae_torch/ops/attention.py) permutes the head split into that layout.
//
// Design: the TPU kernel kept one whole [T, T] logits tile per (batch,
// head) in VMEM. That does not fit a Hopper block's shared memory (T=256 in
// fp32 is 256 KB), so this kernel tiles over query rows. Each block owns
// one (batch*head, 32-row query tile), stages that head's K (pre-scaled, rows
// padded to D+1 floats so the 32 lanes of a warp hit 32 banks) and V in
// shared memory as fp32, and gives each warp one query row at a time: the
// warp holds one row of T fp32 scores in shared memory, reduces max and sum
// with shuffles, and sums w.v with lanes across D.
//
// Bound: at the shapes of the celeba64 path ([8,4,64,128] in the UNet middle
// blocks, [8,4,256,32] in the encoder) the bytes are 4*B*H*T*D*elt (q, k, v
// read once, out written once) and the products 4*B*H*T*T*D flops on the
// fp32 CUDA cores. The query-tile grid re-reads K and V once per tile from
// L2, which the bound does not count. No tensor cores (wgmma) yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     int t, int d, float scale) {
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* ks = smem;                       // [t][d+1], pre-scaled
  float* vs = ks + t * kstride;           // [t][d]
  float* rows = vs + t * d;               // [kWarps][t] scores, then weights
  float* qs = rows + kWarps * t;          // [kWarps][d] pre-scaled query row

  const size_t base = (size_t)blockIdx.y * t * d;
  for (int i = threadIdx.x; i < t * d; i += blockDim.x) {
    const int j = i / d;
    const int c = i - j * d;
    ks[j * kstride + c] = to_f(k[base + i]) * scale;
    vs[i] = to_f(v[base + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + warp * t;
  float* qrow = qs + warp * d;
  const int row_end = min((int)(blockIdx.x + 1) * kRowsPerBlock, t);
  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const T* qr = q + base + (size_t)r * d;
    for (int c = lane; c < d; c += 32) qrow[c] = to_f(qr[c]) * scale;
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      const float* kr = ks + j * kstride;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qrow[c], kr[c], s);
      row[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < t; j += 32) row[j] = to_f(from_f<T>(row[j] / sum));
    __syncwarp();

    T* orow = out + base + (size_t)r * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc = fmaf(row[j], vs[j * d + c], acc);
      orow[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory cap on the current device only
// when a launch needs more than was set before, so the host pays for
// cudaFuncSetAttribute once per (dtype, device, larger size), not per launch.
template <typename T>
cudaError_t ensure_smem(size_t smem) {
  static size_t set_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) set_bytes[dev] = smem;
  return err;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int t, int d, float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = ensure_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  attention_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for [*, t, d]; the wrapper checks it against
// the card's per-block limit before it launches.
size_t pdae_attention_smem_bytes(int t, int d) {
  return sizeof(float) * ((size_t)t * (d + 1) + (size_t)t * d + (size_t)kWarps * (t + d));
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int pdae_attention_fwd(const void* q, const void* k, const void* v, void* out,
                       int bh, int t, int d, float scale, int dtype, void* stream) {
  const size_t smem = pdae_attention_smem_bytes(t, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, bh, t, d, scale, smem, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, bh, t, d, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
