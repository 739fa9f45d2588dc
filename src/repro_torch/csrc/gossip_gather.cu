// Neighbor-indexed gossip gather-mix over the flat client buffer:
//
//     out[i, c] = sum_{j < k} w[i, j] * U[idx[i, j], c]       U: (m, d)
//
// Replaces the Pallas TPU kernel repro/kernels/gossip_gather.py
// (gossip_gather_pallas / _gather_kernel).
//
// Bound on an H100: memory.  At the port's main-path shape (m = 100,
// k = 11, d = 13,328, f32) the unique bytes are U read once plus the
// output written once, 2 * 100 * 13,328 * 4 B = 10.7 MB; the work is
// 2*m*k*d = 29 MFLOP, far below the f32 rate.  The gather itself touches
// m*k*d*4 B = 58.6 MB, but U (5.3 MB) sits in the 50 MB L2, so repeated
// neighbor rows are served from L2 rather than device memory.
//
// Design (simple and right first; no TMA / wgmma):
// - one block per (output row i, d-chunk); the block stages its own
//   idx[i, :] and w[i, :] in shared memory (no scalar prefetch on a GPU);
// - threads stride over the chunk's columns, neighbouring threads on
//   neighbouring addresses, kCols independent columns per thread so
//   several loads are in flight;
// - each thread sums j = 0..k-1 IN ORDER in f32 with __fmul_rn then
//   __fadd_rn (no contracted FMA): for f32 U the result equals the plain
//   torch `mix_rows` (separate multiply and add ops) bit for bit;
// - U may be f32 or bf16; the output is written in U's dtype.
// An out-of-range neighbor id contributes NaN (jnp.take's fill) instead of
// reading outside U.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;   // columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T>
__global__ void gossip_gather_kernel(const int32_t* __restrict__ idx,
                                     const float* __restrict__ w,
                                     const T* __restrict__ U,
                                     T* __restrict__ out, int m, int k,
                                     int64_t d) {
  extern __shared__ unsigned char smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_w = reinterpret_cast<float*>(s_idx + k);
  const int64_t i = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_idx[j] = idx[i * k + j];
    s_w[j] = w[i * k + j];
  }
  __syncthreads();

  const int64_t c0 =
      static_cast<int64_t>(blockIdx.y) * blockDim.x * kCols + threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = 0.0f;

  for (int j = 0; j < k; ++j) {
    const int32_t nb = s_idx[j];
    const float wj = s_w[j];
    const bool ok = static_cast<uint32_t>(nb) < static_cast<uint32_t>(m);
    const T* row = U + static_cast<int64_t>(ok ? nb : 0) * d;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int64_t c = c0 + static_cast<int64_t>(t) * blockDim.x;
      if (c < d) {
        const float term =
            ok ? __fmul_rn(wj, to_f32(row[c])) : __int_as_float(0x7fc00000);
        acc[t] = (j == 0) ? term : __fadd_rn(acc[t], term);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int64_t c = c0 + static_cast<int64_t>(t) * blockDim.x;
    if (c < d) out[i * d + c] = from_f32<T>(acc[t]);
  }
}

template <typename T>
int launch(const void* idx, const void* w, const void* U, void* out, int m,
           int k, long long d, int threads, void* stream) {
  if (m == 0 || d == 0) return 0;
  const int64_t per_block = static_cast<int64_t>(threads) * kCols;
  dim3 grid(static_cast<unsigned>(m),
            static_cast<unsigned>((d + per_block - 1) / per_block));
  const size_t smem = static_cast<size_t>(k) * (sizeof(int32_t) + sizeof(float));
  gossip_gather_kernel<T><<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<const T*>(U), static_cast<T*>(out), m, k,
      static_cast<int64_t>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gossip_gather_f32(const void* idx, const void* w, const void* U,
                      void* out, int m, int k, long long d, int threads,
                      void* stream) {
  return launch<float>(idx, w, U, out, m, k, d, threads, stream);
}

int gossip_gather_bf16(const void* idx, const void* w, const void* U,
                       void* out, int m, int k, long long d, int threads,
                       void* stream) {
  return launch<__nv_bfloat16>(idx, w, U, out, m, k, d, threads, stream);
}

int gossip_gather_cols_per_thread() { return kCols; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
