// Compact-working-set scatter into the resident buffer, in place:
//
//     U[rows[p], c] = X[p, c]                                   (set)
//     U[rows[p], c] = U[rows[p], c] + X[p, c]    (accumulate, f32 sum)
//
// X: (n, d), U: (m, d); X is rounded to U's type first, as the reference
// casts it before its kernel (so accumulate adds the rounded X).
//
// Replaces the Pallas TPU kernel repro/kernels/gossip_scatter.py
// (gossip_scatter_pallas / _scatter_kernel), which aliases U to its output
// so the dormant rows are never copied.  Here the launch writes into U's
// own storage: no copy of U, no padding, no dormant row touched.
//
// Bound on an H100: memory, and at the main path's shape the launch.  At
// (m = 100, n = 25, d = 13,328, f32) the work is X read once and 25 rows
// written, 2.67 MB, 0.80 us at 3.35 TB/s; at m = 4096, n = 1024 it is
// 109 MB, 32.6 us.  There are no operations to speak of.
//
// Design (no DMA double-issue to carry over: a GPU block simply issues
// its loads and stores):
// - one block per (compact row p, d-chunk); every thread reads rows[p];
// - threads stride over the chunk's columns, neighbouring threads on
//   neighbouring addresses; where d is a multiple of 4 and both base
//   pointers are 16-byte aligned each thread moves 4 columns as one
//   vector (16 bytes of f32, 8 of bf16), else 4 strided scalars;
// - an out-of-range destination row writes nothing.
// Rows must be unique: duplicate rows race, as on the TPU.
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

// The value written at one column: X rounded to U's type (exact for equal
// types and bf16 -> f32), plus U's old value in f32 when accumulating.
template <typename TU, typename TX>
__device__ __forceinline__ TU scatter_value(TU u_old, TX x, bool accumulate) {
  const TU xu = from_f32<TU>(to_f32(x));
  return accumulate ? from_f32<TU>(__fadd_rn(to_f32(u_old), to_f32(xu))) : xu;
}

// four consecutive values through one 16- (f32) or 8-byte (bf16) access
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      __nv_bfloat16 v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
  v[0] = h[0]; v[1] = h[1]; v[2] = h[2]; v[3] = h[3];
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const __nv_bfloat16 v[4]) {
  uint2 t;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
  h[0] = v[0]; h[1] = v[1]; h[2] = v[2]; h[3] = v[3];
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename TU, typename TX>
__global__ void gossip_scatter_kernel(const int32_t* __restrict__ rows,
                                      const TX* __restrict__ X,
                                      TU* __restrict__ U, int m, int64_t d,
                                      bool accumulate, bool vec) {
  const int64_t p = blockIdx.x;
  const int32_t r = rows[p];
  if (static_cast<uint32_t>(r) >= static_cast<uint32_t>(m)) return;
  const TX* src = X + p * d;
  TU* dst = U + static_cast<int64_t>(r) * d;
  const int64_t chunk = static_cast<int64_t>(blockDim.x) * kCols;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * chunk;
  if (vec) {
    // d % 4 == 0: the chunk's last vector either fits whole or is absent
    const int64_t c = base + static_cast<int64_t>(threadIdx.x) * kCols;
    if (c < d) {
      TX xv[kCols];
      TU uv[kCols] = {};
      load4(src + c, xv);
      if (accumulate) load4(dst + c, uv);
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        uv[t] = scatter_value<TU, TX>(uv[t], xv[t], accumulate);
      }
      store4(dst + c, uv);
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int64_t c = base + threadIdx.x + static_cast<int64_t>(t) * blockDim.x;
    if (c < d) {
      dst[c] = scatter_value<TU, TX>(accumulate ? dst[c] : TU(), src[c],
                                     accumulate);
    }
  }
}

template <typename TU, typename TX>
int launch(const void* rows, const void* X, void* U, int n, int m,
           long long d, int accumulate, int vec, int threads, void* stream) {
  if (n == 0 || d == 0) return 0;
  const int64_t per_block = static_cast<int64_t>(threads) * kCols;
  dim3 grid(static_cast<unsigned>(n),
            static_cast<unsigned>((d + per_block - 1) / per_block));
  gossip_scatter_kernel<TU, TX><<<grid, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const TX*>(X),
      static_cast<TU*>(U), m, static_cast<int64_t>(d), accumulate != 0,
      vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define REPRO_SCATTER_ENTRY(NAME, TU, TX)                                  \
  int NAME(const void* rows, const void* X, void* U, int n, int m,         \
           long long d, int accumulate, int vec, int threads,              \
           void* stream) {                                                 \
    return launch<TU, TX>(rows, X, U, n, m, d, accumulate, vec, threads,   \
                          stream);                                         \
  }

// named gossip_scatter_x<X's type>_u<U's type>
REPRO_SCATTER_ENTRY(gossip_scatter_xf32_uf32, float, float)
REPRO_SCATTER_ENTRY(gossip_scatter_xbf16_uf32, float, __nv_bfloat16)
REPRO_SCATTER_ENTRY(gossip_scatter_xf32_ubf16, __nv_bfloat16, float)
REPRO_SCATTER_ENTRY(gossip_scatter_xbf16_ubf16, __nv_bfloat16, __nv_bfloat16)

int gossip_scatter_cols_per_thread() { return kCols; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
