// Dense push-sum gossip contraction over the stacked client axis:
//
//     out = P @ U          P: (m, m) f32,  U: (m, d) f32 or bf16
//
// f32 products and sums in IEEE f32 (fmaf), no TF32 and no tensor cores,
// so the result stays within f32 rounding of `P.float() @ U.float()`; the
// output is written in U's type.
//
// Replaces the Pallas TPU kernel repro/kernels/pushsum_mix.py
// (pushsum_mix_pallas / _mix_kernel), which keeps P resident in VMEM and
// streams (m, 512) column panels of U through the MXU.
//
// Bound on an H100: at the main path's shape (m = 100, d = 13,328) the
// work is 2*m*m*d = 266.6 MFLOP, 3.98 us at 67 TFLOP/s of f32 outside the
// tensor cores, against 10.7 MB of U in and out, 3.19 us at 3.35 TB/s: so
// operations, narrowly.
//
// Design: a tiled SIMT GEMM.
// - one block per (BM = 64 rows of P) x (BN = 128 columns of U) tile of
//   the output; the m-long contraction runs in BK = 16 steps, each staging
//   a BM x BK tile of P (transposed) and a BK x BN panel of U, converted to
//   f32, in shared memory;
// - 256 threads; each owns TM = 8 rows x TN = 4 columns of the output in
//   registers.  A warp shares its 8 rows (a broadcast read of P) and its 4
//   columns are 32 apart, so the U panel is read without bank conflicts
//   and the output is stored coalesced;
// - bounds checks take the place of the reference's zero-padding copies:
//   out-of-range rows of P and U stage as 0, out-of-range outputs are not
//   written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 16, TM = 8, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256
constexpr int kColGroups = BN / TN;                // 32: one warp per row group

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
__global__ void __launch_bounds__(kThreads)
pushsum_mix_kernel(const float* __restrict__ P, const T* __restrict__ U,
                   T* __restrict__ out, int m, int64_t d) {
  __shared__ float Ps[BK][BM + 1];   // Ps[k][i] = P[row0 + i, k0 + k]
  __shared__ float Us[BK][BN];       // Us[k][c] = U[k0 + k, col0 + c]
  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int row0 = blockIdx.y * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, k = e % BK;
      const int gi = row0 + i, gk = k0 + k;
      Ps[k][i] = (gi < m && gk < m)
                     ? P[static_cast<int64_t>(gi) * m + gk] : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k;
      const int64_t gc = col0 + c;
      Us[k][c] = (gk < m && gc < d)
                     ? to_f32(U[static_cast<int64_t>(gk) * d + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ps[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Us[k][tx + j * kColGroups];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty * TM + i;
    if (gi >= m) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx + j * kColGroups;
      if (gc < d) out[static_cast<int64_t>(gi) * d + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* P, const void* U, void* out, int m, long long d,
           void* stream) {
  if (m == 0 || d == 0) return 0;
  dim3 grid(static_cast<unsigned>((d + BN - 1) / BN),
            static_cast<unsigned>((m + BM - 1) / BM));
  pushsum_mix_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const T*>(U),
      static_cast<T*>(out), m, static_cast<int64_t>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pushsum_mix_f32(const void* P, const void* U, void* out, int m,
                    long long d, void* stream) {
  return launch<float>(P, U, out, m, d, stream);
}

int pushsum_mix_bf16(const void* P, const void* U, void* out, int m,
                     long long d, void* stream) {
  return launch<__nv_bfloat16>(P, U, out, m, d, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
