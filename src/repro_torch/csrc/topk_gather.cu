// Compressed gossip mix of sparse (column, value) payloads, without a dense
// decode:
//
//     out[i, c] = sum_{j < k} w[i, j] * sum_{p < K} vals[idx[i, j], p]
//                                              * [cols[idx[i, j], p] == c]
//
// Replaces the Pallas TPU kernel repro/kernels/topk_gather.py
// (topk_gather_pallas / _scatter_kernel).
//
// Bound on an H100: memory.  At the codec path's shape (m = 100, k = 11,
// K = 833, d = 13,328, f32 values, uint16 columns) the bytes are the output
// written once (5,331,200 B), the payload read once (499,800 B) and the
// neighbor table (8,800 B): 5.84 MB, 1.74 us at 3.35 TB/s.  The work,
// 2*m*k*K = 2 MFLOP, is negligible.
//
// The TPU body does K masked FMAs over a whole d-panel for every payload
// slot (O(K*d) per row and neighbor), which suits a vector unit with no
// scatter.  A GPU scatters into shared memory instead (O(K) per row and
// neighbor):
// - one block per (output row i, chunk of block_d columns), with the chunk's
//   f32 accumulator in shared memory and the row's neighbor ids and
//   weights staged beside it; the wrapper picks the chunk (at m = 100,
//   4 chunks of 3,332 columns: 13 KB);
// - for j = 0..k-1 in order, the threads stride coalesced over neighbor
//   idx[i, j]'s K (column, value) pairs, kBatch pairs per thread loaded
//   before any is used, and the first batch of neighbor j + 1 loaded
//   before neighbor j's adds: the loads of a neighbor are one L2 round
//   trip, overlapped with the previous neighbor's work, not a chain of
//   dependent ones; a pair whose column lies in the chunk (and so in
//   [0, d)) adds __fmul_rn(w[i, j], value) to its slot with a
//   shared-memory atomicAdd; a __syncthreads() separates neighbors;
// - the chunk is then written out in the values' dtype, zeros included.
// A codec's columns are distinct within one payload row, so each slot sees
// at most one add per neighbor and the adds land in j order: for f32
// values the result equals the plain version (dense decode, then the
// j-ordered gather with rounded products) bit for bit.  Duplicate columns
// within one row, which the contract allows, add in the atomics' order.
// Columns are read as they lie on the wire (uint16 or int32), nothing is
// padded or copied.  An out-of-range neighbor id makes its row NaN (the
// gather's fill) instead of reading outside the payload.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int kBatch = 4;   // payload pairs each thread loads at once

// Loads one batch of a neighbor's payload: pair p0 + r * blockDim.x for
// r < kBatch, as (offset in the chunk, value).  A pair outside the chunk,
// past K, or of an invalid neighbor gets offset -1, which the unsigned
// compare of `add_batch` rejects; so does a column before the chunk or a
// negative int32 id.
template <typename T, typename C>
__device__ __forceinline__ void load_batch(const T* v, const C* cl, bool ok,
                                           int64_t p0, int64_t K, int64_t c0,
                                           int64_t (&off)[kBatch],
                                           float (&val)[kBatch]) {
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int64_t p = p0 + static_cast<int64_t>(r) * blockDim.x;
    off[r] = -1;
    val[r] = 0.0f;
    if (ok && p < K) {
      off[r] = static_cast<int64_t>(cl[p]) - c0;
      val[r] = to_f32(v[p]);
    }
  }
}

__device__ __forceinline__ void add_batch(float* acc, int64_t width, float wj,
                                          const int64_t (&off)[kBatch],
                                          const float (&val)[kBatch]) {
#pragma unroll
  for (int r = 0; r < kBatch; ++r)
    if (static_cast<uint64_t>(off[r]) < static_cast<uint64_t>(width))
      atomicAdd(&acc[off[r]], __fmul_rn(wj, val[r]));
}

template <typename T, typename C>
__global__ void topk_gather_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ w,
                                   const T* __restrict__ vals,
                                   const C* __restrict__ cols,
                                   T* __restrict__ out, int m, int k,
                                   int64_t K, int64_t d, int block_d) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // block_d floats
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + block_d);
  float* s_w = reinterpret_cast<float*>(s_idx + k);
  const int64_t i = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * block_d;
  const int64_t width = (d - c0 < block_d) ? d - c0 : block_d;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_idx[j] = idx[i * k + j];
    s_w[j] = w[i * k + j];
  }
  for (int64_t c = threadIdx.x; c < width; c += blockDim.x) acc[c] = 0.0f;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(kBatch) * blockDim.x;
  auto valid = [&](int j) {
    return j < k &&
           static_cast<uint32_t>(s_idx[j]) < static_cast<uint32_t>(m);
  };
  // k = 0 leaves the chunk zero: valid(0) is false and nothing is read
  auto row_of = [&](int j) {
    return static_cast<int64_t>(valid(j) ? s_idx[j] : 0) * K;
  };
  // the first batch of each neighbor is loaded one neighbor ahead, so its
  // L2 latency overlaps the previous neighbor's adds and barrier
  int64_t off[kBatch], off_next[kBatch];
  float val[kBatch], val_next[kBatch];
  load_batch(vals + row_of(0), cols + row_of(0), valid(0), threadIdx.x, K,
             c0, off, val);
  for (int j = 0; j < k; ++j) {
    const bool ok = valid(j);
    const int64_t row = row_of(j);
    if (j + 1 < k)
      load_batch(vals + row_of(j + 1), cols + row_of(j + 1), valid(j + 1),
                 threadIdx.x, K, c0, off_next, val_next);
    if (!ok) {
      // an out-of-range neighbor id: the gather's NaN fill
      for (int64_t c = threadIdx.x; c < width; c += blockDim.x)
        acc[c] = __int_as_float(0x7fc00000);
    } else {
      add_batch(acc, width, s_w[j], off, val);
      for (int64_t p0 = threadIdx.x + stride; p0 < K; p0 += stride) {
        load_batch(vals + row, cols + row, true, p0, K, c0, off, val);
        add_batch(acc, width, s_w[j], off, val);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      off[r] = off_next[r];
      val[r] = val_next[r];
    }
  }
  T* dst = out + i * d + c0;
  for (int64_t c = threadIdx.x; c < width; c += blockDim.x)
    dst[c] = from_f32<T>(acc[c]);
}

template <typename T, typename C>
int launch(const void* idx, const void* w, const void* vals,
           const void* cols, void* out, int m, int k, long long K,
           long long d, int block_d, int threads, void* stream) {
  if (m == 0 || d == 0) return 0;
  dim3 grid(static_cast<unsigned>(m),
            static_cast<unsigned>((d + block_d - 1) / block_d));
  const size_t smem = static_cast<size_t>(block_d) * sizeof(float) +
                      static_cast<size_t>(k) * (sizeof(int32_t) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        topk_gather_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  topk_gather_kernel<T, C><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<const T*>(vals), static_cast<const C*>(cols),
      static_cast<T*>(out), m, k, static_cast<int64_t>(K),
      static_cast<int64_t>(d), block_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define REPRO_TOPK_ENTRY(NAME, T, C)                                        \
  int NAME(const void* idx, const void* w, const void* vals,                \
           const void* cols, void* out, int m, int k, long long K,          \
           long long d, int block_d, int threads, void* stream) {           \
    return launch<T, C>(idx, w, vals, cols, out, m, k, K, d, block_d,       \
                        threads, stream);                                   \
  }

REPRO_TOPK_ENTRY(topk_gather_f32_u16, float, uint16_t)
REPRO_TOPK_ENTRY(topk_gather_f32_i32, float, int32_t)
REPRO_TOPK_ENTRY(topk_gather_bf16_u16, __nv_bfloat16, uint16_t)
REPRO_TOPK_ENTRY(topk_gather_bf16_i32, __nv_bfloat16, int32_t)

#undef REPRO_TOPK_ENTRY

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
