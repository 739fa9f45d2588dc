// Fused per-user classifier gather + head matmul of the serve path:
//
//     out[r, c] = sum_t H[r, t] * W[uid[r], t, c] + b[uid[r], c]
//
// H: (B, d) trunk features, W: (m, d, n) stacked personal classifiers,
// b: (m, n) stacked biases, uid: (B,) int32; f32 accumulate, f32 output.
// Replaces the Pallas TPU kernel repro/kernels/head_gather.py
// (head_gather_matmul_pallas / _head_kernel).
//
// Bound on an H100: at the serve path's shape (m = 100, d = 64, n = 10)
// the work is 2*B*d*n FLOP and the gathered weights are at most
// B*d*n*4 B (each distinct user's (d, n) slab read once: <= 256 KB), so
// even B = 1024 moves well under a megabyte and the kernel is bound by
// its launch (a few microseconds), not by bytes or operations, at every
// batch the serve path uses.
//
// Design (simple and right first):
// - one block per request r, times a tile of blockDim.x classes when n
//   exceeds the tile; no (B, d, n) gathered copy of W is materialized;
// - the block stages H[r] in shared memory as f32;
// - each thread owns one class c and sums H[r, t] * W[uid[r], t, c] over
//   t in f32 (neighbouring threads read neighbouring classes of a row of
//   the slab), then adds b[uid[r], c];
// - H and W may each be f32 or bf16 (b has W's dtype).
// An out-of-range user id yields a NaN row instead of reading outside W.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TH, typename TW>
__global__ void head_gather_kernel(const int32_t* __restrict__ uid,
                                   const TH* __restrict__ H,
                                   const TW* __restrict__ W,
                                   const TW* __restrict__ b,
                                   float* __restrict__ out, int m, int d,
                                   int n) {
  extern __shared__ float s_h[];
  const int64_t r = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    s_h[t] = to_f32(H[r * d + t]);
  }
  __syncthreads();

  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int32_t u = uid[r];
  if (static_cast<uint32_t>(u) >= static_cast<uint32_t>(m)) {
    out[r * n + c] = __int_as_float(0x7fc00000);
    return;
  }
  const TW* Wu = W + static_cast<int64_t>(u) * d * n;
  float acc = 0.0f;
  for (int t = 0; t < d; ++t) {
    acc = fmaf(s_h[t], to_f32(Wu[static_cast<int64_t>(t) * n + c]), acc);
  }
  out[r * n + c] = acc + to_f32(b[static_cast<int64_t>(u) * n + c]);
}

template <typename TH, typename TW>
int launch(const void* uid, const void* H, const void* W, const void* b,
           void* out, int B, int m, int d, int n, int threads,
           void* stream) {
  if (B == 0 || n == 0) return 0;
  dim3 grid(static_cast<unsigned>(B),
            static_cast<unsigned>((n + threads - 1) / threads));
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  head_gather_kernel<TH, TW><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uid), static_cast<const TH*>(H),
      static_cast<const TW*>(W), static_cast<const TW*>(b),
      static_cast<float*>(out), m, d, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define HEAD_GATHER_ENTRY(NAME, TH, TW)                                      \
  int NAME(const void* uid, const void* H, const void* W, const void* b,     \
           void* out, int B, int m, int d, int n, int threads,               \
           void* stream) {                                                   \
    return launch<TH, TW>(uid, H, W, b, out, B, m, d, n, threads, stream);   \
  }

extern "C" {

HEAD_GATHER_ENTRY(head_gather_f32_f32, float, float)
HEAD_GATHER_ENTRY(head_gather_bf16_f32, __nv_bfloat16, float)
HEAD_GATHER_ENTRY(head_gather_f32_bf16, float, __nv_bfloat16)
HEAD_GATHER_ENTRY(head_gather_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
