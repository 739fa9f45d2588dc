// RG-LRU linear recurrence of the hybrid (Griffin / RecurrentGemma) model:
//
//     h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = 0
//
// a, b, out: (B, S, W) f32, contiguous.  Replaces the Pallas TPU kernel
// repro/kernels/rglru.py (rglru_pallas / _rglru_kernel), which walks
// (256-step, 128-lane) panels with the carry in VMEM and asserts
// S % 256 == 0 and W % 128 == 0; this kernel takes any S and W.
//
// Bound on an H100: two reads and one write of 4 bytes per element and
// two flops, so bytes: at the model's shape (2, 4096, 4096) 403 MB, or
// 0.12 ms at 3.35 TB/s.
//
// Design (simple and right first):
// - one thread per (b, w) chain; consecutive threads take consecutive w,
//   so every time step's loads and store coalesce;
// - the loads of the next `STEPS` time steps are issued before the
//   dependent chain of the current ones, to keep memory requests in
//   flight while the chain walks;
// - each step is __fmul_rn then __fadd_rn (no FMA contraction), the
//   arithmetic of the plain version `a_t * h + b_t`: the two agree bit
//   for bit.
// At (2, 4096, 4096) there are only 8,192 chains, 64 blocks of 128
// threads for 132 SMs, so the kernel is far from its bound; a chunked
// two-pass scan would fill the card but changes the rounding order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int STEPS>
__global__ void rglru_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ out, int S, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;

  float an[STEPS], bn[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const bool in = j < S;
    an[j] = in ? __ldg(ap + static_cast<int64_t>(j) * W) : 0.0f;
    bn[j] = in ? __ldg(bp + static_cast<int64_t>(j) * W) : 0.0f;
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += STEPS) {
    float ac[STEPS], bc[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      ac[j] = an[j];
      bc[j] = bn[j];
    }
    // issue the next batch's loads before walking this one
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = t0 + STEPS + j;
      const bool in = t < S;
      an[j] = in ? __ldg(ap + static_cast<int64_t>(t) * W) : 0.0f;
      bn[j] = in ? __ldg(bp + static_cast<int64_t>(t) * W) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = t0 + j;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(ac[j], h), bc[j]);
        op[static_cast<int64_t>(t) * W] = h;
      }
    }
  }
}

template <int STEPS>
int launch(const float* a, const float* b, float* out, int B, int S, int W,
           int threads, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((W + threads - 1) / threads),
            static_cast<unsigned>(B));
  rglru_kernel<STEPS><<<grid, threads, 0, stream>>>(a, b, out, S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// steps: time steps loaded ahead per batch (1, 2, 4, 8, 16 or 32);
// threads: chains per block (a multiple of 32, at most 1024).
int rglru_f32(const void* a, const void* b, void* out, int B, int S, int W,
              int steps, int threads, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (steps) {
    case 1: return launch<1>(pa, pb, po, B, S, W, threads, st);
    case 2: return launch<2>(pa, pb, po, B, S, W, threads, st);
    case 4: return launch<4>(pa, pb, po, B, S, W, threads, st);
    case 8: return launch<8>(pa, pb, po, B, S, W, threads, st);
    case 16: return launch<16>(pa, pb, po, B, S, W, threads, st);
    case 32: return launch<32>(pa, pb, po, B, S, W, threads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
