// Fused per-user classifier gather + head matmul of the serve path:
//
//     out[r, c] = sum_t H[r, t] * W[uid[r], t, c] + b[uid[r], c]
//
// H: (B, d) trunk features, W: (m, d, n) stacked personal classifiers,
// b: (m, n) stacked biases, uid: (B,) int32; f32 accumulate, f32 output.
// Replaces the Pallas TPU kernel repro/kernels/head_gather.py
// (head_gather_matmul_pallas / _head_kernel).
//
// Bound on an H100: at the serve path's shape (m = 100, d = 64, n = 10,
// B = 1024) the call moves about 567 KB (H, the distinct users' slabs and
// biases, uid, the output): 0.17 us at 3.35 TB/s; its 1.3 MFLOP are less.
// Neither sets the pace: the launch and a few dependent trips to L2 do.
// The launch floor, the device time of a one-element elementwise kernel,
// is 1.16 us on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase
// `timings`); the kernel takes 2.1 us at B = 1 and 2.6 us at B = 1024 on
// that card (PERF.md section 6).  Each request pays one trip for uid[r],
// then one for its slab, which the design keeps to one burst.
//
// Two routes, chosen by shape in kernels/head_gather.py `plan` (never on a
// failure):
// - warp (n <= 32, a slab, H row and bias within 6 KB, more than 2
//   requests per SM): one warp per request, several requests per block
//   (about one block per SM at B = 1024).  Each warp copies W[uid[r]] (d*n contiguous elements),
//   H[r] and b[uid[r]] to its own shared memory as 16-byte cp.async
//   chunks of the aligned windows that hold them, every copy in flight
//   before the one wait: a request costs one L2 round trip, not a chain.
//   The lanes split the (t, c) work: lane l takes class c = l % n and the
//   features t = g, g + G, ... with g = l / n, G = 32 / n groups, each an
//   f32 FMA chain; lane c then adds the other groups' sums in group order
//   by warp shuffles, then the bias;
// - tiled (any other shape, d up to 12,288; faster than the warp route at
//   up to 2 requests per SM, whose lanes each run a chain of ~21
//   shared-memory loads and FMAs): one 256-thread block per
//   (request, tile of block_n classes) stages H[r] as f32 in shared memory;
//   threads split the tile's (t, c) work the same way (G = 256 / block_n
//   groups, W read in coalesced rows), then add the groups' sums in order
//   through shared memory.
// H and W may each be f32 or bf16 (b has W's dtype).  An out-of-range user
// id yields a NaN row instead of reading outside W.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of the `bytes` bytes at src into shared memory at dst as
// the 16-byte-aligned window that holds them, one 16-byte chunk per lane
// and step; returns src's offset in the window.  Every chunk holds a byte
// of the source, so the window stays inside the source's allocation.
__device__ __forceinline__ int window_copy(unsigned char* dst,
                                           const void* src, int64_t bytes,
                                           int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  const int64_t chunks =
      bytes > 0 ? static_cast<int64_t>((a + bytes - a0 + 15) >> 4) : 0;
  for (int64_t q = lane; q < chunks; q += 32)
    cp_async16(dst + 16 * q, reinterpret_cast<const void*>(a0 + 16 * q));
  return static_cast<int>(a - a0);
}

template <typename TH, typename TW>
__global__ void __launch_bounds__(256)
    head_warp_kernel(const int32_t* __restrict__ uid,
                     const TH* __restrict__ H, const TW* __restrict__ W,
                     const TW* __restrict__ b, float* __restrict__ out,
                     int B, int m, int d, int n, int warp_smem, int w_slot,
                     int h_slot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (r >= B) return;                       // warp-uniform; no block barrier
  float* o = out + r * n;
  const int32_t u = uid[r];
  if (static_cast<uint32_t>(u) >= static_cast<uint32_t>(m)) {
    if (lane < n) o[lane] = __int_as_float(0x7fc00000);
    return;
  }
  unsigned char* base = smem + static_cast<size_t>(threadIdx.x >> 5) *
                                   warp_smem;
  const int64_t slab = static_cast<int64_t>(d) * n;
  const int ow = window_copy(base, W + u * slab, slab * sizeof(TW), lane);
  const int oh = window_copy(base + w_slot, H + r * d,
                             static_cast<int64_t>(d) * sizeof(TH), lane);
  const int ob = window_copy(base + w_slot + h_slot,
                             b + static_cast<int64_t>(u) * n,
                             static_cast<int64_t>(n) * sizeof(TW), lane);
  cp_async_wait_all();
  __syncwarp();
  const TW* sW = reinterpret_cast<const TW*>(base + ow);
  const TH* sH = reinterpret_cast<const TH*>(base + w_slot + oh);
  const TW* sb = reinterpret_cast<const TW*>(base + w_slot + h_slot + ob);

  const int groups = 32 / n;                // n <= 32 on this route
  const int c = lane % n, g = lane / n;
  float acc = 0.0f;
  if (g < groups) {
    for (int t = g; t < d; t += groups)
      acc = fmaf(to_f32(sH[t]), to_f32(sW[t * n + c]), acc);
  }
  // lane c < n adds the sums of lanes c + n, c + 2n, ... in group order
  for (int q = 1; q < groups; ++q) {
    const float v = __shfl_sync(0xffffffffu, acc, lane + q * n);
    if (lane < n) acc += v;
  }
  if (lane < n) o[lane] = acc + to_f32(sb[lane]);
}

template <typename TH, typename TW>
__global__ void __launch_bounds__(256)
    head_tiled_kernel(const int32_t* __restrict__ uid,
                      const TH* __restrict__ H, const TW* __restrict__ W,
                      const TW* __restrict__ b, float* __restrict__ out,
                      int m, int d, int n, int block_n) {
  // H[r] as f32, then (after a barrier) the groups' partial sums
  extern __shared__ float s_h[];
  const int64_t r = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    s_h[t] = to_f32(H[r * d + t]);
  __syncthreads();

  const int32_t u = uid[r];
  const bool valid = static_cast<uint32_t>(u) < static_cast<uint32_t>(m);
  const int groups = blockDim.x / block_n;
  const int cl = threadIdx.x % block_n, g = threadIdx.x / block_n;
  const int c = blockIdx.y * block_n + cl;
  float acc = 0.0f;
  if (valid && g < groups && c < n) {
    const TW* Wc = W + static_cast<int64_t>(u) * d * n + c;
#pragma unroll 4
    for (int t = g; t < d; t += groups)
      acc = fmaf(s_h[t], to_f32(Wc[static_cast<int64_t>(t) * n]), acc);
  }
  __syncthreads();                          // every thread is done with H
  if (g < groups) s_h[g * block_n + cl] = acc;
  __syncthreads();
  if (threadIdx.x < block_n && c < n) {     // here cl == threadIdx.x, g == 0
    if (!valid) {
      out[r * n + c] = __int_as_float(0x7fc00000);
      return;
    }
    float s = s_h[threadIdx.x];
    for (int q = 1; q < groups; ++q) s += s_h[q * block_n + threadIdx.x];
    out[r * n + c] = s + to_f32(b[static_cast<int64_t>(u) * n + c]);
  }
}

template <typename TH, typename TW>
int launch_warp(const void* uid, const void* H, const void* W, const void* b,
                void* out, int B, int m, int d, int n, int warps,
                int warp_smem, int w_slot, int h_slot, void* stream) {
  if (B == 0 || n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  head_warp_kernel<TH, TW><<<blocks, 32 * warps,
                             static_cast<size_t>(warps) * warp_smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uid), static_cast<const TH*>(H),
      static_cast<const TW*>(W), static_cast<const TW*>(b),
      static_cast<float*>(out), B, m, d, n, warp_smem, w_slot, h_slot);
  return static_cast<int>(cudaGetLastError());
}

template <typename TH, typename TW>
int launch_tiled(const void* uid, const void* H, const void* W,
                 const void* b, void* out, int B, int m, int d, int n,
                 int block_n, int threads, void* stream) {
  if (B == 0 || n == 0) return 0;
  dim3 grid(static_cast<unsigned>(B),
            static_cast<unsigned>((n + block_n - 1) / block_n));
  const size_t smem = static_cast<size_t>(d > threads ? d : threads) *
                      sizeof(float);
  head_tiled_kernel<TH, TW><<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uid), static_cast<const TH*>(H),
      static_cast<const TW*>(W), static_cast<const TW*>(b),
      static_cast<float*>(out), m, d, n, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define HEAD_GATHER_ENTRY(NAME, TH, TW)                                      \
  int NAME##_warp(const void* uid, const void* H, const void* W,             \
                  const void* b, void* out, int B, int m, int d, int n,      \
                  int warps, int warp_smem, int w_slot, int h_slot,          \
                  void* stream) {                                            \
    return launch_warp<TH, TW>(uid, H, W, b, out, B, m, d, n, warps,         \
                               warp_smem, w_slot, h_slot, stream);           \
  }                                                                          \
  int NAME##_tiled(const void* uid, const void* H, const void* W,            \
                   const void* b, void* out, int B, int m, int d, int n,     \
                   int block_n, int threads, void* stream) {                 \
    return launch_tiled<TH, TW>(uid, H, W, b, out, B, m, d, n, block_n,      \
                                threads, stream);                            \
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
