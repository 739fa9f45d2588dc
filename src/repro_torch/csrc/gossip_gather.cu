// Neighbor-indexed gossip gather-mix over the flat client buffer:
//
//     out[i, c] = sum_{j < k} w[i, j] * U[idx[i, j], c]       U: (N, d)
//
// for the n rows i of the (n, k) table, over a buffer of N >= n rows (the
// cross-rank matrix mix: a rank's own rows followed by its received halo).
//
// Replaces the Pallas TPU kernel repro/kernels/gossip_gather.py
// (gossip_gather_pallas / _gather_kernel).
//
// Bound on an H100: memory.  At the port's main-path shape (m = 100,
// k = 11, d = 13,328, f32) the unique bytes are U read once plus the
// output written once, 2 * 100 * 13,328 * 4 B = 10.7 MB; the work is
// 2*m*k*d = 29 MFLOP, far below the f32 rate.
//
// Both routes sum j = 0..k-1 IN ORDER in f32 with __fmul_rn then
// __fadd_rn (no contracted FMA): for f32 U the result equals the plain
// torch `mix_rows` (separate multiply and add ops) bit for bit.  U may be
// f32 or bf16; the output is written in U's dtype.  An out-of-range
// neighbor id (outside [0, N)) contributes NaN (jnp.take's fill) instead
// of reading outside U.  The route and its panel width are planned in
// kernels/gossip_gather.py `plan`.
//
// Panel route (gossip_gather_panel_kernel), where all N rows of a panel
// of 16 columns fit in shared memory:
// - one block per column panel of bn columns stages that panel of U for
//   all N buffer rows in shared memory (16-byte cp.async where aligned).  Every
//   output row of the panel is then computed from shared memory: U is
//   read from memory once and the output written once, where one block
//   per output row re-read its k neighbor rows (the row route: 11x U's
//   bytes from L2 at the main shape);
// - the neighbor table is staged beside the panel as (offset into the
//   panel, weight) pairs when it fits, else read through L1 (warp-uniform
//   along a row);
// - up to 1,024 threads, each owning 4 consecutive columns of one output
//   row at a time: one 16-byte (f32) or 8-byte (bf16) shared load per
//   neighbor.  The sums are dependent chains of k loads, so the block is
//   as large as it may be to keep many in flight.
//
// Row route (gossip_gather_kernel), for N too large for a panel: one block
// per (output row i, d-chunk); the block stages its own idx[i, :] and
// w[i, :] in shared memory; threads stride over the chunk's columns,
// neighbouring threads on neighbouring addresses, kCols independent
// columns per thread so several loads are in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;        // row route: columns per thread
constexpr int TN = 4;           // panel route: columns per thread
constexpr int kMaxSmem = 232448;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load4(const float* p, float (&b)[TN]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&b)[TN]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  b[0] = __uint_as_float(v.x << 16); b[1] = __uint_as_float(v.x & 0xffff0000u);
  b[2] = __uint_as_float(v.y << 16); b[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&lo);
  v.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// ---------------------------------------------------------------- panel
// VEC: U and out 16-byte aligned with rows of a multiple of 16 bytes.
// TABLE: the neighbor table is staged in shared memory after the panel.
// bn: panel width, a multiple of 16 bytes of T.
template <typename T, bool VEC, bool TABLE>
__global__ void __launch_bounds__(1024)
gossip_gather_panel_kernel(const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           const T* __restrict__ U, T* __restrict__ out,
                           int m, int N, int k, int64_t d, int bn) {
  // m: table and output rows; N >= m: buffer rows, all staged
  extern __shared__ __align__(16) unsigned char smem[];
  T* Us = reinterpret_cast<T*>(smem);                    // [N][bn]
  const size_t panel_bytes =
      (static_cast<size_t>(N) * bn * sizeof(T) + 15) / 16 * 16;
  int2* tab = reinterpret_cast<int2*>(smem + panel_bytes);   // [m * k]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * bn;

  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = bn / V;
    for (int e = tid; e < N * vpr; e += nthreads) {
      const int r = e / vpr, cc = (e % vpr) * V;
      const bool ok = c0 + cc < d;
      cp_async16(Us + static_cast<int64_t>(r) * bn + cc,
                 ok ? U + static_cast<int64_t>(r) * d + c0 + cc : U, ok);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < N * bn; e += nthreads) {
      const int r = e / bn, cc = e % bn;
      Us[static_cast<int64_t>(r) * bn + cc] =
          c0 + cc < d ? U[static_cast<int64_t>(r) * d + c0 + cc]
                      : from_f32<T>(0.0f);
    }
  }
  if (TABLE) {   // while the panel lands
    for (int e = tid; e < m * k; e += nthreads) {
      const int32_t nb = idx[e];
      const bool ok = static_cast<uint32_t>(nb) < static_cast<uint32_t>(N);
      tab[e] = make_int2(ok ? nb * bn : -1, __float_as_int(w[e]));
    }
  }
  if (VEC) cp_async_wait<0>();
  __syncthreads();

  const int cg_n = bn / TN;
  const int slots = nthreads / cg_n;
  const int slot = tid / cg_n, cc = (tid % cg_n) * TN;
  const int64_t gc = c0 + cc;
  if (slot >= slots || gc >= d) return;
  for (int i = slot; i < m; i += slots) {
    float acc[TN] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < k; ++j) {
      int off;
      float wj;
      if (TABLE) {
        const int2 t = tab[i * k + j];
        off = t.x;
        wj = __int_as_float(t.y);
      } else {
        const int32_t nb = __ldg(idx + static_cast<int64_t>(i) * k + j);
        off = static_cast<uint32_t>(nb) < static_cast<uint32_t>(N)
                  ? nb * bn : -1;
        wj = __ldg(w + static_cast<int64_t>(i) * k + j);
      }
      float u[TN];
      if (off >= 0) {
        load4(Us + off + cc, u);
      } else {
#pragma unroll
        for (int t = 0; t < TN; ++t) u[t] = __int_as_float(0x7fc00000);
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float term = __fmul_rn(wj, u[t]);   // NaN stays NaN
        acc[t] = (j == 0) ? term : __fadd_rn(acc[t], term);
      }
    }
    T* o = out + static_cast<int64_t>(i) * d + gc;
    if (VEC) {
      store4(o, acc);    // d a multiple of 16 bytes: gc + 4 <= d
    } else {
#pragma unroll
      for (int t = 0; t < TN; ++t)
        if (gc + t < d) o[t] = from_f32<T>(acc[t]);
    }
  }
}

template <typename T, bool VEC, bool TABLE>
int launch_panel_as(const void* idx, const void* w, const void* U, void* out,
                    int m, int N, int k, int64_t d, int bn, int threads,
                    cudaStream_t stream) {
  size_t smem = (static_cast<size_t>(N) * bn * sizeof(T) + 15) / 16 * 16;
  if (TABLE) smem += static_cast<size_t>(m) * k * sizeof(int2);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted = 0;   // per instantiation: raise the limit once
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gossip_gather_panel_kernel<T, VEC, TABLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const unsigned panels = static_cast<unsigned>((d + bn - 1) / bn);
  gossip_gather_panel_kernel<T, VEC, TABLE><<<panels, threads, smem,
                                              stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<const T*>(U), static_cast<T*>(out), m, N, k, d, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_panel(const void* idx, const void* w, const void* U, void* out,
                 int m, int N, int k, long long d, int bn, int threads,
                 int table, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (N < m) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  if (bn < V || bn % V || threads < bn / TN || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(U) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   (static_cast<int64_t>(d) * sizeof(T) % 16 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t dd = d;
  if (vec)
    return table ? launch_panel_as<T, true, true>(idx, w, U, out, m, N, k,
                                                  dd, bn, threads, s)
                 : launch_panel_as<T, true, false>(idx, w, U, out, m, N, k,
                                                   dd, bn, threads, s);
  return table ? launch_panel_as<T, false, true>(idx, w, U, out, m, N, k,
                                                 dd, bn, threads, s)
               : launch_panel_as<T, false, false>(idx, w, U, out, m, N, k,
                                                  dd, bn, threads, s);
}

// ------------------------------------------------------------------ row
template <typename T>
__global__ void gossip_gather_kernel(const int32_t* __restrict__ idx,
                                     const float* __restrict__ w,
                                     const T* __restrict__ U,
                                     T* __restrict__ out, int N, int k,
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
    const bool ok = static_cast<uint32_t>(nb) < static_cast<uint32_t>(N);
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
int launch_row(const void* idx, const void* w, const void* U, void* out,
               int m, int N, int k, long long d, int threads, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (N < m) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = static_cast<int64_t>(threads) * kCols;
  dim3 grid(static_cast<unsigned>(m),
            static_cast<unsigned>((d + per_block - 1) / per_block));
  const size_t smem = static_cast<size_t>(k) * (sizeof(int32_t) + sizeof(float));
  gossip_gather_kernel<T><<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<const T*>(U), static_cast<T*>(out), N, k,
      static_cast<int64_t>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx, w: (n, k); U: (N, d), N >= n; out: (n, d).
int gossip_gather_f32(const void* idx, const void* w, const void* U,
                      void* out, int n, int N, int k, long long d,
                      int threads, void* stream) {
  return launch_row<float>(idx, w, U, out, n, N, k, d, threads, stream);
}

int gossip_gather_bf16(const void* idx, const void* w, const void* U,
                       void* out, int n, int N, int k, long long d,
                       int threads, void* stream) {
  return launch_row<__nv_bfloat16>(idx, w, U, out, n, N, k, d, threads,
                                   stream);
}

int gossip_gather_panel_f32(const void* idx, const void* w, const void* U,
                            void* out, int n, int N, int k, long long d,
                            int bn, int threads, int table, void* stream) {
  return launch_panel<float>(idx, w, U, out, n, N, k, d, bn, threads, table,
                             stream);
}

int gossip_gather_panel_bf16(const void* idx, const void* w, const void* U,
                             void* out, int n, int N, int k, long long d,
                             int bn, int threads, int table, void* stream) {
  return launch_panel<__nv_bfloat16>(idx, w, U, out, n, N, k, d, bn, threads,
                                     table, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
