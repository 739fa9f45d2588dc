// Dense push-sum gossip contraction over the stacked client axis:
//
//     out = P @ U          P: (m, m) f32,  U: (m, d) f32 or bf16
//
// f32 products and sums in IEEE f32 (fmaf), no TF32 and no tensor cores,
// so the result stays within f32 rounding of `P.float() @ U.float()`; the
// output is written in U's type.  Each output element sums its m products
// in k order, one FMA each.
//
// Replaces the Pallas TPU kernel repro/kernels/pushsum_mix.py
// (pushsum_mix_pallas / _mix_kernel), which keeps P resident in VMEM and
// streams (m, 512) column panels of U through the MXU.
//
// Bound on an H100: at the main path's shape (m = 100, d = 13,328) the
// work is 2*m*m*d = 266.6 MFLOP, 3.98 us at 67 TFLOP/s of f32 outside the
// tensor cores, against 10.7 MB of U in and out, 3.19 us at 3.35 TB/s: so
// operations, narrowly.  The kernel has to keep the FMA pipes busy.
//
// Design (the tile and grid are planned in kernels/pushsum_mix.py `plan`):
// - one block per (row tile, column panel).  A row tile holds all m rows
//   when m <= 128, padded only to the thread tile (TM = 8), so each panel
//   of U is read from memory once and no FMA multiplies a padded row
//   beyond those 8; for m > 128 the row tiles are 128 rows;
// - the panel width bn (a multiple of 8, at most 128) is chosen so that
//   the blocks fill the SMs evenly (129 blocks of 104 columns at the main
//   shape on 132 SMs);
// - the contraction runs in chunks of BK = 16 over a ring of STAGES
//   buffers: cp.async copies chunk c + STAGES - 1 (P as it lies, U, 16
//   bytes a copy where aligned) while chunk c is multiplied.  Out-of-range
//   rows, columns and k stage as zeros;
// - each thread owns TM = 8 rows x TN = 4 columns in registers.  Four k
//   at a time it reads a float4 of P per row (8) and a float4 of U per k
//   (4; four bf16 from 8 bytes) for 128 FFMA.  Neighbouring threads take
//   neighbouring columns, so a warp reads two row groups of P, in
//   different banks by the swizzle below, and one contiguous run of U.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16, TM = 8, TN = 4, STAGES = 4;
constexpr int MAX_TILE_M = 128, MAX_BN = 128;
constexpr int kMaxThreads = (MAX_TILE_M / TM) * (MAX_BN / TN);

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
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

// four consecutive elements of a staged U row, as f32
__device__ __forceinline__ void load4(const float* p, float* b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* b) {
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

// P is staged as it lies, a row of BK values per tile row, its 16-byte
// quads swizzled by the row's thread group so that the two row groups a
// warp reads fall in different banks: quad q of row i sits at quad
// q ^ ((i / TM) & 3).
__device__ __forceinline__ int p_slot(int i, int k) {
  return i * BK + 4 * ((k >> 2) ^ ((i / TM) & 3)) + (k & 3);
}

// VEC: U and out 16-byte aligned with rows of a multiple of 16 bytes, so
// U is staged by 16-byte cp.async and out written 4 elements at a time.
// PVEC: P 16-byte aligned with m a multiple of 4: P staged 16 bytes a
// copy, else 4.
template <typename T, bool VEC, bool PVEC>
__global__ void __launch_bounds__(kMaxThreads)
pushsum_mix_kernel(const float* __restrict__ P, const T* __restrict__ U,
                   T* __restrict__ out, int m, int64_t d, int tile_m,
                   int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);     // [STAGES][tile_m][BK]
  T* Us = reinterpret_cast<T*>(Ps + STAGES * tile_m * BK);  // [STAGES][BK][bn]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cg_n = bn / TN;
  const int rg = tid / cg_n, cg = tid % cg_n;
  const bool active = rg < tile_m / TM;
  const int row0 = blockIdx.y * tile_m;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int nchunks = (m + BK - 1) / BK;

  auto load = [&](int c) {
    if (c < nchunks) {
      const int k0 = c * BK;
      float* ps = Ps + (c % STAGES) * tile_m * BK;
      if (PVEC) {
        for (int e = tid; e < tile_m * (BK / 4); e += nthreads) {
          const int i = e / (BK / 4), k = 4 * (e % (BK / 4));
          const int gi = row0 + i, gk = k0 + k;
          const bool ok = gi < m && gk < m;
          cp_async16(ps + p_slot(i, k),
                     ok ? P + static_cast<int64_t>(gi) * m + gk : P, ok);
        }
      } else {
        for (int e = tid; e < tile_m * BK; e += nthreads) {
          const int i = e / BK, k = e % BK;
          const int gi = row0 + i, gk = k0 + k;
          const bool ok = gi < m && gk < m;
          cp_async4(ps + p_slot(i, k),
                    ok ? P + static_cast<int64_t>(gi) * m + gk : P, ok);
        }
      }
      T* us = Us + (c % STAGES) * BK * bn;
      if (VEC) {
        constexpr int V = 16 / sizeof(T);
        const int vpr = bn / V;
        for (int e = tid; e < BK * vpr; e += nthreads) {
          const int k = e / vpr, v = e % vpr;
          const int gk = k0 + k;
          const int64_t gc = col0 + v * V;
          const bool ok = gk < m && gc < d;
          cp_async16(us + k * bn + v * V,
                     ok ? U + static_cast<int64_t>(gk) * d + gc : U, ok);
        }
      } else {
        for (int e = tid; e < BK * bn; e += nthreads) {
          const int k = e / bn, cc = e % bn;
          const int gk = k0 + k;
          const int64_t gc = col0 + cc;
          us[k * bn + cc] = (gk < m && gc < d)
                                ? U[static_cast<int64_t>(gk) * d + gc]
                                : from_f32<T>(0.0f);
        }
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  constexpr int RUNS = TN / 4;   // runs of 4 columns, bn / RUNS apart
  const int run_w = bn / RUNS;
  const int sw = rg & 3;         // this thread's rows' quad swizzle
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();               // ... every thread's; slot c-1 is free
    load(c + STAGES - 1);
    if (active) {
      const float* ps = Ps + (c % STAGES) * tile_m * BK + rg * TM * BK;
      const T* us = Us + (c % STAGES) * BK * bn + cg * 4;
      // four k at a time: a float4 of P per row, a run of U per k
#pragma unroll
      for (int q = 0; q < BK / 4; ++q) {
        float a[TM][4], b[4][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              ps + i * BK + 4 * (q ^ sw));
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < RUNS; ++r)
            load4(us + (4 * q + kk) * bn + r * run_w, b[kk] + 4 * r);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const int64_t gc = col0 + r * run_w + cg * 4;
    if (gc >= d) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gi = row0 + rg * TM + i;
      if (gi >= m) break;
      T* o = out + static_cast<int64_t>(gi) * d + gc;
      if (VEC) {
        store4(o, acc[i] + 4 * r);   // d a multiple of 4: gc + 4 <= d
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < d) o[j] = from_f32<T>(acc[i][4 * r + j]);
      }
    }
  }
}

template <typename T, bool VEC, bool PVEC>
int launch_as(const void* P, const void* U, void* out, int m, int64_t d,
              int tile_m, int bn, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(STAGES) * BK *
                      (tile_m * sizeof(float) + bn * sizeof(T));
  static size_t opted = 0;   // per instantiation: raise the limit once
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        pushsum_mix_kernel<T, VEC, PVEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const int threads = ((tile_m / TM) * (bn / TN) + 31) / 32 * 32;
  dim3 grid(static_cast<unsigned>((d + bn - 1) / bn),
            static_cast<unsigned>((m + tile_m - 1) / tile_m));
  pushsum_mix_kernel<T, VEC, PVEC><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(P), static_cast<const T*>(U),
      static_cast<T*>(out), m, d, tile_m, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* P, const void* U, void* out, int m, long long d,
           int tile_m, int bn, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (tile_m < TM || tile_m > MAX_TILE_M || tile_m % TM || bn < 8 ||
      bn > MAX_BN || bn % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      (reinterpret_cast<uintptr_t>(U) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
      (static_cast<int64_t>(d) * sizeof(T) % 16 == 0);
  const bool pvec = reinterpret_cast<uintptr_t>(P) % 16 == 0 && m % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return pvec ? launch_as<T, true, true>(P, U, out, m, d, tile_m, bn, s)
                : launch_as<T, true, false>(P, U, out, m, d, tile_m, bn, s);
  return pvec ? launch_as<T, false, true>(P, U, out, m, d, tile_m, bn, s)
              : launch_as<T, false, false>(P, U, out, m, d, tile_m, bn, s);
}

}  // namespace

extern "C" {

int pushsum_mix_f32(const void* P, const void* U, void* out, int m,
                    long long d, int tile_m, int bn, void* stream) {
  return launch<float>(P, U, out, m, d, tile_m, bn, stream);
}

int pushsum_mix_bf16(const void* P, const void* U, void* out, int m,
                     long long d, int tile_m, int bn, void* stream) {
  return launch<__nv_bfloat16>(P, U, out, m, d, tile_m, bn, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
