// Compact-working-set scatter into the resident buffer, in place, for up
// to kMaxPairs (X, U) pairs that share one row table in one launch:
//
//     U_q[rows[p], c] = X_q[p, c]                                  (set)
//     U_q[rows[p], c] = U_q[rows[p], c] + X_q[p, c]   (accumulate, f32 sum)
//
// X_q: (n, d), U_q: (m, d); X is rounded to U's type first, as the
// reference casts it before its kernel (so accumulate adds the rounded X).
// All pairs share one shape, one X type and one U type.
//
// Replaces the Pallas TPU kernel repro/kernels/gossip_scatter.py
// (gossip_scatter_pallas / _scatter_kernel), which aliases U to its output
// so the dormant rows are never copied.  Here the launch writes into U's
// own storage: no copy of U, no padding, no dormant row touched.  The
// reference launches once per buffer; the sampled round's write-back of
// its 2 (4 with a codec) buffers is one launch here.
//
// Bound on an H100: memory, and at the main path's shape the launch.  At
// (m = 100, n = 25, d = 13,328, f32) one pair is X read once and 25 rows
// written, 2.67 MB, 0.80 us at 3.35 TB/s; at m = 4096, n = 1024 it is
// 109 MB, 32.6 us.  There are no operations to speak of.
//
// Design:
// - a block of the grid (n, grid_y) moves chunks of block_d = 4 T V
//   columns of its compact row p for every pair, T threads, each with V
//   slots of 4 columns per pair: chunk blockIdx.y where grid_y = chunks
//   (every Regime-A shape), else chunk blockIdx.y and every grid_y-th
//   after it (the STRIDE instance), grid_y = 65,535, the grid's y
//   extent, so a row of any width fits (an LM's shared row of
//   494,031,872 columns takes 120,614 chunks of 4,096, two a block).
//   The pair count P and V are template
//   arguments (P V <= kMaxSlots), so each pair's pointers are read from
//   the argument at constant offsets and the slots stay in registers;
// - the row id is needed only by the store: every thread issues its P V
//   loads of X before the load of rows[p], so one L2 round trip precedes
//   the stores, not two.  Accumulate's loads of U wait for the row;
// - a slot is one 16-byte access of f32 X (8 bytes of bf16) where d is a
//   multiple of 4 and the buffers are 16-byte aligned ("vector"), else 4
//   scalars strided by T ("scalar");
// - an out-of-range destination row writes nothing.
// At the main path's shape the launch and the first instructions are
// most of the time (kernels/gossip_scatter.py `plan` picks V = 1 there),
// so the code before the first load is kept short.
// Rows must be unique: duplicate rows race, as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;       // columns per slot
constexpr int kMaxSlots = 8;   // slots per thread: pairs x slots per pair
constexpr int kMaxPairs = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;   // the grid's y extent

}  // namespace

extern "C" {
// The pairs' base pointers, passed by value.
struct ScatterPairs {
  const void* X[kMaxPairs];
  void* U[kMaxPairs];
};
}

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

// The value written at one column: X rounded to U's type (exact for equal
// types and bf16 -> f32), plus U's old value in f32 when accumulating.
template <typename TU, typename TX>
__device__ __forceinline__ TU scatter_value(TU u_old, TX x, bool accumulate) {
  const TU xu = from_f32<TU>(to_f32(x));
  return accumulate ? from_f32<TU>(__fadd_rn(to_f32(u_old), to_f32(xu))) : xu;
}

// Loads of X through the read-only path.
__device__ __forceinline__ void load_x(const float* p, float& v) {
  v = __ldg(p);
}
__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       __nv_bfloat16& v) {
  v = __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
// four consecutive values through one 16- (f32) or 8-byte (bf16) access
__device__ __forceinline__ void load_x4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_x4(const __nv_bfloat16* p,
                                        __nv_bfloat16 v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
  v[0] = h[0]; v[1] = h[1]; v[2] = h[2]; v[3] = h[3];
}
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
  __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const __nv_bfloat16 v[4]) {
  uint2 t;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
  h[0] = v[0]; h[1] = v[1]; h[2] = v[2]; h[3] = v[3];
  __stwb(reinterpret_cast<uint2*>(p), t);
}

// The first column of slot s of this thread (VEC: its 4 columns follow),
// or of access j of the slot (scalar: strided by T = blockDim.x).
template <bool VEC>
__device__ __forceinline__ int64_t column(int64_t c0, int s, int j) {
  const int64_t t = threadIdx.x, T = blockDim.x;
  return VEC ? c0 + (s * T + t) * kCols : c0 + (s * kCols + j) * T + t;
}

// One chunk [c0, c0 + block_d) of compact row p, for every pair.  Returns
// false when the row's destination lies outside [0, m): nothing written.
template <typename TU, typename TX, bool VEC, int P, int V>
__device__ __forceinline__ bool move_chunk(const int32_t* __restrict__ rows,
                                           const ScatterPairs& pairs, int m,
                                           int64_t d, int64_t p, int64_t c0,
                                           bool accumulate) {
  constexpr int J = VEC ? 1 : kCols;   // accesses per slot
  TX xv[P][V][kCols];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const TX* src = static_cast<const TX*>(pairs.X[q]) + p * d;
#pragma unroll
    for (int s = 0; s < V; ++s) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int64_t c = column<VEC>(c0, s, j);
        if (c >= d) continue;
        if (VEC) load_x4(src + c, xv[q][s]); else load_x(src + c, xv[q][s][j]);
      }
    }
  }
  const int32_t r = __ldg(rows + p);
  if (static_cast<uint32_t>(r) >= static_cast<uint32_t>(m)) return false;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    TU* dst = static_cast<TU*>(pairs.U[q]) + static_cast<int64_t>(r) * d;
    TU uv[V][kCols];
#pragma unroll
    for (int s = 0; s < V; ++s) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int64_t c = column<VEC>(c0, s, j);
        if (c >= d) continue;
        if (accumulate) {
          if (VEC) load4(dst + c, uv[s]); else uv[s][j] = dst[c];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < V; ++s) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        uv[s][j] = scatter_value<TU, TX>(accumulate ? uv[s][j] : TU(),
                                         xv[q][s][j], accumulate);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int64_t c = column<VEC>(c0, s, j);
        if (c >= d) continue;
        if (VEC) store4(dst + c, uv[s]); else dst[c] = uv[s][j];
      }
    }
  }
  return true;
}

// STRIDE false: the block moves chunk blockIdx.y alone (grid_y = chunks),
// straight-line code whose X loads go out before the row id's.  STRIDE
// true: chunks blockIdx.y, + grid_y, ... in a loop, for rows wider than
// the grid's y extent holds; there the compiler may hoist the row id's
// load and test out of the loop, ahead of the X loads, which costs one
// L2 round trip per block and nothing per chunk.
template <typename TU, typename TX, bool VEC, int P, int V, bool STRIDE>
__global__ void __launch_bounds__(kMaxThreads)
gossip_scatter_kernel(const int32_t* __restrict__ rows, ScatterPairs pairs,
                      int m, int64_t d, int chunks, bool accumulate) {
  const int64_t p = blockIdx.x;
  const int64_t block_d = static_cast<int64_t>(blockDim.x) * kCols * V;
  if (!STRIDE) {
    move_chunk<TU, TX, VEC, P, V>(rows, pairs, m, d, p, blockIdx.y * block_d,
                                  accumulate);
    return;
  }
  for (int ch = blockIdx.y; ch < chunks; ch += gridDim.y) {
    if (!move_chunk<TU, TX, VEC, P, V>(rows, pairs, m, d, p, ch * block_d,
                                       accumulate))
      return;
  }
}

// (P, V) -> the kernel of P pairs and V slots per pair, P V <= kMaxSlots.
template <typename TU, typename TX, bool VEC, bool STRIDE>
int launch_tiles(const int32_t* rows, ScatterPairs pairs, int np, int v,
                 dim3 grid, int threads, int m, int64_t d, int chunks,
                 bool accumulate, cudaStream_t s) {
#define REPRO_SCATTER_TILE(P, V)                                            \
  if (np == P && v == V) {                                                  \
    gossip_scatter_kernel<TU, TX, VEC, P, V, STRIDE>                        \
        <<<grid, threads, 0, s>>>(rows, pairs, m, d, chunks, accumulate);   \
    return 0;                                                               \
  }
  REPRO_SCATTER_TILE(1, 1) REPRO_SCATTER_TILE(1, 2) REPRO_SCATTER_TILE(1, 4)
  REPRO_SCATTER_TILE(1, 8) REPRO_SCATTER_TILE(2, 1) REPRO_SCATTER_TILE(2, 2)
  REPRO_SCATTER_TILE(2, 4) REPRO_SCATTER_TILE(3, 1) REPRO_SCATTER_TILE(3, 2)
  REPRO_SCATTER_TILE(4, 1) REPRO_SCATTER_TILE(4, 2)
#undef REPRO_SCATTER_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TU, typename TX>
int launch(const void* rows, ScatterPairs pairs, int np, int n, int m,
           long long d, int accumulate, int vec, int chunks, int grid_y,
           int v, int threads, void* stream) {
  if (n == 0 || d == 0) return 0;
  if (grid_y < 1 || grid_y > kMaxGridY || grid_y > chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(grid_y));
  const auto r = static_cast<const int32_t*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0, stride = grid_y < chunks;
  int rc;
  if (vec)
    rc = stride ? launch_tiles<TU, TX, true, true>(r, pairs, np, v, grid,
                                                   threads, m, d, chunks,
                                                   acc, s)
                : launch_tiles<TU, TX, true, false>(r, pairs, np, v, grid,
                                                    threads, m, d, chunks,
                                                    acc, s);
  else
    rc = stride ? launch_tiles<TU, TX, false, true>(r, pairs, np, v, grid,
                                                    threads, m, d, chunks,
                                                    acc, s)
                : launch_tiles<TU, TX, false, false>(r, pairs, np, v, grid,
                                                     threads, m, d, chunks,
                                                     acc, s);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define REPRO_SCATTER_ENTRY(NAME, TU, TX)                                  \
  int NAME(const void* rows, ScatterPairs pairs, int np, int n, int m,     \
           long long d, int accumulate, int vec, int chunks, int grid_y,   \
           int v, int threads, void* stream) {                             \
    return launch<TU, TX>(rows, pairs, np, n, m, d, accumulate, vec,       \
                          chunks, grid_y, v, threads, stream);             \
  }

// named gossip_scatter_x<X's type>_u<U's type>
REPRO_SCATTER_ENTRY(gossip_scatter_xf32_uf32, float, float)
REPRO_SCATTER_ENTRY(gossip_scatter_xbf16_uf32, float, __nv_bfloat16)
REPRO_SCATTER_ENTRY(gossip_scatter_xf32_ubf16, __nv_bfloat16, float)
REPRO_SCATTER_ENTRY(gossip_scatter_xbf16_ubf16, __nv_bfloat16, __nv_bfloat16)

// the layout constants kernels/gossip_scatter.py plans with
int gossip_scatter_max_pairs() { return kMaxPairs; }
int gossip_scatter_max_slots() { return kMaxSlots; }
int gossip_scatter_max_threads() { return kMaxThreads; }
int gossip_scatter_max_grid_y() { return kMaxGridY; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
