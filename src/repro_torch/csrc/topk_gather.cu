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
// scatter.  A GPU scatters into a shared-memory f32 accumulator instead
// (O(K) per row and neighbor).  Two routes, chosen by shape in
// kernels/topk_gather.py `plan` (never on a failure):
// - staged (its blocks fit in one wave and a payload row fits beside the
//   chunk's accumulator): one 512-thread block per (output row i, chunk of
//   block_d columns; whole rows at the codec path's m = 100).  The row's k
//   neighbor payload rows (values and columns) are copied to shared memory
//   by bulk copies (cp.async.bulk, one per array and neighbor, each tracked
//   by its stage's mbarrier), all copies in flight before the first wait,
//   as the TPU kernel starts every DMA before its first wait; where k rows
//   do not fit, through a ring of `stages` rows.  A payload row starts at
//   idx*K elements, so each copy takes the 16-byte-aligned window that
//   holds the row.  The adds then read shared memory only.  A shared f32
//   atomicAdd is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN in the
//   SASS), while int atomics are native, so a pair claims
//   its column with a native int atomicExch of j and adds in place, and
//   only a pair that finds its own j there (a duplicate column of the same
//   payload row) is deferred to an f32 atomicAdd after the neighbor's
//   barrier.  The chunk is written with 16-byte stores, the accumulator
//   shifted in shared memory to the output's alignment.  The block's own
//   chain of copies, k barriers and stores sets the pace, so beyond one
//   wave of blocks the chunked route is faster;
// - chunked (more blocks than one wave, or a payload row too long for
//   shared memory): one 256-thread block per (row,
//   chunk of block_d columns) reading the pairs from L2 in batches of
//   kBatch per thread, the next neighbor's first batch loaded ahead, and
//   adding with shared f32 atomicAdd; several blocks share an SM and
//   overlap each other's latencies.
// On both, the neighbors are taken in j order with a __syncthreads()
// between them, each product rounded (__fmul_rn).  A codec's columns are
// distinct within one payload row, so each slot sees at most one add per
// neighbor and the adds land in j order: for f32 values the result equals
// the plain version (dense decode, then the j-ordered gather with rounded
// products) bit for bit.  Duplicate columns within one row, which the
// contract allows, add in the atomics' order.  Columns outside [0, d) are
// dropped.  Columns are read as they lie on the wire (uint16 or int32),
// nothing is padded or copied.  An out-of-range neighbor id makes its row
// NaN (the gather's fill) instead of reading outside the payload.
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


// --- staged route ------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 16-byte-aligned window [a0, a0 + bytes) that holds `n` bytes at p:
// every 16-byte chunk of it holds a byte of the source, so it stays inside
// the source's allocation.
struct Window {
  const unsigned char* a0;
  uint32_t bytes;
  uint32_t offset;      // p - a0
};
__device__ __forceinline__ Window window(const void* p, int64_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const unsigned char*>(a0),
          n > 0 ? static_cast<uint32_t>(((a + n + 15) & ~static_cast<
                                             uintptr_t>(15)) - a0)
                : 0u,
          static_cast<uint32_t>(a - a0)};
}

template <typename T, typename C>
struct Staged {
  const T* vals;
  const C* cols;
  int m;
  int64_t K;
  uint32_t bars, ring;  // shared addresses: stages mbarriers, payload ring
  int slot_v, slot_c;   // bytes of a stage's value and column windows

  __device__ __forceinline__ uint32_t bar(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t stage_v(int s) const {
    return ring + s * (slot_v + slot_c);
  }
  // Starts the copies of neighbor nb's payload row into stage s, or
  // completes the stage's phase at once for an invalid id or an empty row.
  __device__ __forceinline__ void issue(int32_t nb, int s) const {
    const uint32_t b = bar(s);
    if (static_cast<uint32_t>(nb) >= static_cast<uint32_t>(m)) {
      mbar_arrive(b);
      return;
    }
    const Window wv = window(vals + nb * K, K * sizeof(T));
    const Window wc = window(cols + nb * K, K * sizeof(C));
    if (wv.bytes + wc.bytes == 0) {
      mbar_arrive(b);
      return;
    }
    mbar_expect_tx(b, wv.bytes + wc.bytes);
    bulk_copy(stage_v(s), wv.a0, wv.bytes, b);
    bulk_copy(stage_v(s) + slot_v, wc.a0, wc.bytes, b);
  }
};

// 16 bytes of the output from 16 / sizeof(T) accumulator slots
__device__ __forceinline__ void store16(float* dst, const float* acc) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(acc);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // as torch's cast
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst,
                                        const float* acc) {
  const float4 lo = *reinterpret_cast<const float4*>(acc);
  const float4 hi = *reinterpret_cast<const float4*>(acc + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                 pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of the staged kernel's shared memory, as `staged_smem` in
// kernels/topk_gather.py lays it out: the stages' mbarriers; the f32
// accumulator (block_d + 4 slots: room to shift it to the output's 16-byte
// alignment); the claims (block_d int32: the last neighbor j that added to
// each column); the deferred duplicates (K column offsets, K products, and
// their count); the payload ring (stages x (slot_v + slot_c)); the
// neighbor row (k ids, k weights).
struct Layout {
  int stages, block_d, K, slot_v, slot_c;
  __device__ int acc() const { return round16(8 * stages); }
  __device__ int claim() const { return acc() + round16(4 * (block_d + 4)); }
  __device__ int dup_off() const { return claim() + round16(4 * block_d); }
  __device__ int dup_val() const { return dup_off() + round16(4 * K); }
  __device__ int dup_n() const { return dup_val() + round16(4 * K); }
  __device__ int ring() const { return dup_n() + 16; }
  __device__ int table() const { return ring() + stages * (slot_v + slot_c); }
};

template <typename T, typename C>
__global__ void __launch_bounds__(1024)
    topk_staged_kernel(const int32_t* __restrict__ idx,
                       const float* __restrict__ w,
                       const T* __restrict__ vals, const C* __restrict__ cols,
                       T* __restrict__ out, int m, int k, int64_t K,
                       int64_t d, int block_d, int stages, int slot_v,
                       int slot_c) {
  // named apart from the chunked kernel's float array
  extern __shared__ __align__(16) unsigned char staged_smem[];
  const Layout L{stages, block_d, static_cast<int>(K), slot_v, slot_c};
  float* acc_base = reinterpret_cast<float*>(staged_smem + L.acc());
  int* claim = reinterpret_cast<int*>(staged_smem + L.claim());
  int* dup_off = reinterpret_cast<int*>(staged_smem + L.dup_off());
  float* dup_val = reinterpret_cast<float*>(staged_smem + L.dup_val());
  int* dup_n = reinterpret_cast<int*>(staged_smem + L.dup_n());
  unsigned char* ring = staged_smem + L.ring();
  int32_t* s_idx = reinterpret_cast<int32_t*>(staged_smem + L.table());
  float* s_w = reinterpret_cast<float*>(s_idx + k);
  const Staged<T, C> st{vals, cols, m, K, smem_u32(staged_smem),
                        smem_u32(ring), slot_v, slot_c};
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t i = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * block_d;
  const int64_t width = (d - c0 < block_d) ? d - c0 : block_d;
  // the output chunk's first 16-byte boundary, `head` elements in; the
  // accumulator is shifted so that its slot `head` is 16-byte aligned too
  T* dst = out + i * d + c0;
  const int64_t to16 =
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T);
  const int64_t head = to16 < width ? to16 : width;
  float* acc = acc_base + ((4 - head % 4) % 4);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(st.bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *dup_n = 0;
  }
  for (int j = tid; j < k; j += nt) {
    s_idx[j] = idx[i * k + j];
    s_w[j] = w[i * k + j];
  }
  __syncthreads();
  for (int j = tid; j < k && j < stages; j += nt) st.issue(s_idx[j], j);
  for (int64_t c = tid; c < width; c += nt) {
    acc[c] = 0.0f;
    claim[c] = -1;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const int s = j % stages;
    mbar_wait(st.bar(s), (j / stages) & 1);
    const int32_t nb = s_idx[j];
    int deferred = 0;
    if (static_cast<uint32_t>(nb) >= static_cast<uint32_t>(m)) {
      // an out-of-range neighbor id: the gather's NaN fill
      for (int64_t c = tid; c < width; c += nt)
        acc[c] = __int_as_float(0x7fc00000);
    } else {
      const unsigned char* sv = ring + static_cast<size_t>(s) *
                                           (slot_v + slot_c);
      const T* v = reinterpret_cast<const T*>(
          sv + window(vals + nb * K, 1).offset);
      const C* cl = reinterpret_cast<const C*>(
          sv + slot_v + window(cols + nb * K, 1).offset);
      const float wj = s_w[j];
      for (int64_t p = tid; p < K; p += nt) {
        const int64_t off = static_cast<int64_t>(cl[p]) - c0;
        if (static_cast<uint64_t>(off) < static_cast<uint64_t>(width)) {
          const float prod = __fmul_rn(wj, to_f32(v[p]));
          // the first pair of neighbor j in a column adds in place; a
          // duplicate column of the same payload row is deferred
          if (atomicExch(&claim[off], j) != j) {
            acc[off] += prod;
          } else {
            const int q = atomicAdd(dup_n, 1);
            dup_off[q] = static_cast<int>(off);
            dup_val[q] = prod;
            deferred = 1;
          }
        }
      }
    }
    if (__syncthreads_or(deferred)) {       // block-uniform, and rare
      const int dups = *dup_n;
      for (int q = tid; q < dups; q += nt)
        atomicAdd(&acc[dup_off[q]], dup_val[q]);
      __syncthreads();
      if (tid == 0) *dup_n = 0;
      __syncthreads();
    }
    if (tid == 0 && j + stages < k) {
      // the stage's reads (generic proxy) before the copy's writes (async)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      st.issue(s_idx[j + stages], s);
    }
  }

  constexpr int V = 16 / sizeof(T);
  const int64_t nv = (width - head) / V;
  for (int64_t c = tid; c < head; c += nt) dst[c] = from_f32<T>(acc[c]);
  for (int64_t q = tid; q < nv; q += nt)
    store16(dst + head + q * V, acc + head + q * V);
  for (int64_t c = head + nv * V + tid; c < width; c += nt)
    dst[c] = from_f32<T>(acc[c]);
}

template <typename T, typename C>
int launch_staged(const void* idx, const void* w, const void* vals,
                  const void* cols, void* out, int m, int k, long long K,
                  long long d, int block_d, int stages, int slot_v,
                  int slot_c, int threads, int smem, void* stream) {
  if (m == 0 || d == 0) return 0;
  // the opt-in above 48 KB and the largest shared-memory carveout: once
  // per instantiation and device
  static uint64_t opted_in = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) dev = 63;
  if (!((opted_in >> dev) & 1)) {
    cudaError_t rc = cudaFuncSetAttribute(
        topk_staged_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(topk_staged_kernel<T, C>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted_in |= uint64_t{1} << dev;
  }
  dim3 grid(static_cast<unsigned>(m),
            static_cast<unsigned>((d + block_d - 1) / block_d));
  topk_staged_kernel<T, C><<<grid, threads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<const T*>(vals), static_cast<const C*>(cols),
      static_cast<T*>(out), m, k, static_cast<int64_t>(K),
      static_cast<int64_t>(d), block_d, stages, slot_v, slot_c);
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
  }                                                                         \
  int NAME##_staged(const void* idx, const void* w, const void* vals,       \
                    const void* cols, void* out, int m, int k, long long K, \
                    long long d, int block_d, int stages, int slot_v,       \
                    int slot_c, int threads, int smem, void* stream) {      \
    return launch_staged<T, C>(idx, w, vals, cols, out, m, k, K, d,         \
                               block_d, stages, slot_v, slot_c, threads,    \
                               smem, stream);                               \
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
