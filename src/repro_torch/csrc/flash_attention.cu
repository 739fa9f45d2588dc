// Causal (optionally sliding-window) grouped-query attention, forward:
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
//
// over keys j <= i (and j > i - window when window > 0), hk = h / (H / Hkv).
// q, out: (B, S, H, hd); k, v: (B, S, Hkv, hd); f32 or bf16, contiguous;
// hd in {32, 64, 80, 128, 256}, any S.  Masked logits -1e30, online softmax,
// acc / max(l, 1e-30), output rounded once to the input dtype.  Replaces
// the Pallas TPU kernel repro/kernels/flash_attention.py:76 (_flash_kernel,
// launched by flash_attention_pallas), which asserts S % bq == 0.
//
// Bound on an H100: operations.  4 * hd flops per (query, key) pair inside
// the causal band; at the hybrid model's prefill (B 2, S 4096, H 16,
// Hkv 1, hd 256, window 2048) that is 206.2 GFLOP against 142.6 MB moved
// (q, k and v 75.5 MB read, the output 67.1 MB written): 0.2085 ms with
// both products at the 989 TFLOP/s bf16 tensor-core peak, 0.043 ms of
// bytes at 3.35 TB/s.
//
// Two kernels, one per route:
//
// bf16 (the model's prefill): flash_attention_wgmma_kernel, built for
// Hopper's tensor cores (sm_90a).
// - The g = H / Hkv query heads of one KV head at one position are g
//   consecutive rows of hd, so a CTA owns 128 rows of the folded
//   (position, head) matrix: hb = min(g, 128) heads times P = 128 / hb
//   positions (row r is position q0 + r / hb, head r % hb of its chunk of
//   the group).  Each K/V tile then feeds 128 query rows, and the 16 heads
//   of the model's MQA group read it once instead of 16 times.  The
//   causal/window mask works on the row's position; the k-tile loop covers
//   the union of the rows' bands (the loop bound skips the others, as the
//   TPU kernel's index map does).
// - Warp specialization, 384 threads: warpgroup 0 is the producer, one
//   thread of which issues TMA loads (Q once, then K and V tiles of 64
//   keys) into a ring of 2 stages; warpgroups 1 and 2 are consumers, each
//   owning 64 of the 128 rows.  mbarriers: K and V of a stage each have a
//   "full" barrier (TMA bytes landed) and an "empty" one (the 8 consumer
//   warps are done), so a K tile is reloaded as soon as Q K^T has read it
//   and a V tile once P V has.  At hd 256 setmaxnreg gives the consumers
//   240 registers and the producer 24.  Shared memory at hd 256: Q 64 KB
//   + 2 x (K 32 KB + V 32 KB) = 192 KB.
// - TMA boxes are 64 bf16 (128 bytes) wide with the 128-byte swizzle (32
//   bf16 and the 64-byte swizzle at hd 32), so an hd-256 row is 4 boxes;
//   the wgmma descriptors use the same swizzle.  Rows and keys past S,
//   and heads past g, are zero-filled by TMA on load and clipped by the
//   TMA store.
// - hd 80 (h2o-danube) is no multiple of the 64-wide box: the tiles are
//   laid out 128 wide (two boxes) while the tensor maps keep the real 80
//   as their innermost extent (rows of 160 bytes, a multiple of 16).  TMA
//   zero-fills columns 80-127 of Q, K and V on load (the transaction
//   counts whole boxes, the filled bytes included) and the store clips
//   them.  Q K^T runs its k-steps over the 80 real columns only; P V
//   runs both boxes, and its columns 80-127 are P times zeros, never
//   stored.
// - When hb does not divide 128 (g 7: hb 7, P 18, 126 live rows), the Q
//   box fills the first hb * P rows of the tile.  The idle rows past it
//   hold whatever shared memory held; each row's scores, softmax and
//   P V use that row alone (the row max and sum reduce over the 4
//   threads of the row), and the TMA store's box ends at the last live
//   row, so nothing of the idle rows reaches a live row or the output.
// - S = Q K^T on wgmma m64n64k16 (bf16 x bf16, f32 accumulate): the
//   products of bf16 values are exact in f32, so only the sum order
//   differs from the plain version.
// - Online softmax in the consumers' registers (row max and sum reduced
//   over the 4 threads of a row by shuffles), with log2(e) folded into
//   the scale and ex2.approx; a k-tile inside the band of every row of
//   the CTA skips the mask.
// - P V on wgmma too, A from registers (the S accumulator's fragment is
//   the A operand's layout), B = V read MN-major through the transpose
//   bit.  P is f32 by definition, so it is split: P_hi = bf16(P),
//   P_lo = bf16(P - P_hi), O += P_hi V + P_lo V keeps P to about 2^-16
//   relative (1.5x the tensor-core work of one bf16 P, 309 GFLOP at the
//   model's shape).
// - Overlap: k-tile i issues S_i and P_{i-1} V_{i-1} together and runs
//   the softmax of S_i under P_{i-1} V_{i-1}; the two consumer warpgroups
//   take turns to issue (named barriers), so one's softmax runs under the
//   other's products.
// - Epilogue: acc / max(l, 1e-30) rounded once to bf16 into the CTA's Q
//   tile in shared memory (swizzled as the TMA expects), then one TMA
//   store per box.
//
// f32 (card-vs-CPU parity runs): flash_attention_kernel, f32 SIMT FMAs.
// - one block of 256 threads per (b, h, q-tile of bq rows), the heaviest
//   (latest) q-tiles launched first;
// - a loop over only the k-tiles that hold a key of the causal and window
//   band of the q-tile, as the TPU kernel's index map skips the others;
//   a partly masked tile is masked element by element;
// - the Q tile is staged in shared memory as f32, the K and V tiles in
//   their own dtype (converted to f32 at use), rows padded so that the
//   threads of a warp read distinct banks;
// - thread (ty, tx) of a 16 x 16 grid holds the scores of rows ty + 16 i
//   and keys tx + 16 j (f32 FMAs over hd), the row max and sum reduced
//   over the 16 lanes of the row by shuffles; P goes through shared
//   memory, and the same thread accumulates rows ty + 16 i of P V in
//   columns 2 tx + 32 c (+1), in registers.  At hd 80 the last group of
//   32 columns holds 16: only threads tx < 8 own a pair there.
// Q, K and V tiles of 64 rows at hd 256 exceed 48 KB, so the launch asks
// for dynamic shared memory with cudaFuncSetAttribute.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TY = 16;
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int MAX_RI = 4;            // bq <= 64
constexpr int MAX_CJ = 4;            // bk <= 64
constexpr float NEG = -1e30f;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
// copy two consecutive elements (zeros when `in` is false)
__device__ __forceinline__ void cp2(float* dst, const float* src, bool in) {
  *reinterpret_cast<float2*>(dst) =
      in ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
}

template <typename T, int HD>
struct Layout {
  static constexpr int QST = HD + 2;                        // f32 Q rows
  static constexpr int KST = HD + (sizeof(T) == 4 ? 2 : 4);  // K rows
  static constexpr int VST = HD;                            // V rows
  static size_t bytes(int bq, int bk) {
    return static_cast<size_t>(bq) * QST * sizeof(float) +
           static_cast<size_t>(bk) * (KST + VST) * sizeof(T) +
           static_cast<size_t>(bq) * (bk + 1) * sizeof(float);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int H, int Hkv, int window, float scale,
                           int bq, int bk) {
  using L = Layout<T, HD>;
  // column pairs per thread in P V: groups of 32 columns, the last one
  // TAIL wide (32, or 16 at hd 80), where threads tx < TAIL / 2 own a pair
  constexpr int NJ = (HD + 31) / 32;
  constexpr int TAIL = HD - 32 * (NJ - 1);
  static_assert(HD % 16 == 0 && TAIL % 16 == 0 && TAIL > 0 && TAIL <= 32 &&
                    32 * (NJ - 1) + TAIL == HD,
                "the P V column split must cover hd exactly");
  constexpr int HALF = HD / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + bq * L::QST);
  T* Vs = Ks + bk * L::KST;
  float* Ps = reinterpret_cast<float*>(Vs + bk * L::VST);
  const int PST = bk + 1;

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int ri = bq / TY;
  const int cj = bk / TX;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = qt * bq;
  // does this thread own a column pair in group cc of P V
  auto owns = [tx](int cc) {
    return TAIL == 32 || cc < NJ - 1 || 2 * tx < TAIL;
  };

  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(Hkv) * HD;
  const int64_t bS = static_cast<int64_t>(blockIdx.z) * S;
  const T* qb = q + bS * qrow + static_cast<int64_t>(h) * HD;
  const T* kb = k + bS * krow + static_cast<int64_t>(hk) * HD;
  const T* vb = v + bS * krow + static_cast<int64_t>(hk) * HD;
  T* ob = out + bS * qrow + static_cast<int64_t>(h) * HD;

  for (int e = tid; e < bq * HALF; e += THREADS) {
    const int r = e / HALF;
    const int c = (e % HALF) * 2;
    const int qp = q0 + r;
    const float2 x = qp < S ? ld2(qb + qp * qrow + c) : make_float2(0.f, 0.f);
    st2(Qs + r * L::QST + c, x.x, x.y);
  }

  float m[MAX_RI], l[MAX_RI], acc[MAX_RI][NJ][2];
#pragma unroll
  for (int i = 0; i < MAX_RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c][0] = acc[i][c][1] = 0.f;
  }

  const int q_last = min(q0 + bq, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_first / bk; kt <= q_last / bk; ++kt) {
    const int k0 = kt * bk;
    __syncthreads();                 // the last tile's readers are done
    for (int e = tid; e < bk * HALF; e += THREADS) {
      const int r = e / HALF;
      const int c = (e % HALF) * 2;
      const int kp = k0 + r;
      const bool in = kp < S;
      const int64_t off = in ? kp * krow + c : 0;
      cp2(Ks + r * L::KST + c, kb + off, in);
      cp2(Vs + r * L::VST + c, vb + off, in);
    }
    __syncthreads();

    float s[MAX_RI][MAX_CJ];
#pragma unroll
    for (int i = 0; i < MAX_RI; ++i)
#pragma unroll
      for (int j = 0; j < MAX_CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[MAX_RI], kv[MAX_CJ];
#pragma unroll
      for (int i = 0; i < MAX_RI; ++i)
        if (i < ri) qv[i] = ld2(Qs + (ty + TY * i) * L::QST + d);
#pragma unroll
      for (int j = 0; j < MAX_CJ; ++j)
        if (j < cj) kv[j] = ld2(Ks + (tx + TX * j) * L::KST + d);
#pragma unroll
      for (int i = 0; i < MAX_RI; ++i)
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j)
          if (i < ri && j < cj) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          }
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < MAX_RI; ++i) {
      if (i >= ri) break;
      const int qp = q0 + ty + TY * i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < MAX_CJ; ++j) {
        if (j < cj) {
          const int kp = k0 + tx + TX * j;
          const bool ok = kp <= qp && kp < S && (window <= 0 ||
                                                 kp > qp - window);
          s[i][j] = ok ? s[i][j] * scale : NEG;
          mt = fmaxf(mt, s[i][j]);
        }
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CJ; ++j) {
        if (j < cj) {
          const float p = expf(s[i][j] - m_new);
          Ps[(ty + TY * i) * PST + tx + TX * j] = p;
          rs += p;
        }
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        acc[i][c][0] *= alpha;
        acc[i][c][1] *= alpha;
      }
    }
    __syncthreads();

    for (int c = 0; c < bk; ++c) {
      float p[MAX_RI];
#pragma unroll
      for (int i = 0; i < MAX_RI; ++i)
        p[i] = i < ri ? Ps[(ty + TY * i) * PST + c] : 0.f;
#pragma unroll
      for (int cc = 0; cc < NJ; ++cc) {
        if (!owns(cc)) continue;
        const float2 vv = ld2(Vs + c * L::VST + 2 * tx + 32 * cc);
#pragma unroll
        for (int i = 0; i < MAX_RI; ++i) {
          if (i < ri) {
            acc[i][cc][0] = fmaf(p[i], vv.x, acc[i][cc][0]);
            acc[i][cc][1] = fmaf(p[i], vv.y, acc[i][cc][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_RI; ++i) {
    const int qp = q0 + ty + TY * i;
    if (i < ri && qp < S) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NJ; ++c)
        if (owns(c))
          st2(ob + qp * qrow + 2 * tx + 32 * c, acc[i][c][0] / den,
              acc[i][c][1] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int window, float scale, int bq, int bk,
           void* stream) {
  const size_t smem = Layout<T, HD>::bytes(bq, bk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((S + bq - 1) / bq),
            static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<T, HD>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, window,
          scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int Hkv, int hd, int window, float scale, int bq,
             int bk, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bq % TY || bq < TY || bq > TY * MAX_RI || bk % TX || bk < TX ||
      bk > TX * MAX_CJ || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, H, Hkv, window, scale, bq, bk,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, Hkv, window, scale, bq, bk,
                           stream);
    case 80:
      return launch<T, 80>(q, k, v, out, B, S, H, Hkv, window, scale, bq, bk,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, Hkv, window, scale, bq,
                            bk, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, H, Hkv, window, scale, bq,
                            bk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA, warp-specialized
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;          // folded query rows per CTA
constexpr int BN = 64;           // keys per k-tile
constexpr int STAGES = 2;        // K/V ring
constexpr int THREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int SWB = HD >= 64 ? 128 : 64;    // swizzle = box row bytes
  static constexpr int EB = SWB / 2;                 // bf16 per box row
  static constexpr int NB = (HD + EB - 1) / EB;      // boxes across hd
  static constexpr int HDP = NB * EB;                // tile width (hd padded)
  static constexpr int NACC = EB / 2;                // f32 accumulators a box
  static constexpr int QBOX = BM * SWB;              // bytes of one Q box
  static constexpr int KBOX = BN * SWB;              // bytes of one K/V box
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int KV_BYTES = BN * HDP * 2;      // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  // + 1024 of slack to align the tiles to the swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  static_assert(BAR_BYTES <= 128, "barriers");
  // the boxes cover hd exactly once, padded by less than one box; Q K^T's
  // k-steps of 16 cover the real hd
  static_assert(HD % 16 == 0 && NB * EB == HDP && HDP >= HD &&
                    HDP - HD < EB && Q_BYTES == NB * QBOX &&
                    KV_BYTES == NB * KBOX,
                "the TMA boxes and wgmma steps must cover hd exactly");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------
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

// --- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* tm,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(tm)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swb) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swb == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
// async wgmma uses across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 16, smem) B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, registers) B (16 x N, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef D8

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset inside a box of SWB-byte rows, as the TMA swizzle lays it
template <int SWB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SWB / 16 - 1)) << 4);
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp; 2^-1e30 = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S (64 x 64 keys) = Q (this warpgroup's 64 rows) K^T over the real hd
// (a padded tile's zero columns add nothing)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q,
                                         uint32_t k) {
  using C = Cfg<HD>;
  // K-major under a swizzle: the leading byte offset is unused, the stride
  // one spans 8 rows.  A descriptor's address field is its low bits: step
  // it by offset >> 4.
  const uint64_t dq = smem_desc(q, 16, 8 * C::SWB, C::SWB);
  const uint64_t dk = smem_desc(k, 16, 8 * C::SWB, C::SWB);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 % C::EB) * 2;
    const uint32_t col = kk * 16 / C::EB;
    wgmma_ss_n64(sc, dq + ((col * C::QBOX + off) >> 4),
                 dk + ((col * C::KBOX + off) >> 4), kk > 0);
  }
}

// O += P_hi V + P_lo V, V MN-major, one box (EB columns of the tile) per
// wgmma
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[Cfg<HD>::NB][Cfg<HD>::NACC], const uint32_t (&phi)[16],
    const uint32_t (&plo)[16], uint32_t v) {
  using C = Cfg<HD>;
  // MN-major: one swizzle atom of hd per instruction, so the leading (next
  // atom of hd) and stride (next 8 keys) byte offsets are both 8 rows
  const uint64_t d0 = smem_desc(v, 8 * C::SWB, 8 * C::SWB, C::SWB);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      const uint64_t dv = d0 + ((j * C::KBOX + kk * 16 * C::SWB) >> 4);
      wgmma_rs(o[j], phi + 4 * kk, dv);
      wgmma_rs(o[j], plo + 4 * kk, dv);
    }
}

// Mask the tile of keys k0 .. k0 + 63 for rows at positions pos0 (pos1),
// scale into the log2 domain and run the online softmax: sc becomes
// P = exp2(s - m_new), (m, l) are updated, alpha = exp2(m_old - m_new).
struct Rows {
  float m0, m1, l0, l1;
};
__device__ __forceinline__ void softmax_tile(float (&sc)[32], Rows& r,
                                             float& alpha0, float& alpha1,
                                             int k0, int S, int pos0,
                                             int pos1, int window,
                                             float scale_log2, int quad,
                                             bool inside) {
  float mt0 = NEG, mt1 = NEG;
  if (inside) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * c + e] *= scale_log2;
        sc[4 * c + 2 + e] *= scale_log2;
        mt0 = fmaxf(mt0, sc[4 * c + e]);
        mt1 = fmaxf(mt1, sc[4 * c + 2 + e]);
      }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * c + 2 * quad + e;
        const bool in = kp < S;
        const bool ok0 = in && kp <= pos0 && (window <= 0 ||
                                              kp > pos0 - window);
        const bool ok1 = in && kp <= pos1 && (window <= 0 ||
                                              kp > pos1 - window);
        sc[4 * c + e] = ok0 ? sc[4 * c + e] * scale_log2 : NEG;
        sc[4 * c + 2 + e] = ok1 ? sc[4 * c + 2 + e] * scale_log2 : NEG;
        mt0 = fmaxf(mt0, sc[4 * c + e]);
        mt1 = fmaxf(mt1, sc[4 * c + 2 + e]);
      }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
  }
  const float mn0 = fmaxf(r.m0, mt0), mn1 = fmaxf(r.m1, mt1);
  alpha0 = ex2(r.m0 - mn0);
  alpha1 = ex2(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * c + e] = ex2(sc[4 * c + e] - mn0);
      sc[4 * c + 2 + e] = ex2(sc[4 * c + 2 + e] - mn1);
      rs0 += sc[4 * c + e];
      rs1 += sc[4 * c + 2 + e];
    }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  r.l0 = alpha0 * r.l0 + rs0;
  r.l1 = alpha1 * r.l1 + rs1;
}

// P = P_hi + P_lo in bf16 pairs: the accumulator's fragment of keys
// 16 kk .. 16 kk + 15 is the A operand of step kk as it lies
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&phi)[16],
                                        uint32_t (&plo)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float x = sc[2 * e], y = sc[2 * e + 1];
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    phi[e] = *reinterpret_cast<uint32_t*>(&h);
    plo[e] = bf16x2(x - hf.x, y - hf.y);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_o,
                                 int S, int B, int groups, int chunks, int hb,
                                 int P, int n_qt, int window,
                                 float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t bars = sV + STAGES * C::KV_BYTES;
  unsigned char* gQ = tc_smem + (sQ - raw);
  // mbarriers: q_full, then per stage K and V full (TMA bytes landed) and
  // empty (the 8 consumer warps are done with it).  K and V are released
  // apart: K after S = Q K^T, V after P V, one k-tile later.
  const uint32_t q_full = bars;
  auto k_full = [=](int s) { return bars + 8 * (1 + s); };
  auto v_full = [=](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_empty = [=](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [=](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

  // block -> (q-tile, batch, kv head, head chunk); the heaviest (latest)
  // q-tiles of every (batch, head) first
  const int per_qt = B * groups;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per_qt);
  const int rem = static_cast<int>(blockIdx.x % per_qt);
  const int b = rem / groups;
  const int hk = (rem % groups) / chunks;
  const int ch = (rem % groups) % chunks;
  const int q0 = qt * P;
  const int q_last = min(q0 + P, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_first / BN;
  const int n_kt = q_last / BN - kt0 + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);        // 8 consumer warps
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    if constexpr (HD == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, C::NB * hb * P * C::SWB);
#pragma unroll
      for (int c = 0; c < C::NB; ++c)
        tma_load_5d(sQ + c * C::QBOX, &tm_q, q_full, c * C::EB, ch * hb, hk,
                    q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        const int k0 = (kt0 + i) * BN;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(sK + s * C::KV_BYTES + c * C::KBOX, &tm_k, k_full(s),
                      c * C::EB, hk, k0, b);
        mbar_wait(v_empty(s), ph ^ 1);
        const uint32_t vf = v_full(s);
        mbar_expect_tx(vf, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(sV + s * C::KV_BYTES + c * C::KBOX, &tm_v, vf,
                      c * C::EB, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows 64 w .. 64 w + 63 ----
    if constexpr (HD == 256)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = tid / 128 - 1;
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    const int r0 = w * 64 + (t / 32) * 16 + lane / 4;     // and r0 + 8
    const int pos0 = q0 + r0 / hb;
    const int pos1 = q0 + (r0 + 8) / hb;
    const uint32_t sQw = sQ + w * 64 * C::SWB;     // this warpgroup's rows
    // a k-tile whose every key lies in the band of every position of the
    // CTA needs no mask
    auto inside = [=](int k0) {
      return k0 + BN - 1 <= q0 && k0 + BN <= S &&
             (window <= 0 || k0 > q_last - window);
    };

    float o[C::NB][C::NACC];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) o[j][i] = 0.f;
    Rows rows{NEG, NEG, 0.f, 0.f};
    float sc[32], alpha0, alpha1;
    uint32_t phi[16], plo[16];

    // k-tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk<HD>(sc, sQw, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile(sc, rows, alpha0, alpha1, kt0 * BN, S, pos0, pos1, window,
                 scale_log2, quad, inside(kt0 * BN));
    split_p(sc, phi, plo);

    // k-tile i issues S_i and then P_{i-1} V_{i-1} in one go, between a
    // bar.sync on this warpgroup's barrier and a bar.arrive on the other's,
    // so the two warpgroups' products alternate on the tensor cores; the
    // softmax of S_i runs under P_{i-1} V_{i-1}.  Warpgroup 0 goes first.
    if (w == 1 && n_kt > 1) named_arrive(2);
    for (int i = 1; i < n_kt; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      mbar_wait(k_full(s), (i / STAGES) & 1);
      mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
      named_sync(2 + w);
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_regs(o[j]);
      fence_regs(phi);
      fence_regs(plo);
      wgmma_fence();
      issue_qk<HD>(sc, sQw, sK + s * C::KV_BYTES);
      wgmma_commit();
      issue_pv<HD>(o, phi, plo, sV + sp * C::KV_BYTES);
      wgmma_commit();
      if (w == 0 || i < n_kt - 1) named_arrive(3 - w);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));
      softmax_tile(sc, rows, alpha0, alpha1, (kt0 + i) * BN, S, pos0, pos1,
                   window, scale_log2, quad, inside((kt0 + i) * BN));
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_regs(o[j]);
      fence_regs(phi);
      fence_regs(plo);
      if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int j = 0; j < C::NB; ++j)
#pragma unroll
        for (int c = 0; c < C::NACC / 4; ++c) {
          o[j][4 * c] *= alpha0;
          o[j][4 * c + 1] *= alpha0;
          o[j][4 * c + 2] *= alpha1;
          o[j][4 * c + 3] *= alpha1;
        }
      split_p(sc, phi, plo);
    }
    // the last k-tile's P V
    {
      const int sl = (n_kt - 1) % STAGES;
      mbar_wait(v_full(sl), ((n_kt - 1) / STAGES) & 1);
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_regs(o[j]);
      fence_regs(phi);
      fence_regs(plo);
      wgmma_fence();
      issue_pv<HD>(o, phi, plo, sV + sl * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < C::NB; ++j) fence_regs(o[j]);
      if (lane == 0) mbar_arrive(v_empty(sl));
    }

    // epilogue: acc / max(l, 1e-30) in bf16 over this warpgroup's own rows
    // of the Q tile, swizzled as the TMA store reads it
    const float d0 = fmaxf(rows.l0, 1e-30f), d1 = fmaxf(rows.l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int c = 0; c < C::NACC / 4; ++c) {
        const uint32_t off0 = r0 * C::SWB + c * 16 + quad * 4;
        const uint32_t off1 = off0 + 8 * C::SWB;
        *reinterpret_cast<uint32_t*>(gQ + j * C::QBOX +
                                     swizzle<C::SWB>(off0)) =
            bf16x2(o[j][4 * c] / d0, o[j][4 * c + 1] / d0);
        *reinterpret_cast<uint32_t*>(gQ + j * C::QBOX +
                                     swizzle<C::SWB>(off1)) =
            bf16x2(o[j][4 * c + 2] / d1, o[j][4 * c + 3] / d1);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1);
    if (tid == 128) {
#pragma unroll
      for (int c = 0; c < C::NB; ++c)
        tma_store_5d(&tm_o, sQ + c * C::QBOX, c * C::EB, ch * hb, hk, q0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: reached through the runtime's
// driver entry point, so the library links against cudart alone
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &qr);
#endif
    if (err == cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over `rank` dims (innermost first, dense strides) with
// a box of `box` elements, zero fill out of bounds.
bool make_map(EncodeTiled enc, CUtensorMap* tm, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box, int swb) {
  cuuint64_t strides[4];
  cuuint64_t st = 2;
  for (int i = 0; i < rank - 1; ++i) {
    st *= dims[i];
    strides[i] = st;
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(
      tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled failed (%d)\n",
            static_cast<int>(r));
    return false;
  }
  return true;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int window, float scale, void* stream) {
  using C = Cfg<HD>;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int g = H / Hkv;
  const int hb = g < BM ? g : BM;
  const int chunks = (g + hb - 1) / hb;
  const int P = BM / hb;
  const int n_qt = (S + P - 1) / P;
  const int64_t blocks = static_cast<int64_t>(n_qt) * B * Hkv * chunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t qdims[5] = {static_cast<cuuint64_t>(HD),
                               static_cast<cuuint64_t>(g),
                               static_cast<cuuint64_t>(Hkv),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t qbox[5] = {C::EB, static_cast<cuuint32_t>(hb), 1,
                              static_cast<cuuint32_t>(P), 1};
  const cuuint64_t kdims[4] = {static_cast<cuuint64_t>(HD),
                               static_cast<cuuint64_t>(Hkv),
                               static_cast<cuuint64_t>(S),
                               static_cast<cuuint64_t>(B)};
  const cuuint32_t kbox[4] = {C::EB, 1, BN, 1};
  if (!make_map(enc, &tq, q, 5, qdims, qbox, C::SWB) ||
      !make_map(enc, &to, out, 5, qdims, qbox, C::SWB) ||
      !make_map(enc, &tk, k, 4, kdims, kbox, C::SWB) ||
      !make_map(enc, &tv, v, 4, kdims, kbox, C::SWB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_wgmma_kernel<HD>
      <<<static_cast<unsigned>(blocks), THREADS, C::SMEM,
         static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, to, S, B,
                                              Hkv * chunks, chunks, hb, P,
                                              n_qt, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int Hkv, int hd, int window, float scale, int bq,
             int bk, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bq != BM || bk != BN || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, B, S, H, Hkv, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, Hkv, window, scale, stream);
    case 80:
      return launch<80>(q, k, v, out, B, S, H, Hkv, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, Hkv, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, out, B, S, H, Hkv, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int Hkv, int hd,
                        int window, float scale, int bq, int bk,
                        void* stream) {
  return dispatch<float>(q, k, v, out, B, S, H, Hkv, hd, window, scale, bq,
                         bk, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int H, int Hkv, int hd,
                         int window, float scale, int bq, int bk,
                         void* stream) {
  return tc::dispatch(q, k, v, out, B, S, H, Hkv, hd, window, scale, bq, bk,
                      stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
