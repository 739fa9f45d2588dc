// Causal (optionally sliding-window) grouped-query attention, forward:
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
//
// over keys j <= i (and j > i - window when window > 0), hk = h / (H / Hkv).
// q, out: (B, S, H, hd); k, v: (B, S, Hkv, hd); f32 or bf16, contiguous;
// f32 arithmetic throughout (online softmax, masked logits -1e30,
// acc / max(l, 1e-30)), output rounded once to the input dtype.
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel), which asserts S % bq == 0;
// this kernel takes any S.
//
// Bound on an H100: operations.  4 * hd flops per (query, key) pair inside
// the causal band; at the hybrid model's prefill (B 2, S 4096, H 16,
// Hkv 1, hd 256, window 2048) that is 206 GFLOP against ~76 MB of
// inputs and output.  With every product in f32 outside the tensor cores
// (67 TFLOP/s) that is 3.1 ms; with Q K^T on bf16 tensor cores (exact
// products, f32 accumulate) and P V in f32 (P is f32 in the definition)
// about 1.6 ms.
//
// Design (simple and right first):
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
//   columns 2 tx + 32 c (+1), in registers.
// Q, K and V tiles of 64 rows at hd 256 exceed 48 KB, so the launch asks
// for dynamic shared memory with cudaFuncSetAttribute.  No wgmma, TMA or
// copy/compute overlap yet, and each of the H / Hkv query heads that
// share a K/V tile loads it again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
// copy two consecutive elements (zeros when `in` is false)
__device__ __forceinline__ void cp2(float* dst, const float* src, bool in) {
  *reinterpret_cast<float2*>(dst) =
      in ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
}
__device__ __forceinline__ void cp2(__nv_bfloat16* dst,
                                    const __nv_bfloat16* src, bool in) {
  *reinterpret_cast<uint32_t*>(dst) =
      in ? *reinterpret_cast<const uint32_t*>(src) : 0u;
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
  constexpr int NJ = HD / 32;        // column pairs per thread in P V
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
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, hd, window,
                                 scale, bq, bk, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
