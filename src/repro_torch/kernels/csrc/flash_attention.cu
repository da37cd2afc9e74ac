// Hand-written forward attention kernel on the CUDA cores, and the entry
// point of B5:
//
//   attn_flash_forward  replaces the Pallas kernel
//                       src/repro/kernels/flash_attention.py::flash_attention
//                       (body _flash_kernel)
//
// attn_flash_forward launches one of two designs, chosen by the wrapper
// (kernels/flash_attention.py::design) and passed in: design 1, the Hopper
// kernel of csrc/flash_attention_sm90.cu (wgmma, TMA, warp specialisation),
// for every bfloat16 call with D in {64, 80, 96, 128} (80, qwen3-32b's head
// dim, and 96, minicpm3-4b's MLA head dim 64 + 32, through a tail panel of
// 16 / 32 columns); design 0, the kernel below, for float32 at every D
// (wgmma on float32 is TF32, which would miss the float32 tolerance) and
// for bfloat16 at D in {16, 32}.  Its bfloat16 D 80 / 96 variants stay
// built (D / 16 = 5 and 6 accumulator columns a thread, like any multiple
// of 16): the wrapper never routes to them, and chip_smoke.py times them
// beside design 1 by the design id.  A head dim that is no multiple of 16
// (12, minicpm3-4b's smoke config) reaches this kernel zero-padded to the
// next multiple by the wrapper, which passes the scale of the real D.
//
// What both compute (equal to _flash_kernel up to the order of f32 sums):
// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), f32 or bf16; query
// head h reads KV head h / (Hq / Hkv) (GQA).  Scores s = (q . k) * scale in
// f32; with CAUSAL, key c is visible to query r iff c <= r + (Lk - Lq) and a
// hidden score is -1e30, as on the TPU.  A running max m, running sum l and
// f32 accumulator acc are updated key tile by key tile (online softmax):
// p = exp(s - m_new), alpha = exp(m - m_new), l = l * alpha + sum(p),
// acc = acc * alpha + p' . v, where p' is p rounded to the input type, as the
// TPU kernel casts p to v's type before its P.V product (l sums the f32 p).
// The output is acc / max(l, 1e-30), rounded once to the input type.
//
// Any Lq, Lk >= 1 runs: the kernels mask their own ragged tiles.  A query row
// past Lq is computed on zeros and never stored; a key past Lk gets no weight
// at all (its score is -inf, so p = 0 exactly and the max is unaffected), the
// same result as the TPU kernel, which admits only Lk that its tile divides.
// The wrapper refuses causal with Lk < Lq (rows whose every key is hidden).
//
// What bounds it on the card.  At prefill shapes it is operations, not
// bytes: 2 * Lq * Lk * D multiply-adds per head for q.k and as many for p.v,
// 4 * B * Hq * Lq * Lk * D FLOPs in all, about halved when causal, against
// B * (Hq * Lq + 2 * Hkv * Lk) * D elements read and B * Hq * Lq * D written
// (at L = 2048, Hq = 16, D = 128: 4.4e10 causal FLOPs on 25 MB).  The card's
// bound for that work is its bf16 tensor-core rate (989 TFLOP/s dense).
//
// The design below (design 0) is the simple one, and leaves most of that
// rate on the table:
//  * one block of 256 threads per (query tile of kBQ = 64 rows, head, batch);
//    KV head h / G is read by each of the G query heads' blocks;
//  * the block stages its query tile once and each key / value tile of
//    kBK = 64 rows into shared memory, converted to f32 (rows padded by one
//    word against bank conflicts), with plain per-element loads;
//  * scores and p . v are f32 FMAs on the CUDA cores (a 16 x 16 thread grid,
//    4 x 4 scores and 4 x D/16 accumulators per thread, read from shared
//    memory): about 1/15 of the tensor cores' rate at best, and the shared
//    memory reads, not the FMAs, set the pace;
//  * the running max / sum live in shared memory, four threads per row;
//  * key tiles wholly above the causal diagonal of the block's last row are
//    not visited (they would add p = 0 with alpha = 1: the same result).
// It reads contiguous inputs (the wrapper copies a strided view first).
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kPP = kBK + 1;   // padded row of the score / p tile
constexpr float kMasked = -1e30f;   // the TPU kernel's hidden score

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

template <int D>
constexpr size_t smem_floats() {
  // sQ, sK (padded rows), sV, sP (padded rows), m / l / alpha per row
  return static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1)
         + static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kPP
         + 3 * kBQ;
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
          int Lq, int Lk, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;             // accumulator columns per thread
  float* sQ = smem;                      // kBQ x DP
  float* sK = sQ + kBQ * DP;             // kBK x DP
  float* sV = sK + kBK * DP;             // kBK x D
  float* sP = sV + kBK * D;              // kBQ x kPP: scores, then p'
  float* sM = sP + kBQ * kPP;            // running max
  float* sL = sM + kBQ;                  // running sum
  float* sA = sL + kBQ;                  // this tile's alpha

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long qbase = (static_cast<long long>(b) * Hq + h) * Lq * D;
  const long long kbase = (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = Lk - Lq;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, qr = q0 + r;
    sQ[r * DP + c] = qr < Lq ? to_f(q[qbase + static_cast<long long>(qr) * D + c])
                             : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kMasked;
    sL[tid] = 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  // the keys any row of this block can see
  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int k_end = CAUSAL ? min(Lk, q_last + off + 1) : Lk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's sK / sV / sP reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, kr = k0 + r;
      const bool ok = kr < Lk;
      const long long at = kbase + static_cast<long long>(kr) * D + c;
      sK[r * DP + c] = ok ? to_f(k[at]) : 0.f;
      sV[r * D + c] = ok ? to_f(v[at]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kc = k0 + c;
        float x = s[i][j] * scale;
        if (kc >= Lk) {
          x = -INFINITY;                 // a padding key: no weight at all
        } else if (CAUSAL && kc > q0 + r + off) {
          x = kMasked;
        }
        sP[r * kPP + c] = x;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sP + r * kPP + part * 16;
      const float m_old = sM[r];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = to_f(from_f<T>(p));     // p' = p in the input type
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();                      // every lane has read sM[r]
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p' . v for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();   // the last tile's sL writes

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qr = q0 + r;
    if (qr >= Lq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[qbase + static_cast<long long>(qr) * D + tx + 16 * j] =
          from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Lq, int Lk, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd<T, D, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Lq, Lk, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_causal(int causal, const void* q, const void* k, const void* v,
                      void* out, int B, int Hq, int Hkv, int Lq, int Lk,
                      float scale, cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                                     stream)
                : launch<T, D, false>(q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                                      stream);
}

// WIDE: D 64 and 128 too (float32 only: bfloat16 there is design 1's;
// bfloat16 D 80 / 96 are design 1's too, built here for comparisons)
template <typename T, bool WIDE>
cudaError_t by_dim(int D, int causal, const void* q, const void* k,
                   const void* v, void* out, int B, int Hq, int Hkv, int Lq,
                   int Lk, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return by_causal<T, 16>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                              stream);
    case 32:
      return by_causal<T, 32>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                              stream);
    case 80:
      return by_causal<T, 80>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                              stream);
    case 96:
      return by_causal<T, 96>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk, scale,
                              stream);
    default:
      break;
  }
  if constexpr (WIDE) {
    switch (D) {
      case 64:
        return by_causal<T, 64>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk,
                                scale, stream);
      case 128:
        return by_causal<T, 128>(causal, q, k, v, out, B, Hq, Hkv, Lq, Lk,
                                 scale, stream);
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The Hopper design (csrc/flash_attention_sm90.cu).
extern "C" int attn_flash_sm90(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int causal, long long q_sb,
                               long long q_sh, long long q_sl,
                               long long k_sb, long long k_sh, long long k_sl,
                               long long v_sb, long long v_sh, long long v_sl,
                               float scale, cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = the kernel above (float32
// at D in {16, 32, 64, 80, 96, 128}, bfloat16 at D in {16, 32, 80, 96};
// contiguous q, k, v),
// 1 = the Hopper kernel (bfloat16, D in {64, 80, 96, 128}, any strides the
// wrapper admits): one kernel per (dtype, D).  Strides are in elements, (batch,
// head, row) for q, k and v, the last dimension contiguous; out is
// contiguous.  Hkv divides Hq; B, Hq <= 65535; Lq, Lk >= 1 (the wrapper
// checks all of it).
extern "C" int attn_flash_forward(const void* q, const void* k, const void* v,
                                  void* out, int B, int Hq, int Hkv, int Lq,
                                  int Lk, int D, int causal, int dtype,
                                  int design, long long q_sb,
                                  long long q_sh, long long q_sl,
                                  long long k_sb, long long k_sh,
                                  long long k_sl, long long v_sb,
                                  long long v_sh, long long v_sl, float scale,
                                  void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Lq < 1 || Lk < 1 ||
      B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return attn_flash_sm90(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal,
                           q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh,
                           v_sl, scale, st);
  }
  const long long lq = Lq, lk = Lk;
  if (design != 0 || q_sl != D || q_sh != lq * D || q_sb != Hq * lq * D ||
      k_sl != D || k_sh != lk * D || k_sb != Hkv * lk * D || v_sl != D ||
      v_sh != lk * D || v_sb != Hkv * lk * D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = by_dim<float, true>(D, causal, q, k, v, out, B, Hq, Hkv, Lq, Lk,
                              scale, st);
      break;
    case 1:
      e = by_dim<__nv_bfloat16, false>(D, causal, q, k, v, out, B, Hq, Hkv,
                                       Lq, Lk, scale, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
