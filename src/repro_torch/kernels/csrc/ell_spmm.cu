// Hand-written Hopper (sm_90a) ELL neighbour-aggregation kernel:
//
//   ell_spmm  replaces the Pallas kernel
//             src/repro/kernels/ell_spmm.py::ell_spmm (body _ell_spmm_kernel)
//
// What it computes: for each row v of an (R, W) row-major int32 ELL table
// and an (n, d) row-major feature table (f32 or bf16),
//
//   out[v, :] = op over the live slots j of row v of feats[min(ell[v, j], n-1), :]
//
// with op in {sum, mean, max}.  A slot is live iff its id is >= 0 (FILL = -1
// and every other negative id is skipped); an id >= n reads row n - 1, as the
// reference's feats[clip(idx, 0, n - 1)] does, and never reads out of bounds.
// The sum is taken in f32 in ascending j and rounded once to the feature
// type; mean divides it by max(count, 1); max starts at -inf and propagates
// NaN like jnp.maximum, and a result that is not finite (an empty row, or
// only -inf / NaN features) becomes 0, as where(isfinite(acc), acc, 0) does.
// So an all-FILL row gives 0 for every op.
//
// What bounds it on the card: bytes.  One add or compare per gathered value
// and no reuse a register could exploit: it must read the R * W * 4 bytes of
// the table, each distinct feature row that a live slot names (d * 4 or
// d * 2 bytes, once), and write the R * d output; a feature row named by
// many rows is read many times unless L2 holds it.
//
// The design aims only at those reads:
//  * a group of G lanes (a power of two, 1..32, the smallest with
//    G * V >= d, a warp at most) owns a row; lane l holds features
//    [l * V, l * V + V) of each chunk of G * V features, so the group reads a
//    feature row as consecutive V-element vectors (V * sizeof(T) = 16 bytes
//    where d and the pointers allow it, else 8, 4 or 2);
//  * the group reads the row's ids G at a time, one per lane, and broadcasts
//    them with shuffles, so the table is read once per feature chunk and
//    coalesced;
//  * the accumulators stay in registers, V per lane; nothing is staged in
//    shared memory and blocks share nothing;
//  * a ragged R or d is masked here: any R, W, d >= 1.
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;

enum Op { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
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

// V elements of T in one aligned load or store
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T x[V];
};

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ ell, const T* __restrict__ feats,
                T* __restrict__ out, int R, int W, int n, int d, int op) {
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = gtid / G;
  // G divides kThreads, so a group never straddles a block and its lanes
  // leave together: the shuffles below always see the whole group
  if (row >= R) return;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const int warp_lane = static_cast<int>(threadIdx.x) % 32;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (warp_lane & ~(G - 1));
  const int* erow = ell + row * W;
  T* orow = out + row * d;

  for (int fb = 0; fb < d; fb += G * V) {
    const int f = fb + lane * V;
    const bool act = f < d;              // d % V == 0: a whole vector
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = op == kMax ? -INFINITY : 0.f;
    int count = 0;
    for (int j0 = 0; j0 < W; j0 += G) {
      const int mine = j0 + lane < W ? erow[j0 + lane] : -1;
      const int m = min(G, W - j0);
      for (int jj = 0; jj < m; ++jj) {
        const int idx = __shfl_sync(mask, mine, jj, G);
        if (idx < 0) continue;           // FILL: the same for the group
        ++count;
        if (!act) continue;
        const long long r = min(idx, n - 1);
        const Pack<T, V> p =
            *reinterpret_cast<const Pack<T, V>*>(feats + r * d + f);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float x = to_f(p.x[e]);
          if (op == kMax) {
            // NaN-propagating max (jnp.maximum): a NaN acc stays NaN
            if (x > acc[e] || x != x) acc[e] = x;
          } else {
            acc[e] += x;
          }
        }
      }
    }
    if (!act) continue;
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float y = acc[e];
      if (op == kMean) y = y / static_cast<float>(max(count, 1));
      if (op == kMax && !isfinite(y)) y = 0.f;
      o.x[e] = from_f<T>(y);
    }
    *reinterpret_cast<Pack<T, V>*>(orow + f) = o;
  }
}

template <typename T, int G, int V>
cudaError_t launch(const int* ell, const void* feats, void* out, int R, int W,
                   int n, int d, int op, cudaStream_t stream) {
  const long long threads = static_cast<long long>(R) * G;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  ell_spmm_kernel<T, G, V><<<blocks, kThreads, 0, stream>>>(
      ell, static_cast<const T*>(feats), static_cast<T*>(out), R, W, n, d,
      op);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t by_lanes(int G, const int* ell, const void* feats, void* out,
                     int R, int W, int n, int d, int op, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, 1, V>(ell, feats, out, R, W, n, d, op, st);
    case 2: return launch<T, 2, V>(ell, feats, out, R, W, n, d, op, st);
    case 4: return launch<T, 4, V>(ell, feats, out, R, W, n, d, op, st);
    case 8: return launch<T, 8, V>(ell, feats, out, R, W, n, d, op, st);
    case 16: return launch<T, 16, V>(ell, feats, out, R, W, n, d, op, st);
    case 32: return launch<T, 32, V>(ell, feats, out, R, W, n, d, op, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; op: 0 sum, 1 mean, 2 max; lanes G in
// {1, 2, 4, 8, 16, 32}; vec V elements per load with V * sizeof <= 16, d % V
// == 0 and both feature pointers aligned to V * sizeof (the wrapper picks
// and checks them).  R, W, n, d >= 1.
extern "C" int ell_spmm(const void* ell, const void* feats, void* out, int R,
                        int W, int n, int d, int op, int dtype, int lanes,
                        int vec, void* stream) {
  if (R < 1 || W < 1 || n < 1 || d < 1 || op < 0 || op > 2 || vec < 1 ||
      d % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* e = static_cast<const int*>(ell);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t r = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 1: r = by_lanes<float, 1>(lanes, e, feats, out, R, W, n, d, op, st); break;
      case 2: r = by_lanes<float, 2>(lanes, e, feats, out, R, W, n, d, op, st); break;
      case 4: r = by_lanes<float, 4>(lanes, e, feats, out, R, W, n, d, op, st); break;
      default: break;
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: r = by_lanes<__nv_bfloat16, 1>(lanes, e, feats, out, R, W, n, d, op, st); break;
      case 2: r = by_lanes<__nv_bfloat16, 2>(lanes, e, feats, out, R, W, n, d, op, st); break;
      case 4: r = by_lanes<__nv_bfloat16, 4>(lanes, e, feats, out, R, W, n, d, op, st); break;
      case 8: r = by_lanes<__nv_bfloat16, 8>(lanes, e, feats, out, R, W, n, d, op, st); break;
      default: break;
    }
  }
  return static_cast<int>(r);
}
