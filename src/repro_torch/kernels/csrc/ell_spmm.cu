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
// d * 2 bytes, once), and write the R * d output.  That bytes bound is not
// reachable on a graph without locality (a uniform random one): there the
// feature table is many times the 50 MB L2, so nearly every live slot's row
// is a device-memory read of the 32-B sectors it spans, whatever the row
// order.  The "gather floor" (the table, the sectors of every live slot's
// row, the output; kernels/ell_spmm.py::gather_floor_bytes) is what a design
// can approach, and random sector reads do not reach the card's streaming
// rate either.
//
// The design keeps feature rows in flight and spends nothing on FILL:
//  * A group of G lanes (a power of two, 1..32, the smallest with
//    G * V >= d, a warp at most) owns a row; lane l holds features
//    [l * V, l * V + V) of each chunk of G * V features, so the group reads a
//    feature row as consecutive V-element vectors (V * sizeof(T) = 16 bytes
//    where d and the pointers allow it, else 8, 4 or 2).
//  * The group reads the row's ids G at a time, one a lane; a ballot gives
//    the live ones, and they are taken lowest j first, kInFlight at a time,
//    each broadcast from its lane by a shuffle.  A FILL slot costs its
//    4-byte read and one ballot bit.
//  * The kInFlight feature-row loads of a batch are issued before any of
//    them is folded into the accumulators, and folded in ascending j: the
//    f32 arithmetic, and so the result, is that of folding one slot at a
//    time in ascending j.  The accumulators stay in registers, V per lane;
//    blocks share nothing.
//  * Small blocks (kThreads): on an H100, 64-thread blocks took less time
//    than 256; 3 loads in flight took about as long as 2 or 4 and less than
//    8, and 4 left ptxas spilling bfloat16's 16-B variants; an L2
//    evict-first read of the table and a streaming store of the output did
//    not help (src/repro_torch/benchmarks/ell_spmm_ab.py measures each).
//  * A ragged R or d is masked here: any R, W, d >= 1.
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;    // threads a block
constexpr int kInFlight = 3;    // feature-row loads a lane before a fold

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

// Store V results as one Pack: float32 as they are; bfloat16 rounded (to
// nearest even) in pairs, each pair one 32-bit word, so the Pack is built in
// registers and never through memory.
template <typename T, int V>
__device__ __forceinline__ void store_pack(T* dst, const float (&y)[V]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
    unsigned w[V / 2];
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
      w[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (V == 4)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned*>(dst) = w[0];
  } else {
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.x[e] = from_f<T>(y[e]);
    *reinterpret_cast<Pack<T, V>*>(dst) = o;
  }
}

// Lanes of the calling thread's group of G, as a shuffle mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xFFFFFFFFu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << G) - 1u) << (lane & ~static_cast<unsigned>(G - 1));
  }
}

// The group's ballot, as bits 0..G-1.
template <int G>
__device__ __forceinline__ unsigned group_ballot(unsigned mask, bool p) {
  const unsigned b = __ballot_sync(mask, p);
  if constexpr (G == 32) {
    return b;
  } else {
    const unsigned base = (threadIdx.x & 31u) & ~static_cast<unsigned>(G - 1);
    return (b >> base) & ((1u << G) - 1u);
  }
}

// V features of a row, widened to float: bfloat16 in pairs, each pair one
// 32-bit word of the load, so no element is picked out through memory.
template <typename T, int V>
__device__ __forceinline__ void widen(const Pack<T, V>& p, float (&x)[V]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p.x);
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = to_f(p.x[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void fold(float (&acc)[V], const Pack<T, V>& p,
                                     int op) {
  float xs[V];
  widen<T, V>(p, xs);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float x = xs[e];
    if (op == kMax) {
      // NaN-propagating max (jnp.maximum): a NaN acc stays NaN
      if (x > acc[e] || x != x) acc[e] = x;
    } else {
      acc[e] += x;
    }
  }
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ ell, const T* __restrict__ feats,
                T* __restrict__ out, int R, int W, int n, int d, int op) {
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = gtid / G;
  // G divides kThreads, so a group never straddles a block and its lanes
  // leave together: the shuffles and ballots below see the whole group
  if (row >= R) return;
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const unsigned mask = group_mask<G>();
  const int* erow = ell + row * W;
  for (int fb = 0; fb < d; fb += G * V) {
    const int f = fb + lane * V;
    const bool act = f < d;          // d % V == 0: a whole vector
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = op == kMax ? -INFINITY : 0.f;
    int count = 0;
    for (int j0 = 0; j0 < W; j0 += G) {
      const int mine = j0 + lane < W ? __ldg(erow + j0 + lane) : -1;
      // the group's live slots of these G, lowest j first; uniform
      unsigned live = group_ballot<G>(mask, mine >= 0);
      count += __popc(live);
      while (live != 0) {
        int id[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int jj = live != 0 ? __ffs(live) - 1 : 0;
          const int v = __shfl_sync(mask, mine, jj, G);
          id[u] = live != 0 ? min(v, n - 1) : -1;
          live &= live - 1;
        }
        Pack<T, V> p[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (act && id[u] >= 0)
            p[u] = *reinterpret_cast<const Pack<T, V>*>(
                feats + static_cast<long long>(id[u]) * d + f);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          if (act && id[u] >= 0) fold<T, V>(acc, p[u], op);
      }
    }
    if (act) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (op == kMean) acc[e] = acc[e] / static_cast<float>(max(count, 1));
        if (op == kMax && !isfinite(acc[e])) acc[e] = 0.f;
      }
      store_pack<T, V>(out + row * d + f, acc);
    }
  }
}

template <typename T, int G, int V>
cudaError_t launch(const int* ell, const void* feats, void* out, int R, int W,
                   int n, int d, int op, cudaStream_t stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  ell_spmm_kernel<T, G, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      ell, static_cast<const T*>(feats), static_cast<T*>(out), R, W, n, d, op);
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
