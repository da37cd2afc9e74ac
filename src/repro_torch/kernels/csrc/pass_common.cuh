// Helpers shared by the coloring kernels (coloring.cu, twohop.cu): the
// packed forbidden-word conventions of core/bitset.py and the lane groups
// that share a row.  See the note at the top of coloring.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace coloring {

constexpr int kThreads = 256;   // threads per block (a multiple of every G)

// Word k of the all-free table: bits of colours >= C are set.
__device__ __forceinline__ unsigned tail_word(int k, int C) {
  const int live = C - k * 32;
  if (live >= 32) return 0u;
  if (live <= 0) return 0xFFFFFFFFu;
  return ~((1u << live) - 1u);
}

// Lanes of the calling thread's group, as a shuffle mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xFFFFFFFFu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << G) - 1u) << (lane & ~static_cast<unsigned>(G - 1));
  }
}

// OR colour c into the NW register words of window wb (words wb..wb+NW-1):
// an unrolled compare-and-select, so the array is never indexed dynamically
// (which would push it to local memory).  Colours outside [0, C) add nothing.
template <int NW>
__device__ __forceinline__ void or_colour(unsigned (&w)[NW], int c, int C,
                                          int wb) {
  if (c >= 0 && c < C) {
    const int wi = (c >> 5) - wb;
    const unsigned bit = 1u << (c & 31);
#pragma unroll
    for (int k = 0; k < NW; ++k)
      if (wi == k) w[k] |= bit;
  }
}

// OR-reduce the words over the group, then the smallest free colour of the
// window (-1 if every bit is set); every lane of the group gets the result.
template <int G, int NW>
__device__ __forceinline__ int window_mex(unsigned (&w)[NW], unsigned mask,
                                          int wb) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] |= __shfl_xor_sync(mask, w[k], off);
  }
  int mex = -1;
  // descending, so the lowest word with a zero bit wins
#pragma unroll
  for (int k = NW - 1; k >= 0; --k)
    if (w[k] != 0xFFFFFFFFu) mex = (wb + k) * 32 + __ffs(~w[k]) - 1;
  return mex;
}

// Launch-shape dispatch: calls f(integral_constant<int, G>,
// integral_constant<int, NW>) for lanes per row G in 1..32 and register
// window NW in {2, 8, 16}, so one call site instantiates every shape.
template <int G, typename F>
cudaError_t pick_window(int window, F&& f) {
  using std::integral_constant;
  switch (window) {
    case 2:  return f(integral_constant<int, G>{}, integral_constant<int, 2>{});
    case 8:  return f(integral_constant<int, G>{}, integral_constant<int, 8>{});
    case 16: return f(integral_constant<int, G>{}, integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t pick_shape(int lanes, int window, F&& f) {
  switch (lanes) {
    case 1:  return pick_window<1>(window, f);
    case 2:  return pick_window<2>(window, f);
    case 4:  return pick_window<4>(window, f);
    case 8:  return pick_window<8>(window, f);
    case 16: return pick_window<16>(window, f);
    case 32: return pick_window<32>(window, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace coloring
