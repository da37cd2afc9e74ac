// Hand-written Hopper (sm_90a) kernels of the coloring hot loop:
//
//   coloring_firstfit        replaces the Pallas kernel
//                            src/repro/kernels/firstfit.py::firstfit; two
//                            designs, picked by the wrapper
//                            (kernels/firstfit.py::design), the same rule
//                            as detect_recolor's: "vec16", the staged pass
//                            (staged_pass.cuh, entry firstfit_staged in
//                            detect_recolor.cu) with no candidate set, for
//                            rows of more than 16 ids that are whole 16-B
//                            chunks of a 16-B aligned tile (the RMATs: it
//                            streams the tile with cp.async where this
//                            file's kernel keeps about one 128-B line in
//                            flight a warp); "direct", this file's
//                            firstfit_kernel (pass_body<G, NW, false>),
//                            everywhere else
//                            (the meshes' rows of 8 and 14 ids)
//   coloring::detect_recolor_direct
//                            the design "direct" of coloring_detect_recolor
//                            (detect_recolor.cu), which replaces the Pallas
//                            kernel src/repro/kernels/detect_recolor.py::
//                            detect_recolor: the narrow rows (W <= 16, the
//                            meshes), where a row is a few loads and the
//                            staged pass's per-row work costs more than it
//                            saves
//
// Both "direct" designs are one template, pass_body<G, NW, DETECT>: for
// each row of an (R, W) row-major int32 ELL tile, gather the neighbours'
// colours (and, with DETECT, priorities) from the full (n,) vectors, OR the
// colours into a packed forbidden bitset, and take the smallest free colour
// (mex).  With DETECT the same gather also feeds the defect test (same
// colour as a higher-priority neighbour) and the epilogue keeps or replaces
// the row's colour.
//
// What the design is about.  The work is a data-dependent gather with a few
// integer operations per gathered value: it is bound by bytes, not by
// arithmetic (R*W*4 bytes of ELL, up to 4 or 8 bytes gathered per live slot,
// O(R) vectors; no floating point at all).
//
//  * G lanes share a row (G a power of two, 1..32, chosen by the wrapper as
//    the smallest power of two >= W, capped at a warp).  Lane l reads slots
//    l, l+G, ... of the row, so a group reads consecutive words of the
//    row-major table; the lanes' partial bitsets are OR-ed with xor-shuffles
//    inside the group and their defect flags with a vote.  G = 1 is the
//    thread-per-row form; G = 32 the warp-per-row form.
//  * The forbidden words live in registers: NW words per lane, updated with
//    an unrolled compare-and-select so the array is never indexed
//    dynamically (which would push it to local memory).  NW*32 >= C is the
//    single-window fast case.  A larger cap is swept in windows of NW words,
//    re-reading the row for each window and stopping at the first window
//    with a free colour, so any C >= 1 runs and nothing is allocated.
//  * The (n,) colour and priority vectors are read straight from global
//    memory through L2; there is no residency limit on n.
//  * The result goes to newc (R,), never into colors: every row of a launch
//    sees the colours as they were before the launch, whatever the order in
//    which blocks run.  The caller commits newc afterwards.
//  * Ragged edges are masked here: any R >= 1, any W >= 1.
//  * With row_ids (DETECT only; the compacted-frontier pass), row r is
//    vertex row_ids[r] (clamped to [0, n-1]): it reads that vertex's colour,
//    priority and row of the full ELL table; forb0, extra_defect and the
//    per-row flags stay indexed by r.
//  * Slot stride (DETECT with row_ids, slot_rows > 0; the megabatched
//    repair): the tables are S slots' stacked tables of slot_rows rows, the
//    row ids global, a row's ELL ids local to its slot; neighbour j is read
//    at the row's slot's first row + min(j, slot_rows - 1).  slot_rows 0 is
//    the one-table pass.
//  * Detect only (DETECT, out_c null: CAT's separate detect pass): the
//    defect test alone — no forbidden words, no mex — and recolored the one
//    output, the same flags as the full pass's.
//
// Bit conventions (equal to core/bitset.py): bit (c & 31) of word (c >> 5) is
// colour c; bits for colours >= C are pre-forbidden; colours outside [0, C)
// and FILL (< 0) slots contribute nothing; an all-ones row gives mex = 0 with
// the overflow flag set.  __ffs(~w) - 1 is the index of the lowest zero bit.
//
// The shared helpers (tail words, lane groups, the register-word OR and the
// group mex) are in pass_common.cuh; twohop.cu uses them too.
//
// Plain C interface, no PyTorch headers: each function launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include "pass_common.cuh"

namespace {

using coloring::kThreads;

template <int G, int NW, bool DETECT>
__device__ __forceinline__ void
pass_body(const int* __restrict__ ell,             // (R, W) or (>= n, W)
          const int* __restrict__ colors,          // (n,)
          const int* __restrict__ pri,             // (n,)      DETECT
          const uint8_t* __restrict__ U,           // (R,)      DETECT
          const int* __restrict__ forb0,           // (R, nW)   or null
          const uint8_t* __restrict__ extra_defect,  // (R,)      or null
          const uint8_t* __restrict__ force,       // (R,)      or null
          const uint8_t* __restrict__ valid,       // (R,)      or null
          const int* __restrict__ row_ids,         // (R,)      or null
          int* __restrict__ out_c,                 // (R,) mex / new colour,
                                                   //   or null: detect only
          uint8_t* __restrict__ out_rec,           // (R,)      DETECT
          uint8_t* __restrict__ out_ovf,           // (R,) or null with out_c
          int R, int W, int n, int C, int nW, int row_start,
          int slot_rows) {                         // > 0: slot stride
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = gtid / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  // a group never straddles the edge: G divides kThreads, so its lanes
  // share `row` and leave together
  if (row >= R) return;
  const unsigned mask = coloring::group_mask<G>();

  // the row's vertex and its ELL row: a tile row, or a row of the full table
  long long vid = row_start + row;
  const int* __restrict__ ell_row = ell + row * W;
  if (row_ids != nullptr) {
    vid = min(max(row_ids[row], 0), n - 1);
    ell_row = ell + vid * W;
  }
  // neighbour j is read at base + min(j, lim - 1): the one table (base 0,
  // lim n), or in the slot-stride form the row's own slot's rows
  const long long base = slot_rows > 0 ? vid - vid % slot_rows : 0;
  const int lim = slot_rows > 0 ? slot_rows : n;

  // detect only: the defect test, and recolored the one output
  const bool only = DETECT && out_c == nullptr;
  int c_r = -1, p_r = -1;
  if constexpr (DETECT) {
    c_r = colors[vid];
    p_r = pri[vid];
    // work = valid & ((U & defect) | force) can only be true on these rows;
    // every other row keeps its colour without its ELL row being read
    const bool may_work = (valid == nullptr || valid[row] != 0) &&
                          (U[row] != 0 || (force != nullptr && force[row] != 0));
    if (!may_work) {
      if (lane == 0) {
        if (!only) {
          out_c[row] = c_r;
          out_ovf[row] = 0;
        }
        out_rec[row] = 0;
      }
      return;
    }
  }

  bool defect = false;
  int mex = -1;
  // window loop: one trip when NW*32 >= C; its condition is uniform within
  // the group because every lane holds the reduced words
  for (int wb = 0; wb < nW && mex < 0; wb += NW) {
    unsigned w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[k] = coloring::tail_word(wb + k, C);
      if (forb0 != nullptr && lane == 0 && wb + k < nW)
        w[k] |= static_cast<unsigned>(forb0[row * nW + wb + k]);
    }
    for (int j = lane; j < W; j += G) {
      int idx = ell_row[j];
      if (idx < 0) continue;                 // FILL: colour -1, priority -1
      idx = static_cast<int>(base + min(idx, lim - 1));
      const int c = colors[idx];
      if constexpr (DETECT) {
        if (wb == 0 && c == c_r && c_r >= 0 && pri[idx] > p_r) defect = true;
      }
      if (!only) coloring::or_colour<NW>(w, c, C, wb);
    }
    if (only) break;                         // uniform: the group's flag
    mex = coloring::window_mex<G, NW>(w, mask, wb);
  }
  const bool ovf = mex < 0;
  if (ovf) mex = 0;

  if constexpr (!DETECT) {
    if (lane == 0) {
      out_c[row] = mex;
      out_ovf[row] = ovf ? 1 : 0;
    }
  } else {
    defect = __any_sync(mask, defect) != 0;
    if (extra_defect != nullptr && extra_defect[row] != 0) defect = true;
    bool work = (U[row] != 0) && defect;
    if (force != nullptr && force[row] != 0) work = true;
    if (valid != nullptr && valid[row] == 0) work = false;
    if (lane == 0) {
      if (!only) {
        out_c[row] = work ? mex : c_r;
        out_ovf[row] = (ovf && work) ? 1 : 0;
      }
      out_rec[row] = work ? 1 : 0;
    }
  }
}

#define PASS_PARAMS                                                         \
  const int* __restrict__ ell, const int* __restrict__ colors,               \
      const int* __restrict__ pri, const uint8_t* __restrict__ U,            \
      const int* __restrict__ forb0,                                         \
      const uint8_t* __restrict__ extra_defect,                              \
      const uint8_t* __restrict__ force, const uint8_t* __restrict__ valid,  \
      const int* __restrict__ row_ids, int* __restrict__ out_c,              \
      uint8_t* __restrict__ out_rec, uint8_t* __restrict__ out_ovf, int R,   \
      int W, int n, int C, int nW, int row_start, int slot_rows
#define PASS_ARGS                                                            \
  ell, colors, pri, U, forb0, extra_defect, force, valid, row_ids, out_c,    \
      out_rec, out_ovf, R, W, n, C, nW, row_start, slot_rows

// The two kernels of pass_body.  First fit's names a minimum of one block
// an SM: ptxas then keeps every variant's words in registers (left to its
// own register target it spilled 8 bytes at 32 lanes and 16 words) at the
// same device time on the meshes' rows; the repair pass keeps ptxas's own
// target, which took less time at W 14 on an H100.
template <int G, int NW>
__global__ void __launch_bounds__(kThreads, 1) firstfit_kernel(PASS_PARAMS) {
  pass_body<G, NW, false>(PASS_ARGS);
}

template <int G, int NW>
__global__ void __launch_bounds__(kThreads) detect_kernel(PASS_PARAMS) {
  pass_body<G, NW, true>(PASS_ARGS);
}

#undef PASS_PARAMS
#undef PASS_ARGS

template <bool DETECT>
cudaError_t launch(int lanes, int window, const int* ell, const int* colors,
                   const int* pri, const uint8_t* U, const int* forb0,
                   const uint8_t* extra_defect, const uint8_t* force,
                   const uint8_t* valid, const int* row_ids, int* out_c,
                   uint8_t* out_rec, uint8_t* out_ovf, int R, int W, int n,
                   int C, int row_start, int slot_rows, cudaStream_t stream) {
  const int nW = (C + 31) / 32;
  return coloring::pick_shape(lanes, window, [&](auto g, auto nw) {
    constexpr int G = decltype(g)::value;
    constexpr int NW = decltype(nw)::value;
    const long long rows_per_block = kThreads / G;
    const long long blocks = (R + rows_per_block - 1) / rows_per_block;
    const unsigned grid = static_cast<unsigned>(blocks);
    if constexpr (DETECT)
      detect_kernel<G, NW><<<grid, kThreads, 0, stream>>>(
          ell, colors, pri, U, forb0, extra_defect, force, valid, row_ids,
          out_c, out_rec, out_ovf, R, W, n, C, nW, row_start, slot_rows);
    else
      firstfit_kernel<G, NW><<<grid, kThreads, 0, stream>>>(
          ell, colors, pri, U, forb0, extra_defect, force, valid, row_ids,
          out_c, out_rec, out_ovf, R, W, n, C, nW, row_start, 0);
    return cudaGetLastError();
  });
}

}  // namespace

namespace coloring {
// detect_recolor.cu: first fit on the staged pass (design "vec16")
cudaError_t firstfit_staged(const void* ell, const void* colors,
                            const void* forb0, void* mex, void* ovf, int R,
                            int W, int n, int C, int lanes, int window,
                            void* stream);
}  // namespace coloring

// lanes: lanes per row, one of 1 2 4 8 16 32.  window: forbidden words a
// window (2, 8 or 16 for "direct", 1..16 for "vec16").  design: 0 "vec16"
// (the staged pass; W % 4 == 0, ell 16-B aligned), 1 "direct" (pass_body).
extern "C" int coloring_firstfit(const void* ell, const void* colors,
                                 const void* forb0, void* mex, void* ovf,
                                 int R, int W, int n, int C, int lanes,
                                 int window, int design, void* stream) {
  if (R < 1 || W < 1 || n < 1 || C < 1 || design < 0 || design > 1 ||
      (design == 0 &&
       (W % 4 != 0 || reinterpret_cast<uintptr_t>(ell) % 16 != 0)))
    return cudaErrorInvalidValue;
  if (design == 0)
    return static_cast<int>(coloring::firstfit_staged(
        ell, colors, forb0, mex, ovf, R, W, n, C, lanes, window, stream));
  return static_cast<int>(launch<false>(
      lanes, window, static_cast<const int*>(ell),
      static_cast<const int*>(colors), nullptr, nullptr,
      static_cast<const int*>(forb0), nullptr, nullptr, nullptr, nullptr,
      static_cast<int*>(mex), nullptr, static_cast<uint8_t*>(ovf), R, W, n, C,
      0, 0, static_cast<cudaStream_t>(stream)));
}

// row_ids null: rows [row_start, row_start + R) of the colour vector, ell
// their (R, W) tile.  row_ids given: ell is the full table (>= n rows) and
// row_start is unused.  The entry (coloring_detect_recolor) checks the
// arguments.
namespace coloring {
cudaError_t detect_recolor_direct(
    const void* ell, const void* colors, const void* pri, const void* U,
    const void* forb0, const void* extra_defect, const void* force,
    const void* valid, const void* row_ids, void* newc, void* recolored,
    void* ovf, int R, int W, int n, int C, int row_start, int lanes,
    int window, int slot_rows, void* stream) {
  return launch<true>(
      lanes, window, static_cast<const int*>(ell),
      static_cast<const int*>(colors), static_cast<const int*>(pri),
      static_cast<const uint8_t*>(U), static_cast<const int*>(forb0),
      static_cast<const uint8_t*>(extra_defect),
      static_cast<const uint8_t*>(force), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(row_ids), static_cast<int*>(newc),
      static_cast<uint8_t*>(recolored), static_cast<uint8_t*>(ovf), R, W, n,
      C, row_start, slot_rows, static_cast<cudaStream_t>(stream));
}
}  // namespace coloring
