// Hand-written Hopper (sm_90a) kernels of the distance-2 coloring pass:
//
//   coloring_twohop_detect_recolor  replaces the Pallas kernel
//                                   src/repro/kernels/twohop.py::twohop_detect_recolor
//
// For each row (a vertex v): OR the colours of every vertex within two hops
// of v into a packed forbidden bitset — hop 1 over v's ELL row, hop 2 over
// each neighbour's own row of the full table — and take the smallest free
// colour (mex).  With DETECT the same gathers feed the defect test (same
// colour as a higher-priority vertex within two hops) and the epilogue keeps
// or replaces v's colour: work = valid & ((U & defect) | force).  Without
// DETECT (round 0) work = valid & (U | force) and no priority is read.
//
// Two designs behind the one entry point, picked by the wrapper by shape
// (kernels/twohop.py::design) and passed as an id:
//
//   "staged16", "staged4"  twohop_staged.cu: live hop-1 ids compacted, all
//                          of a row's hop-2 rows copied into a shared-memory
//                          stage with cp.async (16-B or 4-B copies) before
//                          any is used, double-buffered across rows; rows
//                          of 17..512 ids at the default lane count.  See
//                          the note there.
//   "direct"               the kernel below: hop-2 rows read straight from
//                          global memory, one neighbour after another.  For
//                          rows of at most 16 ids (the meshes: a row's two
//                          hops are a few hundred ids, and the staged
//                          pass's fixed per-row work costs more than it
//                          saves) and the shapes the stage does not hold.
//
// The rest of this note is the direct design's.
//
// What the design is about.  A row reads W neighbour ids, then W rows of W
// ids at random places of the (n_all, W) table, and one colour per live
// slot: a data-dependent gather with a few integer operations per value, so
// it is bound by bytes, never by arithmetic (no floating point at all).
//
//  * No paging.  The TPU kernel pages the hop-2 table through VMEM on a
//    (row blocks, pages) grid with scratch accumulators, because the table
//    does not fit there.  Here the table, the colours and the priorities are
//    read from global memory through L2 with no size limit: a row's hop-2
//    rows are read straight where they are, each two-hop edge exactly once
//    per window, and nothing is carried between blocks.
//  * G lanes share a row, as in coloring.cu (G the smallest power of two
//    >= W, capped at a warp).  Hop 1: lane l reads slots l, l+G, ... of the
//    row.  Hop 2: the group walks the neighbours j = 0..W-1 in step; for a
//    live one the lanes read consecutive words of its row.  Colours (and, in
//    the defect test, priorities) come from the full (n,) vectors; a
//    priority is read only where the colour equals the row's own.
//  * The forbidden words stay in registers (NW per lane, unrolled
//    compare-and-select), OR-reduced with xor-shuffles in the group; the
//    defect flag with a vote.  A cap wider than the window is swept window
//    by window, re-reading both hops, stopping at the first free colour.
//  * Rows outside valid & (U | force) return before reading their row.  A
//    forced row or one that is uncoloured cannot depend on the defect test,
//    so it reads no priority either.
//  * The result goes to newc (R,), never into colors: every row of a launch
//    sees the colours as they were before it; the caller commits.
//  * Self-exclusion: v is its own two-hop neighbour through any neighbour,
//    so hop-2 slots holding v's id add nothing.  Hop-1 colours may repeat
//    in hop 2 (and hop-2 duplicates repeat): the bitset and the defect flag
//    are ORs, so repeats change nothing.
//  * Indices are clamped as the plain version clamps them: ids to [0, n-1]
//    with n = colors length (n_all >= n), row_ids likewise; FILL (< 0) slots
//    are dead.  Any R >= 1, W >= 1, C >= 1.
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include "pass_common.cuh"

namespace {

using coloring::kThreads;

template <int G, int NW, bool DETECT>
__global__ void __launch_bounds__(kThreads)
twohop_kernel(const int* __restrict__ ell_rows,   // (R, W) or null
              const int* __restrict__ ell_all,    // (n_all, W), n_all >= n
              const int* __restrict__ colors,     // (n,)
              const int* __restrict__ pri,        // (n,)   DETECT
              const uint8_t* __restrict__ U,      // (R,)
              const uint8_t* __restrict__ force,  // (R,)   or null
              const uint8_t* __restrict__ valid,  // (R,)   or null
              const int* __restrict__ row_ids,    // (R,)   or null
              int* __restrict__ out_c,            // (R,)
              uint8_t* __restrict__ out_rec,      // (R,)
              uint8_t* __restrict__ out_ovf,      // (R,)
              int R, int W, int n, int C, int nW, int row_start) {
  const long long gtid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = gtid / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  if (row >= R) return;                 // whole groups leave together
  const unsigned mask = coloring::group_mask<G>();

  // the row's vertex and its ELL row: a tile row, or a row of the table
  long long vid;
  const int* __restrict__ ell_row;
  if (row_ids != nullptr) {
    vid = min(max(row_ids[row], 0), n - 1);
    ell_row = ell_all + vid * W;
  } else {
    vid = row_start + row;
    ell_row = ell_rows + row * W;
  }
  const int c_r = colors[vid];
  const bool in_u = U[row] != 0;
  const bool forced = force != nullptr && force[row] != 0;
  if ((valid != nullptr && valid[row] == 0) || !(in_u || forced)) {
    if (lane == 0) {
      out_c[row] = c_r;
      out_rec[row] = 0;
      out_ovf[row] = 0;
    }
    return;
  }
  // the defect test decides only for an unforced row of U with a colour
  const bool test = DETECT && in_u && !forced && c_r >= 0;
  const int p_r = test ? pri[vid] : -1;
  const int vid32 = static_cast<int>(vid);

  bool defect = false;
  int mex = -1;
  for (int wb = 0; wb < nW && mex < 0; wb += NW) {
    unsigned w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = coloring::tail_word(wb + k, C);
    const bool probe = test && wb == 0;
    // hop 1: the row's own neighbours
    for (int j = lane; j < W; j += G) {
      const int idx = ell_row[j];
      if (idx < 0) continue;
      const int s = min(idx, n - 1);
      const int c = colors[s];
      if (probe && c == c_r && pri[s] > p_r) defect = true;
      coloring::or_colour<NW>(w, c, C, wb);
    }
    // hop 2: each live neighbour's own row, read by the group in step
    for (int j = 0; j < W; ++j) {
      const int idx = ell_row[j];          // same word for every lane
      if (idx < 0) continue;
      const int* __restrict__ row2 =
          ell_all + static_cast<long long>(min(idx, n - 1)) * W;
      for (int jj = lane; jj < W; jj += G) {
        const int idx2 = row2[jj];
        if (idx2 < 0 || idx2 == vid32) continue;   // FILL, or the row itself
        const int s = min(idx2, n - 1);
        const int c = colors[s];
        if (probe && c == c_r && pri[s] > p_r) defect = true;
        coloring::or_colour<NW>(w, c, C, wb);
      }
    }
    mex = coloring::window_mex<G, NW>(w, mask, wb);
  }
  const bool ovf = mex < 0;
  if (ovf) mex = 0;
  defect = __any_sync(mask, defect) != 0;
  const bool work = forced || (in_u && (DETECT ? defect : true));
  if (lane == 0) {
    out_c[row] = work ? mex : c_r;
    out_rec[row] = work ? 1 : 0;
    out_ovf[row] = (ovf && work) ? 1 : 0;
  }
}

template <bool DETECT>
cudaError_t launch(int lanes, int window, const int* ell_rows,
                   const int* ell_all, const int* colors, const int* pri,
                   const uint8_t* U, const uint8_t* force,
                   const uint8_t* valid, const int* row_ids, int* out_c,
                   uint8_t* out_rec, uint8_t* out_ovf, int R, int W, int n,
                   int C, int row_start, cudaStream_t stream) {
  const int nW = (C + 31) / 32;
  return coloring::pick_shape(lanes, window, [&](auto g, auto nw) {
    constexpr int G = decltype(g)::value;
    constexpr int NW = decltype(nw)::value;
    const long long rows_per_block = kThreads / G;
    const long long blocks = (R + rows_per_block - 1) / rows_per_block;
    twohop_kernel<G, NW, DETECT><<<static_cast<unsigned>(blocks), kThreads,
                                   0, stream>>>(
        ell_rows, ell_all, colors, pri, U, force, valid, row_ids, out_c,
        out_rec, out_ovf, R, W, n, C, nW, row_start);
    return cudaGetLastError();
  });
}

}  // namespace

namespace coloring {
// twohop_staged.cu
cudaError_t twohop_staged_launch(int vec, bool detect, int lanes, int window,
                                 const int* ell_rows, const int* ell_all,
                                 const int* colors, const int* pri,
                                 const uint8_t* U, const uint8_t* force,
                                 const uint8_t* valid, const int* row_ids,
                                 int* out_c, uint8_t* out_rec,
                                 uint8_t* out_ovf, int R, int W, int n, int C,
                                 int row_start, cudaStream_t stream);
}  // namespace coloring

// ell_rows null needs row_ids (rows are then read from ell_all); with
// row_ids, row_start is unused.  pri may be null when detect == 0.
// lanes: 1 2 4 8 16 32; window: 2 8 16 register words.  design: 0 direct,
// 1 staged with 16-B copies (W % 4 == 0, ell_all 16-B aligned), 2 staged
// with 4-B copies (a staged design checks its shape rule itself).
extern "C" int coloring_twohop_detect_recolor(
    const void* ell_rows, const void* ell_all, const void* colors,
    const void* pri, const void* U, const void* force, const void* valid,
    const void* row_ids, void* newc, void* recolored, void* ovf, int R, int W,
    int n, int n_all, int C, int row_start, int detect, int lanes, int window,
    int design, void* stream) {
  if (R < 1 || W < 1 || n < 1 || n_all < n || C < 1 ||
      (detect != 0 && pri == nullptr) ||
      (row_ids == nullptr &&
       (ell_rows == nullptr || row_start < 0 ||
        static_cast<long long>(row_start) + R > n)) ||
      design < 0 || design > 2)
    return cudaErrorInvalidValue;
  const auto cs = static_cast<cudaStream_t>(stream);
  if (design != 0)
    return static_cast<int>(coloring::twohop_staged_launch(
        design == 1 ? 4 : 1, detect != 0, lanes, window,
        static_cast<const int*>(ell_rows), static_cast<const int*>(ell_all),
        static_cast<const int*>(colors), static_cast<const int*>(pri),
        static_cast<const uint8_t*>(U), static_cast<const uint8_t*>(force),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(row_ids),
        static_cast<int*>(newc), static_cast<uint8_t*>(recolored),
        static_cast<uint8_t*>(ovf), R, W, n, C, row_start, cs));
  auto run = [&](auto detect_tag) {
    return launch<decltype(detect_tag)::value>(
        lanes, window, static_cast<const int*>(ell_rows),
        static_cast<const int*>(ell_all), static_cast<const int*>(colors),
        static_cast<const int*>(pri), static_cast<const uint8_t*>(U),
        static_cast<const uint8_t*>(force), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(row_ids), static_cast<int*>(newc),
        static_cast<uint8_t*>(recolored), static_cast<uint8_t*>(ovf), R, W, n,
        C, row_start, cs);
  };
  return static_cast<int>(detect != 0 ? run(std::true_type{})
                                      : run(std::false_type{}));
}
