// Hand-written Hopper (sm_90a) kernel of RSOC's repair pass:
//
//   coloring_detect_recolor  replaces the Pallas kernel
//                            src/repro/kernels/detect_recolor.py::detect_recolor
//
// For each row of an (R, W) row-major int32 ELL tile (or, with row_ids, of
// the full table), one gather of the neighbours' colours and priorities
// feeds both the defect test (same colour as a higher-priority neighbour)
// and the packed forbidden bitset; rows in work = valid & ((U & defect) |
// force) take the smallest free colour (mex), all others keep theirs.
// forb0 (R, nW) words are OR-ed into the first words of each window,
// extra_defect (R,) into the defect flags.
//
// Detect only (newc and ovf null): CAT's separate detect pass.  The defect
// test alone — no forbidden words, no mex — writing only recolored, the
// same flags as the full pass's recolored; forb0 is not read.
//
// What bounds it.  At the main path's hardest chunk (RMAT-B, 262144 x 512,
// 97 % FILL) the pass must stream the whole tile once — 537 MB, nearly all
// of its bytes bound — and gather a few colours per row from L2.  A
// one-word-a-lane loop (pass_body in coloring.cu, firstfit's) keeps about
// one 128-B line in flight per warp, each word followed by a data-dependent
// body, and spends tens of instructions per slot on its register words.
//
// The kernel is staged_pass.cuh's pass<G, VEC, 1> (see the note
// there): persistent groups of G lanes, rows that cannot work skipped G at a
// time, each working row's W ids copied into a shared-memory stage with
// cp.async while the previous row's colours are gathered (the tile is one
// contiguous span; with row_ids one contiguous row of the full table each),
// colours loaded eight at a time a lane, a priority only where a colour
// equals the row's, the forbidden words in shared memory (one atomicOr a
// live colour).  Designs by shape, picked by the wrapper
// (kernels/detect_recolor.py::design): "vec16", 16-B copies, for rows of
// more than 16 ids where W*4 is a multiple of 16 and the table 16-B
// aligned; "direct" (coloring.cu's one-row-at-a-time pass_body)
// everywhere else: rows of at most 16 ids — the meshes — where a row is a
// few loads and the staged pass's fixed per-row work (the candidate scan,
// the copy and its wait, the word init and scan) costs more than the
// overlap saves, and rows that are not whole 16-B chunks (a 4-B-copy form
// of the staged pass lost to "direct" at the meshes' W 14 on an H100).
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include "staged_pass.cuh"

namespace coloring {
// twohop_staged.cu
cudaError_t twohop_staged_groups(int vec, int lanes, int W,
                                 long long* groups);
// coloring.cu
cudaError_t detect_recolor_direct(
    const void* ell, const void* colors, const void* pri, const void* U,
    const void* forb0, const void* extra_defect, const void* force,
    const void* valid, const void* row_ids, void* newc, void* recolored,
    void* ovf, int R, int W, int n, int C, int row_start, int lanes,
    int window, int slot_rows, void* stream);
}  // namespace coloring

// row_ids null: rows [row_start, row_start + R) of the colour vector, ell
// their (R, W) tile.  row_ids given: ell is the full table (>= n rows) and
// row_start is unused.  lanes: 1 2 4 8 16 32; window: forbidden words a
// window (2, 8 or 16 for "direct", 1..16 for "vec16"); design: 0 "vec16"
// (W % 4 == 0, ell 16-B aligned), 1 "direct".  newc and ovf both null:
// detect only (recolored is the one output).  slot_rows > 0 (row_ids
// given, n a multiple of it): the slot-stride form — ell, colors and pri
// are S = n / slot_rows slots' stacked tables, row_ids global ids
// s * slot_rows + v, and a row reads its neighbours in its own slot
// (staged_pass.cuh); 0: the one-table pass.
extern "C" int coloring_detect_recolor(
    const void* ell, const void* colors, const void* pri, const void* U,
    const void* forb0, const void* extra_defect, const void* force,
    const void* valid, const void* row_ids, void* newc, void* recolored,
    void* ovf, int R, int W, int n, int C, int row_start, int lanes,
    int window, int design, int slot_rows, void* stream) {
  if (R < 1 || W < 1 || n < 1 || C < 1 || recolored == nullptr ||
      (newc == nullptr) != (ovf == nullptr) || slot_rows < 0 ||
      (slot_rows > 0 && (row_ids == nullptr || n % slot_rows != 0)) ||
      (row_ids == nullptr &&
       (row_start < 0 || static_cast<long long>(row_start) + R > n)) ||
      design < 0 || design > 1 ||
      (design == 0 &&
       (W % 4 != 0 || reinterpret_cast<uintptr_t>(ell) % 16 != 0)))
    return cudaErrorInvalidValue;
  if (design == 1)
    return static_cast<int>(coloring::detect_recolor_direct(
        ell, colors, pri, U, forb0, extra_defect, force, valid, row_ids, newc,
        recolored, ovf, R, W, n, C, row_start, lanes, window, slot_rows,
        stream));
  coloring::staged::Args a{};
  const int* e = static_cast<const int*>(ell);
  a.ell_rows = row_ids == nullptr ? e : nullptr;
  a.ell_all = row_ids == nullptr ? nullptr : e;
  a.colors = static_cast<const int*>(colors);
  a.pri = static_cast<const int*>(pri);
  a.U = static_cast<const uint8_t*>(U);
  a.forb0 = static_cast<const int*>(forb0);
  a.extra_defect = static_cast<const uint8_t*>(extra_defect);
  a.force = static_cast<const uint8_t*>(force);
  a.valid = static_cast<const uint8_t*>(valid);
  a.row_ids = static_cast<const int*>(row_ids);
  a.out_c = static_cast<int*>(newc);
  a.out_rec = static_cast<uint8_t*>(recolored);
  a.out_ovf = static_cast<uint8_t*>(ovf);
  a.R = R;
  a.W = W;
  a.n = n;
  a.C = C;
  a.nW = (C + 31) / 32;
  a.row_start = row_start;
  a.window = window;
  a.slot_rows = slot_rows;
  a.detect = true;
  return static_cast<int>(coloring::staged::launch<4, 1>(
      lanes, a, static_cast<cudaStream_t>(stream)));
}

// First fit's design "vec16" (entry coloring_firstfit in coloring.cu, which
// checks the arguments): the same staged pass with no candidate set (every
// row works), no defect test and no recolored output.
namespace coloring {
cudaError_t firstfit_staged(const void* ell, const void* colors,
                            const void* forb0, void* mex, void* ovf, int R,
                            int W, int n, int C, int lanes, int window,
                            void* stream) {
  staged::Args a{};
  a.ell_rows = static_cast<const int*>(ell);
  a.colors = static_cast<const int*>(colors);
  a.forb0 = static_cast<const int*>(forb0);
  a.out_c = static_cast<int*>(mex);
  a.out_ovf = static_cast<uint8_t*>(ovf);
  a.R = R;
  a.W = W;
  a.n = n;
  a.C = C;
  a.nW = (C + 31) / 32;
  a.window = window;
  a.detect = false;
  return staged::launch<4, 1>(lanes, a, static_cast<cudaStream_t>(stream));
}
}  // namespace coloring

// Launch shape of the staged pass, for reports and tests: out[0] threads a
// block, out[1] dynamic shared memory a block (bytes), out[2] the groups
// resident at once on this device — for hops 1 (this kernel's design 0,
// "vec16") or 2 (the two-hop staged designs: design 1 staged16, 2 staged4).
extern "C" int coloring_staged_shape(int hops, int design, int lanes, int W,
                                     void* out) {
  using namespace coloring::staged;
  if (W < 1 || (hops == 1 && design != 0) ||
      (hops == 2 && (design < 1 || design > 2 || !twohop_fits(lanes, W))) ||
      (hops != 1 && hops != 2))
    return cudaErrorInvalidValue;
  long long groups = 0;
  cudaError_t e;
  if (hops == 1) {
    e = coloring::staged::groups<4, 1>(lanes, W, &groups);
  } else {
    e = coloring::twohop_staged_groups(design == 1 ? 4 : 1, lanes, W,
                                       &groups);
  }
  long long* o = static_cast<long long*>(out);
  o[0] = hops == 2 ? kThreads<2> : kThreads<1>;
  o[1] = static_cast<long long>(smem_bytes(lanes, hops, W));
  o[2] = groups;
  return static_cast<int>(e);
}
