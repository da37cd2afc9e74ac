// Designs "staged16" and "staged4" of the distance-2 pass
// (coloring_twohop_detect_recolor in twohop.cu picks one by shape; see the
// note there for what the pass computes).  The design "direct" (twohop.cu)
// walks a row's live neighbours one after another — per neighbour a
// dependent chain of its id, its row of the (n_all, W) table, then the
// colours — so a warp has about one table row in flight and the pass is
// latency-bound past L2.
//
// These designs are staged_pass.cuh's pass<G, VEC, 2> (see the note
// there): a row's live hop-1 ids are packed into shared memory with group
// ballots, then the table rows of all its live neighbours are copied into a
// shared-memory stage with cp.async (16-B copies for "staged16": W*4 a
// multiple of 16 and the table 16-B aligned; 4-B copies for "staged4"),
// flattened over (neighbour, chunk) pairs so no lane copies a FILL
// neighbour, while the previous row's colours are gathered; hop-2 slots
// holding the row's own id add nothing; 32 / G rows a warp where W is small.
//
// Shape rule (twohop_fits, which the wrapper asks through
// coloring_twohop_staged_fits): a group's stage slice (32 * G ints) holds one
// table row and a warp's id buffer (512 ints) its groups' rows; the default
// lane count meets it for every W <= 512.  A row with more live neighbours
// than its slice holds is staged in batches.
//
// What maps to the TPU kernel's paging: src/repro/kernels/twohop.py pages
// the whole table through VMEM and scans every page for every row block.
// Here a row pages in exactly its own hop-2 rows (its stage slice is its
// page), so each two-hop edge is read once per window.

#include "staged_pass.cuh"

namespace coloring {

// vec: 4 (16-B copies; W % 4 == 0 and ell_all 16-B aligned) or 1.
cudaError_t twohop_staged_launch(int vec, bool detect, int lanes, int window,
                                 const int* ell_rows, const int* ell_all,
                                 const int* colors, const int* pri,
                                 const uint8_t* U, const uint8_t* force,
                                 const uint8_t* valid, const int* row_ids,
                                 int* out_c, uint8_t* out_rec,
                                 uint8_t* out_ovf, int R, int W, int n, int C,
                                 int row_start, cudaStream_t stream) {
  if (!staged::twohop_fits(lanes, W) || (vec != 1 && vec != 4) ||
      (vec == 4 && (W % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(ell_all) % 16 != 0)))
    return cudaErrorInvalidValue;
  staged::Args a{};
  a.ell_rows = ell_rows;
  a.ell_all = ell_all;
  a.colors = colors;
  a.pri = pri;
  a.U = U;
  a.force = force;
  a.valid = valid;
  a.row_ids = row_ids;
  a.out_c = out_c;
  a.out_rec = out_rec;
  a.out_ovf = out_ovf;
  a.R = R;
  a.W = W;
  a.n = n;
  a.C = C;
  a.nW = (C + 31) / 32;
  a.row_start = row_start;
  a.window = window;
  a.detect = detect;
  return vec == 4 ? staged::launch<4, 2>(lanes, a, stream)
                  : staged::launch<1, 2>(lanes, a, stream);
}

// The groups resident at once (coloring_staged_shape in detect_recolor.cu).
cudaError_t twohop_staged_groups(int vec, int lanes, int W,
                                 long long* groups) {
  return vec == 4 ? staged::groups<4, 2>(lanes, W, groups)
                  : staged::groups<1, 2>(lanes, W, groups);
}

}  // namespace coloring

// 1 where the staged designs hold rows of W ids at `lanes` lanes a row, else
// 0: the shape rule's one home (kernels/twohop.py::staged_fits asks here).
extern "C" int coloring_twohop_staged_fits(int lanes, int W) {
  return coloring::staged::twohop_fits(lanes, W) ? 1 : 0;
}
