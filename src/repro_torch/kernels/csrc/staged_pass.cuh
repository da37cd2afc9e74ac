// The staged pass: one kernel template behind the repair pass
// (detect_recolor.cu, HOPS 1), first fit's design "vec16" (coloring.cu's
// coloring_firstfit, HOPS 1 with no candidate set: U null) and the staged
// designs of the distance-2 pass (twohop_staged.cu, HOPS 2).  See the notes
// at the top of those files for what each computes; this note is about how.
//
// The one-row-at-a-time kernels (pass_body in coloring.cu; the direct
// two-hop design in twohop.cu) run a dependent chain per row — the row's
// flags, its ids, (two hops: each neighbour's table row, in turn), the
// colours — and fold each colour into NW register words with an unrolled
// compare-and-select: little in flight per SM, and tens of instructions per
// slot.  Here:
//
//  * Persistent groups.  G lanes share a row (32 / G groups a warp, each
//    with its own slices of the warp's shared memory); the grid is as many
//    blocks as are resident at once, and a group walks rows gid, gid + T,
//    gid + 2T, ... (T groups in all).
//  * Rows that cannot work are found G at a time.  Each lane tests one
//    candidate row of the group's next G (valid & (U | force)) and writes
//    the unchanged outputs of a row that cannot work; a ballot leaves the
//    group the rows that can.  A late round with a handful of working rows
//    costs R / (T * G) such steps a group.  With U null (first fit) every
//    row works and nothing is read for the scan: no flag, no colour of the
//    row's own (R may exceed n there, and row r is no vertex).
//  * Detect only (HOPS 1, out_c null: CAT's separate detect pass).  The
//    defect test alone: no forbidden words, no mex, and only `recolored`
//    is written — the same flags as the full pass's `recolored`.
//  * Issue every copy before using any.  HOPS 1 copies the row's W ids
//    (the tile is one contiguous span; with row_ids one row of the full
//    table); HOPS 2 first packs the row's live ids into shared memory with
//    group ballots (in order: rows are left-packed) and then copies the
//    table rows of all live neighbours, flattened over (neighbour, chunk)
//    pairs so every lane copies live bytes.  cp.async, 16-B copies when a
//    row is a whole number of 16-B chunks and the table 16-B aligned (VEC
//    4), else, for HOPS 2 only, 4-B copies (VEC 1).  HOPS 1 has no 4-B
//    form: where its rows are not 16-B chunks the repair pass takes the
//    direct design (detect_recolor.cu).
//  * Double-buffered across rows: while row t's colours are gathered from
//    its stage, row t+1's ids are read and its copies are in flight into
//    the other buffer.  cp.async groups and __syncwarp only: no mbarrier,
//    nothing that can wait forever.
//  * Overlapped gathers: the stage is read kUnroll slots a lane at a time
//    and their colours loaded as independent loads; a priority only where
//    the colour equals the row's own (and the defect test decides).
//  * The forbidden words are in shared memory, one window of `window`
//    words a group: a live colour is one atomicOr on its word, and the mex
//    is the first word that is not all ones.  Colours outside [0, C) and
//    outside the window add nothing; a cap wider than the window is swept
//    window by window, stopping at the first free colour.
//  * A row larger than its stage slice (32 * G ints) is staged in batches;
//    every batch after the first, and every window after the first of a
//    row with more than one batch, is copied and waited for in turn.
//
// The result goes to newc (R,), never into colors: every row of a launch
// sees the pre-launch colours whatever the block order; the caller commits.
// Ids are clamped to [0, n-1], FILL (< 0) slots are dead, any R, W, C >= 1.
//
// Slot stride (HOPS 1 with row_ids, slot_rows > 0): the tables are S slots'
// stacked tables of slot_rows rows each (n = S * slot_rows), the row ids
// global; a row's ELL ids stay local to its slot, and neighbour id j is read
// at base + min(j, slot_rows - 1), base the first row of the row's slot.
// One launch then computes what S launches over the slots' own tables do.
// slot_rows 0 is the one-table pass (base 0, ids clamped to n - 1).
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "pass_common.cuh"

namespace coloring {
namespace staged {

// threads a block: 4 warps for the two-hop pass, 8 for the repair pass
// (measured faster each way on an H100)
template <int HOPS>
constexpr int kThreads = HOPS == 2 ? 128 : 256;
constexpr int kStages = 2;         // rows in the ring: kStages - 1 ahead
constexpr int kStageInts = 1024;   // stage ints a warp and buffer
constexpr int kIdsInts = 512;      // HOPS 2: live ids a warp and buffer
constexpr int kMaxWindow = 16;     // forbidden words a group
constexpr int kUnroll = 8;         // colour loads in flight a lane

struct Args {
  const int* ell_rows;          // (R, W) tile of the rows, or null
  const int* ell_all;           // the full (>= n, W) table (row_ids; hop 2)
  const int* colors;            // (n,)
  const int* pri;               // (n,), read only by the defect test
  const uint8_t* U;             // (R,), or null: every row works (first
                                //   fit; force / valid / row_ids null too)
  const int* forb0;             // (R, nW) or null (HOPS 1)
  const uint8_t* extra_defect;  // (R,) or null (HOPS 1)
  const uint8_t* force;         // (R,) or null
  const uint8_t* valid;         // (R,) or null
  const int* row_ids;           // (R,) or null
  int* out_c;                   // (R,), or null: detect only (HOPS 1;
                                //   out_ovf null too)
  uint8_t* out_rec;             // (R,), or null with U null
  uint8_t* out_ovf;             // (R,), or null with out_c null
  int R, W, n, C, nW, row_start, window;
  int slot_rows;                // HOPS 1 with row_ids: > 0 for the
                                //   slot-stride form (see below), else 0
  bool detect;                  // false: round 0, no defect test
};

// HOPS 2's shape rule: a group's stage slice holds one table row and a
// warp's id buffer its groups' rows.
inline bool twohop_fits(int lanes, int W) {
  return W >= 1 && lanes >= 1 && lanes <= 32 && 32 * lanes >= W &&
         (32 / lanes) * ((W + 3) & ~3) <= kIdsInts;
}

inline size_t smem_bytes(int G, int hops, int W) {
  const int groups = 32 / G;
  const int ids = hops == 2 ? groups * ((W + 3) & ~3) : 0;
  return static_cast<size_t>((hops == 2 ? kThreads<2> : kThreads<1>) / 32) *
         (kStages * (kStageInts + ids) + groups * kMaxWindow) * sizeof(int);
}

// An L2 policy that evicts first what it tags: the staged rows are read
// once a launch (or nearly), and must not push the colour vector out of L2.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

template <int VEC>
__device__ __forceinline__ void cp_async(int* dst, const int* src,
                                         unsigned long long policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "l"(policy) : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// Blocks an SM that the registers must allow: what shared memory allows at
// the widest tiles of the main path — six two-hop blocks at W 44 (registers
// capped at 85: no spills, where ptxas left to itself chose 64 and a few
// dozen bytes of spills, and a slower pass), three repair-pass blocks at
// W 512 (with one, ptxas took 84 registers and the card held two blocks)
template <int HOPS>
constexpr int kMinBlocks = HOPS == 2 ? 6 : 3;

template <int G, int VEC, int HOPS>
__global__ void __launch_bounds__(kThreads<HOPS>, kMinBlocks<HOPS>)
pass(const Args a) {
  static_assert(HOPS == 2 || VEC == 4, "the repair pass copies 16-B chunks");
  extern __shared__ __align__(16) int smem[];
  constexpr int kGroups = 32 / G;
  constexpr int kSub = kStageInts / kGroups;      // stage ints a group
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const int gin = (static_cast<int>(threadIdx.x) & 31) / G;
  const unsigned mask = group_mask<G>();
  const unsigned below = (1u << lane) - 1u;
  const int W = a.W, n = a.n, C = a.C, nW = a.nW, NWw = a.window;
  const int ids_warp = HOPS == 2 ? kGroups * ((W + 3) & ~3) : 0;
  // detect only: the defect test, and recolored the one output
  const bool only = HOPS == 1 && a.out_c == nullptr;
  int* const wbase = smem + (threadIdx.x >> 5) * (kStages * (kStageInts +
                                                             ids_warp) +
                                                  kGroups * kMaxWindow);
  int* const stage0 = wbase + gin * kSub;         // buffer b: + b*kStageInts
  int* const ids0 = wbase + kStages * kStageInts + gin * ((W + 3) & ~3);
  unsigned* const words = reinterpret_cast<unsigned*>(
      wbase + kStages * (kStageInts + ids_warp)) + gin * kMaxWindow;
  // a batch: kb neighbour rows (HOPS 2) or kb ids of the row (HOPS 1)
  const int kb = HOPS == 2 ? kSub / W : kSub;
  const unsigned long long once = evict_first_policy();
  const long long T = static_cast<long long>(gridDim.x) * (kThreads<HOPS> / G);
  const long long gid =
      static_cast<long long>(blockIdx.x) * (kThreads<HOPS> / G) + threadIdx.x / G;

  auto row_ptr = [&](long long row, int vid) -> const int* {
    return a.row_ids != nullptr ? a.ell_all + static_cast<long long>(vid) * W
                                : a.ell_rows + row * W;
  };

  // ---- the group's next row that can work ----
  long long k0 = -G;       // candidate window: rows gid + (k0 + l) * T
  unsigned m = 0;          // its rows that can work, not yet taken
  int s_vid = 0, s_c = -1, s_bits = 0;            // this lane's candidate
  auto next = [&](long long& row, int& vid, int& c_r, int& bits) -> bool {
    while (m == 0) {
      k0 += G;
      if (gid + k0 * T >= a.R) return false;       // uniform in the group
      const long long r = gid + (k0 + lane) * T;
      bool w = false;
      if (a.U == nullptr) {
        w = r < a.R;                               // first fit: every row
        s_bits = 1;
      } else if (r < a.R) {
        const long long v = a.row_ids != nullptr
                                ? min(max(a.row_ids[r], 0), n - 1)
                                : a.row_start + r;
        const int c = a.colors[v];
        const bool in_u = a.U[r] != 0;
        const bool forced = a.force != nullptr && a.force[r] != 0;
        w = (a.valid == nullptr || a.valid[r] != 0) && (in_u || forced);
        if (!w) {
          if (!only) {
            a.out_c[r] = c;
            a.out_ovf[r] = 0;
          }
          a.out_rec[r] = 0;
        }
        s_vid = static_cast<int>(v);
        s_c = c;
        s_bits = (in_u ? 1 : 0) | (forced ? 2 : 0);
      }
      m = group_ballot<G>(mask, w);
    }
    const int l = __ffs(m) - 1;
    m &= m - 1;
    row = gid + (k0 + l) * T;
    vid = __shfl_sync(mask, s_vid, l, G);
    c_r = __shfl_sync(mask, s_c, l, G);
    bits = __shfl_sync(mask, s_bits, l, G);
    return true;
  };

  // ---- HOPS 2: pack the row's live ids into buffer buf; the item count ----
  auto load_row = [&](long long row, int vid, int buf) -> int {
    if constexpr (HOPS == 1) {
      return W;
    } else {
      const int* __restrict__ er = row_ptr(row, vid);
      int* ids = ids0 + buf * ids_warp;
      int L = 0;
      for (int j0 = 0; j0 < W; j0 += 4 * G) {
        int v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * G + lane;
          v[u] = j < W ? er[j] : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned b = group_ballot<G>(mask, v[u] >= 0);
          if (v[u] >= 0) ids[L + __popc(b & below)] = v[u];
          L += __popc(b);
        }
      }
      __syncwarp(mask);
      return L;
    }
  };

  // ---- copy batch b into buffer buf's stage; one commit ----
  auto issue = [&](int b, long long row, int vid, int items, int buf) {
    int* st = stage0 + buf * kStageInts;
    const int nb = min(kb, items - b * kb);
    if constexpr (HOPS == 1) {
      const int* src = row_ptr(row, vid) + b * kb;
      for (int f = lane; f < (nb >> 2); f += G)
        cp_async<4>(st + 4 * f, src + 4 * f, once);
    } else {
      // flattened over (neighbour, chunk): every lane copies live bytes
      const int* ids = ids0 + buf * ids_warp + b * kb;
      const int cpr = W / VEC;                    // chunks a row
      for (int f = lane; f < nb * cpr; f += G) {
        const int q = f / cpr, ch = f - q * cpr;
        const long long s = min(ids[q], n - 1);
        cp_async<VEC>(st + q * W + ch * VEC, a.ell_all + s * W + ch * VEC,
                      once);
      }
    }
    cp_commit();
  };

  // ---- OR the colours of src[0, len) into the window's words ----
  // the window is colours [lo, lo + span): word (c - lo) >> 5
  // ids are read at base + min(id, lim - 1): base 0 and lim n, or, in the
  // slot-stride form, the row's slot's first row and the slot's rows
  auto gather = [&](const int* src, int len, int self, int lo, int span,
                    bool probe, int c_r, int p_r, bool& defect, int base,
                    int lim) {
    for (int f0 = 0; f0 < len; f0 += kUnroll * G) {
      int s[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int f = f0 + u * G + lane;
        const int id = f < len ? src[f] : -1;
        s[u] = (id < 0 || id == self) ? -1 : base + min(id, lim - 1);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        c[u] = s[u] < 0 ? -1 : __ldg(a.colors + s[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // probe implies c_r >= 0, so c[u] == c_r means a live slot
        if (probe && c[u] == c_r && __ldg(a.pri + s[u]) > p_r) defect = true;
        const unsigned d = static_cast<unsigned>(c[u] - lo);  // -1: huge
        if (d < static_cast<unsigned>(span))
          atomicOr(words + (d >> 5), 1u << (d & 31));
      }
    }
  };

  // ---- the row's pass from its staged first batch; writes its outputs ----
  auto consume = [&](long long row, int vid, int c_r, int bits, int items,
                     int buf) {
    const bool in_u = (bits & 1) != 0, forced = (bits & 2) != 0;
    const bool test = a.detect && in_u && !forced && c_r >= 0;
    const int p_r = test ? a.pri[vid] : -1;
    const int* st = stage0 + buf * kStageInts;
    const int nbat = (items + kb - 1) / kb;
    // slot stride (HOPS 1): the row's neighbours lie in its own slot
    const int base = a.slot_rows > 0 ? vid - vid % a.slot_rows : 0;
    const int lim = a.slot_rows > 0 ? a.slot_rows : n;
    bool defect = false;
    int mex = -1;
    for (int wb = 0; wb < nW && mex < 0; wb += NWw) {
      if (!only) {
        for (int k = lane; k < NWw; k += G) {
          unsigned x = tail_word(wb + k, C);
          if (a.forb0 != nullptr && wb + k < nW)
            x |= static_cast<unsigned>(a.forb0[row * nW + wb + k]);
          words[k] = x;
        }
      }
      __syncwarp(mask);
      const bool probe = test && wb == 0;
      // detect only: span 0 folds no colour into the (unused) words
      const int lo = wb * 32, span = only ? 0 : min(C - lo, NWw * 32);
      if constexpr (HOPS == 2)                       // hop 1: the live ids
        gather(ids0 + buf * ids_warp, items, -1, lo, span, probe, c_r, p_r,
               defect, 0, n);
      // detect only: a row that is not tested reads nothing (uniform in
      // the group: c_r and bits are the group's)
      for (int b = 0; b < (only && !probe ? 0 : nbat); ++b) {
        if (b > 0 || (wb > 0 && nbat > 1)) {
          __syncwarp(mask);            // every lane is done with the stage
          issue(b, row, vid, items, buf);
          cp_wait<0>();
          __syncwarp(mask);
        }
        const int len = HOPS == 2 ? min(kb, items - b * kb) * W
                                  : min(kb, items - b * kb);
        gather(st, len, HOPS == 2 ? vid : -1, lo, span, probe, c_r, p_r,
               defect, base, lim);
      }
      __syncwarp(mask);
      if (only) break;
      for (int k = 0; k < NWw; ++k) {
        const unsigned x = words[k];
        if (x != 0xFFFFFFFFu) {
          mex = (wb + k) * 32 + __ffs(~x) - 1;
          break;
        }
      }
      __syncwarp(mask);                // read before the next window's init
    }
    const bool ovf = mex < 0;
    if (ovf) mex = 0;
    defect = __any_sync(mask, defect) != 0;
    if (a.extra_defect != nullptr && a.extra_defect[row] != 0) defect = true;
    const bool work = forced || (in_u && (a.detect ? defect : true));
    if (lane == 0) {
      if (!only) {
        a.out_c[row] = work ? mex : c_r;
        a.out_ovf[row] = (ovf && work) ? 1 : 0;
      }
      if (a.out_rec != nullptr) a.out_rec[row] = work ? 1 : 0;
    }
  };

  // ---- the ring over the group's rows: kStages - 1 rows ahead ----
  struct Row {
    long long row;
    int vid, c_r, bits, items;
    bool ok;
  };
  Row q[kStages];                        // q[0]: the row consumed next
  auto fetch = [&](Row& r, int buf) {
    r.ok = next(r.row, r.vid, r.c_r, r.bits);
    if (r.ok) {
      r.items = load_row(r.row, r.vid, buf);
      issue(0, r.row, r.vid, r.items, buf);
    } else {
      cp_commit();                       // one group a row, always
    }
  };
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i) fetch(q[i], i);
  int head = 0;                          // q[i] sits in buffer head + i
  while (q[0].ok) {
    fetch(q[kStages - 1], (head + kStages - 1) % kStages);
    cp_wait<kStages - 1>();              // q[0]'s copies have landed
    __syncwarp(mask);
    consume(q[0].row, q[0].vid, q[0].c_r, q[0].bits, q[0].items, head);
    __syncwarp(mask);                    // its buffers are free again
#pragma unroll
    for (int i = 0; i + 1 < kStages; ++i) q[i] = q[i + 1];
    head = (head + 1) % kStages;
  }
}

// The groups resident at once for a launch of W-wide rows (the persistent
// grid's size when the rows outnumber them), after the shared-memory opt-in.
// Remembered per (device, shared memory): the queries cost a short launch's
// host time.
template <int G, int VEC, int HOPS>
cudaError_t resident_groups(int W, long long* groups) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> memo;
  auto kern = pass<G, VEC, HOPS>;
  const size_t smem = smem_bytes(G, HOPS, W);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto it = memo.find(key);
  if (it != memo.end()) {
    *groups = it->second;
    return cudaSuccess;
  }
  int sms = 0, optin = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  // dynamic shared memory above 48 KB only by opt-in: the device's whole
  // limit, once, so that no width's launch finds a smaller one set
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads<HOPS>, smem);
  if (e != cudaSuccess) return e;
  *groups = memo[key] = static_cast<long long>(std::max(per_sm, 1)) * sms *
                        (kThreads<HOPS> / G);
  return cudaSuccess;
}

template <int G, int VEC, int HOPS>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  long long resident = 0;
  const cudaError_t e = resident_groups<G, VEC, HOPS>(a.W, &resident);
  if (e != cudaSuccess) return e;
  // persistent: the blocks resident at once, never more than the rows need
  const long long groups = kThreads<HOPS> / G;
  const long long blocks =
      (std::min<long long>(a.R, resident) + groups - 1) / groups;
  pass<G, VEC, HOPS><<<static_cast<unsigned>(blocks), kThreads<HOPS>,
                               smem_bytes(G, HOPS, a.W), stream>>>(a);
  return cudaGetLastError();
}

// Calls f(integral_constant<int, G>) for lanes in 1..32 (a power of two).
template <typename F>
cudaError_t pick_lanes(int lanes, F&& f) {
  using std::integral_constant;
  switch (lanes) {
    case 1:  return f(integral_constant<int, 1>{});
    case 2:  return f(integral_constant<int, 2>{});
    case 4:  return f(integral_constant<int, 4>{});
    case 8:  return f(integral_constant<int, 8>{});
    case 16: return f(integral_constant<int, 16>{});
    case 32: return f(integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

// window in 1..kMaxWindow.
template <int VEC, int HOPS>
cudaError_t launch(int lanes, const Args& a, cudaStream_t stream) {
  if (a.window < 1 || a.window > kMaxWindow) return cudaErrorInvalidValue;
  return pick_lanes(lanes, [&](auto g) {
    return launch_g<decltype(g)::value, VEC, HOPS>(a, stream);
  });
}

template <int VEC, int HOPS>
cudaError_t groups(int lanes, int W, long long* out) {
  return pick_lanes(lanes, [&](auto g) {
    return resident_groups<decltype(g)::value, VEC, HOPS>(W, out);
  });
}

}  // namespace staged
}  // namespace coloring
