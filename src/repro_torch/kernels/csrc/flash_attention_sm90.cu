// Hand-written Hopper (sm_90a) forward attention kernel, bfloat16, head dim
// 64, 80, 96 or 128 — the design that serves every bfloat16 call of B5 at
// those head dims (csrc/flash_attention.cu keeps float32 and D in {16, 32}):
//
//   attn_flash_sm90  replaces the Pallas kernel
//                    src/repro/kernels/flash_attention.py::flash_attention
//                    (body _flash_kernel), called by attn_flash_forward
//
// What it computes is B5's function with B5's rounding (see the note in
// csrc/flash_attention.cu): scores in f32, a key >= Lk scores -inf, a
// causally hidden key -1e30, the running max starts at -1e30, alpha =
// exp(m_old - m_new), l sums the f32 p, p is rounded to bfloat16 before P.V,
// the output is acc / max(l, 1e-30) rounded once to bfloat16.  Where the
// arithmetic differs in the last bits: the exponentials are 2^x on the
// special-function unit (ex2.approx, relative error below 2^-22, results
// below 2^-126 flushed to 0) of scores that carry scale * log2(e) — folded
// into the exponent's FMA on tiles without masks — and the f32 sums run in
// the tensor cores' order.
//
// What bounds it: operations.  At prefill shapes 4 * B * Hq * D FLOPs per
// visible (query, key) pair against B * (Hq * Lq + 2 * Hkv * Lk) * D
// elements moved: the card's bf16 tensor-core rate (989 TFLOP/s dense) is
// the bound, which only wgmma reaches.  The design is FlashAttention-3's
// layout:
//  * one CTA of three warpgroups per (query tile of 128 rows, query head,
//    batch).  Warpgroup 0 is the producer: it gives registers back
//    (setmaxnreg 40) and one thread issues every load.  Warpgroups 1 and 2
//    are consumers of 64 query rows each (setmaxnreg 232) and share every
//    K / V tile, which halves the shared-memory traffic per FLOP against one
//    consumer.  Query tiles are launched longest causal row first (the
//    slowest grid dimension runs backwards), so the causal tail does not
//    leave SMs idle at the end;
//  * loads are TMA: Q once, K and V tiles of kBK = 128 keys (64-key tiles
//    measured 13-21 % slower at D 128: PERF.md) into a ring of two
//    stages, full barriers per K and per V, and separate empty barriers for
//    K (released as soon as Q . K^T has read it) and V, in 64-column panels
//    of 128-byte rows with the 128-byte swizzle that wgmma reads without
//    bank conflicts.  The tensor maps are 4-D (D, L, H, B) over the caller's
//    strides (any view whose last dimension is contiguous), so the hardware
//    zero-fills at each head's L: rows past Lq / Lk read zeros, never the
//    next head's rows — what makes ragged lengths safe;
//  * a head dim that is no multiple of 64 (D 80, qwen3-32b's; D 96,
//    minicpm3-4b's MLA 64 + 32) ends in a tail panel of T = D % 64 columns
//    (16 or 32) with rows of 2T bytes: its own tensor maps for Q, K, V and
//    O, boxes of T columns, and the swizzle of that width (32-byte at D 80,
//    64-byte at D 96), which the tail's wgmma descriptors name.  Every panel
//    starts on a 1024-byte boundary (a multiple of each swizzle's period),
//    so the exact width costs no padded columns: no zero-filled 64-column
//    panel, whose 128 / D more work would leave the design slower than
//    SDPA (PERF.md);
//  * S = Q . K^T is wgmma m64n128k16 from shared memory (a K tile stored keys
//    x D is K-major for the B operand), f32 accumulators in registers: D / 16
//    k steps, four per 128-byte panel and one (D 80) or two (D 96) from the
//    tail;
//  * the online softmax runs in registers: the four lanes that hold a row's
//    accumulator fragment reduce its max with two shuffles; l is kept per
//    lane and reduced once at the end.  Masks (ragged last tile, the causal
//    diagonal) are applied only on the tiles that need them; tiles wholly
//    above a warpgroup's causal diagonal are not computed;
//  * O += P . V is wgmma m64nDk16 with P from registers: the f32 score
//    fragment packed into bfloat16 pairs is the A-register fragment (the
//    accumulator / A-operand identity of FlashAttention-3).  V stored keys x
//    D is MN-major for the B operand: the transpose bit is set and the
//    descriptor's leading offset steps from one 64-column panel to the next.
//    With a tail, m64n64k16 on the main panel and m64n16k16 / m64n32k16 on
//    the tail, into two slices of one accumulator array: a single
//    m64n80k16 / m64n96k16 would need one V layout of 80 / 96 columns,
//    which the 128-byte MN-major swizzle (64 columns an atom) cannot give;
//  * overlap: each consumer issues S of tile t together with P . V of tile
//    t - 1, so its softmax of tile t runs while the tensor cores do P . V;
//    and the two consumers take turns to issue (ping-pong on two named
//    barriers), so one's softmax runs while the other's products do;
//  * epilogue: acc / max(l, 1e-30) rounded once, written into the
//    warpgroup's own (no longer read) Q rows in the swizzled layout, and
//    stored by TMA (one store per panel, the tail's through its own map),
//    which clips rows >= Lq: no row >= Lq is ever written.
// Measured (PERF.md): about 60 % of the bf16 bound at L = 8192 (D 128),
// faster than PyTorch's SDPA on the same inputs at L >= 2048; D 80 / 96 in
// PERF.md's B5 row.  Left for later: 64-row
// query tiles (short prompts launch fewer CTAs than the card has SMs) and a
// persistent grid that overlaps one tile's epilogue with the next's loads.
//
// Plain C interface, no PyTorch headers: launches on the given stream, does
// not synchronise, allocates nothing and returns a cudaError_t as int.  The
// tensor maps are encoded on the host with cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint (no link against libcuda).

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per CTA, 64 per consumer
constexpr int kBK = 128;            // keys per K / V tile
constexpr int kStages = 2;          // K / V ring
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kPanel = 64;          // bf16 columns per 128-byte panel
constexpr float kMasked = -1e30f;   // the TPU kernel's hidden score

// wgmma descriptor layout types (bits 62-63): the swizzle of the operand
constexpr uint32_t kSw128 = 1, kSw64 = 2, kSw32 = 3;

// The panels of head dim D: NP full 64-column panels of 128-byte rows, then
// (T > 0) one tail panel of T columns, rows of 2T bytes, swizzled on that
// width (T 16: 32-byte swizzle; T 32: 64-byte)
template <int D>
struct Panels {
  static constexpr int NP = D / kPanel;
  static constexpr int T = D % kPanel;
  static_assert(T == 0 || T == 16 || T == 32, "tail of 16 or 32 columns");
  static constexpr uint32_t kTailRow = 2 * T;            // bytes a tail row
  static constexpr uint32_t kTailType = T == 16 ? kSw32 : kSw64;
  // the tail's swizzle, as the 16-byte chunk index of row r is XORed: bits
  // 4.. of the address with bits 7.. (CUTLASS's Swizzle<1 or 2, 4, 3>)
  static __device__ __forceinline__ uint32_t tail_xor(int r) {
    return T == 16 ? (r >> 2) & 1 : (r >> 1) & 3;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (the swizzle).  K-major operand (Q,
// K): rows as wide as the swizzle (128, 64 or 32 bytes), 8-row groups 8 rows
// apart (stride offset), leading offset unused (16); a k step of 16 columns
// starts 32 bytes further into the row.  MN-major operand (V): the stride
// offset steps 8 keys, the leading offset one swizzle atom of columns (a
// 64-column panel; unused where N is one atom wide, as on the tail).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t type) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(type) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16, K-major) . B (128 x 16, K-major)^T (+ d
// if acc), both bf16 read from shared memory through their descriptors
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64),
// B bf16 in shared memory stored MN-major (keys x 64): transpose bit set
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 128),
// B bf16 in shared memory stored MN-major (keys x 128): transpose bit set
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32) += A (64 x 16, registers) . B (16 x 16), B MN-major in
// shared memory: the tail of D 80
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, registers) . B (16 x 32), B MN-major in
// shared memory: the tail of D 96
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the special-function unit: relative error below 2^-22, a result
// below 2^-126 flushed to 0 (a p or alpha that small is lost in the f32 sums
// anyway); -inf gives 0.  exp2f would add range handling around the same
// instruction.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // round to nearest even, lo in the low half: the A fragment's order
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// named barriers of the two consumer warpgroups (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t id, uint32_t n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory: the Q tile (NP panels of 128 rows x 128 bytes, then the
// tail panel of 128 rows x 2T bytes), then per stage a K tile and a V tile
// (the same panels of kBK rows each), then the barriers; every panel starts
// on a 1024-byte boundary (a multiple of each swizzle's period: every panel
// is a multiple of 1024 bytes long), the base is rounded up to one.
template <int D>
struct Layout {
  using P = Panels<D>;
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kTileBytes = kBK * D * 2;   // one K or V tile
  static constexpr uint32_t kQPanel = kBQ * 128;
  static constexpr uint32_t kKVPanel = kBK * 128;
  static constexpr uint32_t kQTail = P::NP * kQPanel;    // offsets of the
  static constexpr uint32_t kKVTail = P::NP * kKVPanel;  // tail panels
  static_assert(kQTail % 1024 == 0 && kQBytes % 1024 == 0 &&
                    kTileBytes % 1024 == 0,
                "panels on the 128-byte swizzle's period");
  static constexpr uint32_t kBars = kQBytes + kStages * 2 * kTileBytes;
  // q_full, then full_k, full_v, empty_k, empty_v (kStages each)
  static constexpr uint32_t kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;
  static __device__ __forceinline__ uint32_t k(uint32_t base, int s) {
    return base + kQBytes + s * 2 * kTileBytes;
  }
  static __device__ __forceinline__ uint32_t v(uint32_t base, int s) {
    return k(base, s) + kTileBytes;
  }
  static __device__ __forceinline__ uint32_t q_full(uint32_t base) {
    return base + kBars;
  }
  static __device__ __forceinline__ uint32_t full_k(uint32_t base, int s) {
    return base + kBars + 8 * (1 + s);
  }
  static __device__ __forceinline__ uint32_t full_v(uint32_t base, int s) {
    return base + kBars + 8 * (1 + kStages + s);
  }
  static __device__ __forceinline__ uint32_t empty_k(uint32_t base, int s) {
    return base + kBars + 8 * (1 + 2 * kStages + s);
  }
  static __device__ __forceinline__ uint32_t empty_v(uint32_t base, int s) {
    return base + kBars + 8 * (1 + 3 * kStages + s);
  }
};

// S = Q . K^T of one key tile into sc: D / 16 k steps of 16 columns, four
// per 128-byte panel, then T / 16 from the tail panel in its swizzle (q_rows
// and q_tail: this warpgroup's 64 rows of the Q tile's main and tail
// panels); issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_rows,
                                         uint32_t q_tail, uint32_t k_tile) {
  using S = Layout<D>;
  using P = Panels<D>;
  fence_regs<kBK / 2>(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * P::NP; ++kk)
    wgmma_ss_n128(sc,
                  smem_desc(q_rows + (kk / 4) * S::kQPanel + (kk % 4) * 32,
                            16, 1024, kSw128),
                  smem_desc(k_tile + (kk / 4) * S::kKVPanel + (kk % 4) * 32,
                            16, 1024, kSw128),
                  kk > 0);
#pragma unroll
  for (int kk = 0; kk < P::T / 16; ++kk)
    wgmma_ss_n128(sc,
                  smem_desc(q_tail + kk * 32, 16, 8 * P::kTailRow,
                            P::kTailType),
                  smem_desc(k_tile + S::kKVTail + kk * 32, 16,
                            8 * P::kTailRow, P::kTailType),
                  1);
  wgmma_commit();
}

// O += P . V of one key tile: kBK / 16 k steps of 16 keys (2048 bytes of a
// 128-byte V panel each); the leading offset steps from one 64-column panel
// to the next.  A tail adds m64n16k16 / m64n32k16 a step into the columns
// 64.. of o (16 keys of the tail panel: 16 rows of 2T bytes)
template <int D>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4],
                                         uint32_t v_tile) {
  using S = Layout<D>;
  using P = Panels<D>;
  fence_regs<D / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t main =
        smem_desc(v_tile + kk * 16 * 128, S::kKVPanel, 1024, kSw128);
    if constexpr (P::NP == 2) {
      wgmma_rs_n128(o, pa[kk], main);
    } else {
      wgmma_rs_n64(o, pa[kk], main);
    }
    if constexpr (P::T > 0) {
      const uint64_t tail =
          smem_desc(v_tile + S::kKVTail + kk * 16 * P::kTailRow,
                    kBK * P::kTailRow, 8 * P::kTailRow, P::kTailType);
      if constexpr (P::T == 16) {
        wgmma_rs_n16(o + kPanel / 2, pa[kk], tail);
      } else {
        wgmma_rs_n32(o + kPanel / 2, pa[kk], tail);
      }
    }
  }
  wgmma_commit();
}

// The online softmax of one key tile, in place: sc holds the raw scores
// q . k of rows r_in, r_in + 8 on entry and p = exp(s - m_new) (f32) on
// exit; m (scaled by scale * log2 e) and this lane's share of l are updated
// and alpha = exp(m_old - m_new) returned in a0, a1.  A tile that needs a
// mask gets its scores scaled and masked first (-inf past Lk, -1e30 above
// the causal diagonal: B5's values); an unmasked tile folds the scale into
// the exponent's FMA.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float* sc, bool masked, int k0,
                                             int row0, int lane, int Lk,
                                             int off, float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& a0,
                                             float& a1) {
  float mul = scale_log2;
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const int row = row0 + ((i & 2) ? 8 : 0);
      float x = sc[i] * scale_log2;
      if (col >= Lk) {
        x = -INFINITY;                   // a padding key: no weight at all
      } else if (CAUSAL && col > row + off) {
        x = kMasked;
      }
      sc[i] = x;
    }
    mul = 1.f;
  }
  float r0 = -INFINITY, r1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    r0 = fmaxf(r0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    r1 = fmaxf(r1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // the scale is positive: the max of the scaled scores is the scaled max
  float mx0 = fmaxf(m0, r0 * mul), mx1 = fmaxf(m1, r1 * mul);
  // the four lanes lane & ~3 .. lane | 3 hold one row
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  a0 = exp2_approx(m0 - mx0);
  a1 = exp2_approx(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    sc[4 * j] = exp2_approx(fmaf(sc[4 * j], mul, -mx0));
    sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], mul, -mx0));
    sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], mul, -mx1));
    sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], mul, -mx1));
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// p rounded to bfloat16 pairs: the A fragment of P . V, k step kk holding
// keys 16 kk .. 16 kk + 15 (the accumulator / A-operand identity)
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float* o, float a0, float a1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

// grid (Hq, B, query tiles); blockIdx.z runs the query tiles backwards
// tq, tk, tv, to: the 64-column panels' maps; tq2 .. to2 the tail's (T
// columns, its swizzle; unused where D has no tail)
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               const __grid_constant__ CUtensorMap tq2,
               const __grid_constant__ CUtensorMap tk2,
               const __grid_constant__ CUtensorMap tv2,
               const __grid_constant__ CUtensorMap to2, int Hq, int Hkv,
               int Lq, int Lk, float scale_log2) {
  using S = Layout<D>;
  using P = Panels<D>;
  constexpr int NP = P::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int hk = h / (Hq / Hkv);
  const int off = Lk - Lq;
  // the key tiles any row of this CTA can see
  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int n_tiles =
      ((CAUSAL ? min(Lk, q_last + off + 1) : Lk) + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(S::q_full(base), 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(S::full_k(base, s), 1);
      mbar_init(S::full_v(base, s), 1);
      mbar_init(S::empty_k(base, s), 2);   // one arrival per consumer
      mbar_init(S::empty_v(base, s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(S::q_full(base), S::kQBytes);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(base + p * S::kQPanel, &tq, S::q_full(base), p * kPanel, q0,
                 h, b);
      if constexpr (P::T > 0)
        tma_load(base + S::kQTail, &tq2, S::q_full(base), NP * kPanel, q0, h,
                 b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        // the n-th fill of a stage waits for the consumers' n-th release
        const uint32_t par = ((kt / kStages) & 1) ^ 1;
        mbar_wait(S::empty_k(base, s), par);
        mbar_expect_tx(S::full_k(base, s), S::kTileBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(S::k(base, s) + p * S::kKVPanel, &tk, S::full_k(base, s),
                   p * kPanel, kt * kBK, hk, b);
        if constexpr (P::T > 0)
          tma_load(S::k(base, s) + S::kKVTail, &tk2, S::full_k(base, s),
                   NP * kPanel, kt * kBK, hk, b);
        mbar_wait(S::empty_v(base, s), par);
        mbar_expect_tx(S::full_v(base, s), S::kTileBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(S::v(base, s) + p * S::kKVPanel, &tv, S::full_v(base, s),
                   p * kPanel, kt * kBK, hk, b);
        if constexpr (P::T > 0)
          tma_load(S::v(base, s) + S::kKVTail, &tv2, S::full_v(base, s),
                   NP * kPanel, kt * kBK, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r_in = (t / 32) * 16 + lane / 4;   // fragment row (and +8)
    const int wq0 = q0 + c * 64;                  // this warpgroup's rows
    const int row0 = wq0 + r_in;
    int n_mine = 0;                               // its visible key tiles
    if (wq0 < Lq) {
      const int wq_last = min(wq0 + 64, Lq) - 1;
      n_mine =
          CAUSAL ? (min(Lk, wq_last + off + 1) + kBK - 1) / kBK : n_tiles;
    }
    // a tile needs masks if it holds keys >= Lk or keys above the causal
    // diagonal of this warpgroup's first row
    auto masked = [&](int kt) {
      return kt * kBK + kBK > Lk ||
             (CAUSAL && kt * kBK + kBK - 1 > wq0 + off);
    };
    // Ping-pong: the consumers take turns to issue their products (named
    // barriers 3 + c), so that one's softmax runs while the other's wgmma
    // has the tensor cores.  Each takes n_tiles + 1 turns (QK of tile 0;
    // QK of tile t with PV of tile t - 1; PV of the last tile; empty turns
    // for tiles it does not compute).  Consumer 0 goes first: consumer 1
    // opens its first turn (a warp arrives at most once per barrier phase,
    // so consumer 0 cannot open its own), and the last turn of consumer 1
    // passes to no one.
    const uint32_t my_turn = 3 + c, next_turn = 4 - c;
    const int n_turns = n_tiles + 1;
    int turn = 0;
    if (c == 1) bar_arrive(next_turn, 256);
    // accumulator fragment of m64nDk16: o[4j + e] is row r_in + 8 * (e / 2),
    // column 8 j + 2 (lane % 4) + e % 2
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kMasked, m1 = kMasked;   // running max (scaled), rows r_in, +8
    float l0 = 0.f, l1 = 0.f;           // this lane's share of the sums
    float a0 = 1.f, a1 = 1.f;           // alpha of the last softmax
    float sc[kBK / 2];                  // scores, then p
    uint32_t pa[kBK / 16][4];           // p as the A fragment of P . V
    const uint32_t q_rows = base + c * 64 * 128;
    const uint32_t q_tail = base + S::kQTail + c * 64 * P::kTailRow;

    if (n_mine > 0) {
      // turn 0: S = Q . K^T of tile 0, then its softmax
      mbar_wait(S::q_full(base), 0);
      mbar_wait(S::full_k(base, 0), 0);
      bar_sync(my_turn, 256);
      issue_qk<D>(sc, q_rows, q_tail, S::k(base, 0));
      bar_arrive(next_turn, 256);
      ++turn;
      wgmma_wait<0>();
      fence_regs<kBK / 2>(sc);
      if (t == 0) mbar_arrive(S::empty_k(base, 0));
      softmax_tile<CAUSAL>(sc, masked(0), 0, row0, lane, Lk, off,
                               scale_log2, m0, m1, l0, l1, a0, a1);
      pack_p(sc, pa);
    }
    for (int kt = 1; kt < n_mine; ++kt) {
      // turn kt: S = Q . K^T of tile kt and O += P . V of tile kt - 1 go to
      // the tensor cores together; the softmax of tile kt runs while P . V
      // does
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      const uint32_t par = (kt / kStages) & 1, parp = ((kt - 1) / kStages) & 1;
      mbar_wait(S::full_k(base, s), par);
      mbar_wait(S::full_v(base, sp), parp);
      bar_sync(my_turn, 256);
      issue_qk<D>(sc, q_rows, q_tail, S::k(base, s));
      rescale<D>(o, a0, a1);
      issue_pv<D>(o, pa, S::v(base, sp));
      if (turn < n_turns - 1 || c == 0) bar_arrive(next_turn, 256);
      ++turn;
      wgmma_wait<1>();                   // the scores of tile kt are in
      fence_regs<kBK / 2>(sc);
      if (t == 0) mbar_arrive(S::empty_k(base, s));
      softmax_tile<CAUSAL>(sc, masked(kt), kt * kBK, row0, lane, Lk, off,
                               scale_log2, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();                   // P . V of tile kt - 1 is done
      fence_regs<D / 2>(o);
      if (t == 0) mbar_arrive(S::empty_v(base, sp));
      pack_p(sc, pa);
    }
    if (n_mine > 0) {
      // turn n_mine: O += P . V of the last tile
      const int sp = (n_mine - 1) % kStages;
      mbar_wait(S::full_v(base, sp), ((n_mine - 1) / kStages) & 1);
      bar_sync(my_turn, 256);
      rescale<D>(o, a0, a1);
      issue_pv<D>(o, pa, S::v(base, sp));
      if (turn < n_turns - 1 || c == 0) bar_arrive(next_turn, 256);
      ++turn;
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      if (t == 0) mbar_arrive(S::empty_v(base, sp));
    }
    // key tiles of the CTA wholly hidden from this warpgroup's rows (or all
    // of them, where its rows are all past Lq): not computed (p = 0, alpha =
    // 1: the same result), only released once they have arrived (so that
    // each release counts for its own use), one empty turn each — the other
    // consumer's turns release the tiles these waits need
    for (int kt = n_mine; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      mbar_wait(S::full_k(base, s), par);
      mbar_wait(S::full_v(base, s), par);
      if (t == 0) {
        mbar_arrive(S::empty_k(base, s));
        mbar_arrive(S::empty_v(base, s));
      }
      bar_sync(my_turn, 256);
      if (turn < n_turns - 1 || c == 0) bar_arrive(next_turn, 256);
      ++turn;
    }
    if (turn < n_turns) {                // no tile at all: the last turn
      bar_sync(my_turn, 256);
      if (c == 0) bar_arrive(next_turn, 256);
      ++turn;
    }

    if (n_mine > 0) {
      // epilogue: acc / max(l, 1e-30), rounded once, into this warpgroup's
      // own Q rows (read by no one any more) in the swizzled layout, then
      // one TMA store per panel, which clips rows >= Lq; columns 64 NP..
      // go to the tail panel in its swizzle (rows r_in and r_in + 8 share
      // the chunk XOR of every swizzle)
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      const uint32_t sw = static_cast<uint32_t>(r_in % 8);
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const uint32_t row_at =
            q_rows + (j / 8) * S::kQPanel + r_in * 128 +
            ((static_cast<uint32_t>(j % 8) ^ sw) << 4) + (lane % 4) * 4;
        st_shared(row_at, pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0));
        st_shared(row_at + 8 * 128,
                  pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1));
      }
      const uint32_t swt = P::tail_xor(r_in);
#pragma unroll
      for (int j = 8 * NP; j < D / 8; ++j) {
        const uint32_t row_at =
            q_tail + r_in * P::kTailRow +
            ((static_cast<uint32_t>(j - 8 * NP) ^ swt) << 4) + (lane % 4) * 4;
        st_shared(row_at, pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0));
        st_shared(row_at + 8 * P::kTailRow,
                  pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_store(&to, q_rows + p * S::kQPanel, p * kPanel, wq0, h, b);
        if constexpr (P::T > 0)
          tma_store(&to2, q_tail, NP * kPanel, wq0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

// m: the eight tensor maps, q k v o, then their tails
template <int D, bool CAUSAL>
cudaError_t launch(const CUtensorMap* m, int B, int Hq, int Hkv, int Lq,
                   int Lk, float scale_log2, cudaStream_t stream) {
  constexpr uint32_t smem = Layout<D>::kBytes;
  auto kern = flash_fwd_sm90<D, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, B, (Lq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5],
                                         m[6], m[7], Hq, Hkv, Lq, Lk,
                                         scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_causal(int causal, const CUtensorMap* m, int B, int Hq,
                      int Hkv, int Lq, int Lk, float scale_log2,
                      cudaStream_t stream) {
  return causal ? launch<D, true>(m, B, Hq, Hkv, Lq, Lk, scale_log2, stream)
                : launch<D, false>(m, B, Hq, Hkv, Lq, Lk, scale_log2, stream);
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map (D, L, H, B) of a bfloat16 (B, H, L, D) tensor with element
// strides sb, sh, sl (the last dimension contiguous), boxes of cols columns
// x rows, the swizzle of a cols-wide row (64: 128-byte, 32: 64-byte, 16:
// 32-byte), zero fill past every dimension's end
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int H,
            int L, int D, long long sb, long long sh, long long sl, int rows,
            int cols) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the four maps of one panel width (q, k, v, out)
bool encode_all(EncodeTiled enc, CUtensorMap* m, const void* q, const void* k,
                const void* v, void* out, int B, int Hq, int Hkv, int Lq,
                int Lk, int D, const long long* st, int cols) {
  const long long o_sl = D, o_sh = static_cast<long long>(Lq) * D,
                  o_sb = o_sh * Hq;
  return encode(enc, &m[0], q, B, Hq, Lq, D, st[0], st[1], st[2], kBQ,
                cols) &&
         encode(enc, &m[1], k, B, Hkv, Lk, D, st[3], st[4], st[5], kBK,
                cols) &&
         encode(enc, &m[2], v, B, Hkv, Lk, D, st[6], st[7], st[8], kBK,
                cols) &&
         encode(enc, &m[3], out, B, Hq, Lq, D, o_sb, o_sh, o_sl, 64, cols);
}

bool tma_ok(const void* p, long long sb, long long sh, long long sl) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb > 0 && sh > 0 &&
         sl > 0 && sb % 8 == 0 && sh % 8 == 0 && sl % 8 == 0;
}

}  // namespace

// bfloat16 q (B, Hq, Lq, D), k / v (B, Hkv, Lk, D) with element strides
// (batch, head, row; the last dimension contiguous: multiples of 8 elements,
// 16-byte aligned base — bf16 rows of 160 and 192 bytes at D 80 / 96 keep
// the 16-byte rule), out contiguous.  D in {64, 80, 96, 128}: 64-column
// panels, and at D 80 / 96 a tail panel of 16 / 32 columns (the tail's
// maps: boxes of that width, 32- / 64-byte swizzle); Hkv divides Hq; B <=
// 65535, ceil(Lq / 128) <= 65535.  Called by attn_flash_forward
// (csrc/flash_attention.cu), which the wrapper calls.
extern "C" int attn_flash_sm90(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int causal, long long q_sb,
                               long long q_sh, long long q_sl,
                               long long k_sb, long long k_sh, long long k_sl,
                               long long v_sb, long long v_sh, long long v_sl,
                               float scale, cudaStream_t stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Lq < 1 || Lk < 1 ||
      B > 65535 || (Lq + kBQ - 1) / kBQ > 65535 ||
      (D != 64 && D != 80 && D != 96 && D != 128) ||
      !tma_ok(q, q_sb, q_sh, q_sl) || !tma_ok(k, k_sb, k_sh, k_sl) ||
      !tma_ok(v, v_sb, v_sh, v_sl) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long st[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                           v_sb, v_sh, v_sl};
  const int tail = D % kPanel;
  CUtensorMap maps[8];
  if (!encode_all(enc, maps, q, k, v, out, B, Hq, Hkv, Lq, Lk, D, st,
                  kPanel) ||
      !encode_all(enc, maps + 4, q, k, v, out, B, Hq, Hkv, Lq, Lk, D, st,
                  tail > 0 ? tail : kPanel))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
  cudaError_t e;
  switch (D) {
    case 64:
      e = by_causal<64>(causal, maps, B, Hq, Hkv, Lq, Lk, scale_log2, stream);
      break;
    case 80:
      e = by_causal<80>(causal, maps, B, Hq, Hkv, Lq, Lk, scale_log2, stream);
      break;
    case 96:
      e = by_causal<96>(causal, maps, B, Hq, Hkv, Lq, Lk, scale_log2, stream);
      break;
    default:
      e = by_causal<128>(causal, maps, B, Hq, Hkv, Lq, Lk, scale_log2,
                         stream);
  }
  return static_cast<int>(e);
}

// Dynamic shared memory a CTA of the variant of head dim D asks for, in
// bytes (0 for a variant that does not exist): what chip_smoke.py reports.
extern "C" int attn_flash_sm90_smem(int D) {
  switch (D) {
    case 64: return Layout<64>::kBytes;
    case 80: return Layout<80>::kBytes;
    case 96: return Layout<96>::kBytes;
    case 128: return Layout<128>::kBytes;
    default: return 0;
  }
}
