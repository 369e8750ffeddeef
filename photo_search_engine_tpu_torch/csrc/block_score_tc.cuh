// The tensor-core scan of every bf16 and int8 scan of the flat index with
// D % 8 == 0 (bf16) or D % 16 == 0 (int8): kernels 1, 3 and 5 (bf16,
// block_topk.cu), kernel 4 (bf16, fused_topk.cu) and kernels 2 and 6 (int8,
// int8_block_topk.cu); and of kernel 7, the IVF probed-cluster scan (bf16
// and int8, ivf_topk.cu), whose CTAs take their rows, queries and lists
// from a work list of probe pairs (IvfWork).  The same ring feeds the f32
// scans (kernels 1, 3, 4, 5 and 7 on float32 rows with D % 4 == 0): the F32
// operand swaps wgmma for IEEE fmaf consumers (ffma_pass, below).  TMA loads into a ring of
// shared-memory stages, one
// producer warp, two consumer warpgroups that run wgmma (bf16 with f32
// accumulators, or s8 with s32 accumulators), an epilogue into a score
// tile, and a threshold selection with a running top-k across passes
// (block_select.cuh): select_pass on exact f32 scores, or, for kernel 3
// (kKeys), select_pass_keys on the TPU's packed int32 keys.  Kernel 4
// launches kernel 1 with a range of blocks as the CTA's rows, so the running
// top-k of a CTA is the TPU kernel's running top-k over that range.  The
// operand trait (Bf16, S8) supplies what differs by type: the element size
// and tensor-map type, the wgmma instruction and its accumulator, and the
// epilogue's score; the ring, the producer, the passes and the selections
// are one copy.
//
// Operands.  Corpus rows are wgmma's M side (operand A, K-major: the
// corpus's own row-major [n, d] layout); the BQ queries of the CTA are its
// N side (operand B, K-major: the queries' [q, d] layout).  Nothing is
// transposed, which 8-bit wgmma could not do anyway (K-major only).  A
// corpus box is [kRowTile, kBoxK], a query box [BQ, kBoxK], both 128 bytes
// wide (kBoxK 64 bf16 or 128 int8) with the 128-byte swizzle that the wgmma
// descriptors name; a consumer warpgroup multiplies its 64 rows of a corpus
// box by the query box in 128 / 32 = 4 instructions (m64nBQk16 bf16,
// m64nBQk32 s8: 32 bytes of K each), advancing both descriptors 32 bytes
// along K inside the swizzle atom.  TMA fills rows past n and columns past d
// with zeros, so the ragged last block and a ragged D need no code.
//
// Passes.  A CTA scores its block of `bn` rows in passes of kPassRows = 512
// rows.  A pass keeps the scores of its 4 row tiles in registers (BQ / 2
// accumulators a tile and thread) and walks D once: for each 128-byte chunk
// one query box, then the 4 corpus boxes.  So a query box is read once a
// chunk and pass, not once a row tile: at BQ 32, 16 KB of corpus bring 1 KB
// of queries instead of 4 KB.  After the pass the epilogue (count, mask,
// predicate, the operand's score) writes a [BQ, 64 + 512] f32 score tile
// whose rows start with each query's running top-k of the earlier passes;
// select_pass replaces that list, or on the last pass writes the block's
// partials (kernel 3: select_pass_keys keys the tile's scores as it reads
// them and keeps a running list of keys).
//
// What bounds it (H100, 1M x 1536).  At batch <= 32 the corpus read from
// device memory: 0.92 ms bf16, 0.46 ms int8.  Above that the bytes the SMs
// take in: each query tile of 32 reads the corpus again (from L2), so bf16
// batch 128 moves 13 GB into the SMs, about 1.5 ms at the ~8.7 TB/s they
// take in (PERF.md), then the selection; int8 half of that.  A wider query
// tile would read less, but the f32 score tile of a wider one does not fit
// beside the ring.
//
// Shared memory (smem_bytes; the same for both operands, whose boxes have
// the same bytes).  The ring is kStages corpus boxes (16 KB) and
// kQueryStages query boxes; the tile is the score rows (pitch kListSlots +
// kPassRows + kPitchPad floats) and the warps' candidate buffers.  At BQ 32
// the tile (90,624 bytes) lies over the ring (73,728), which is idle once a
// pass's loads are used, and the producer waits for the selection before
// the next pass: 1,024 + 90,624 + 16,384 (lists) + 104 (mbarriers) =
// 108,136 bytes, two CTAs an SM, so one CTA's selection runs beside the
// other's loads.  At BQ 8 the tile (34,944) follows the ring (67,584) and
// the producer streams on: 107,752 bytes, two CTAs an SM.  The limit is
// 232,448 a CTA.  The pitch pad makes the epilogue's stores conflict-free:
// the eight rows and four query pairs of a warp's accumulator fragment land
// on 32 distinct banks.  Two CTAs of 288 threads leave 96 registers a
// thread: kernels 1 and 2 fit; at BQ 32 kernel 5 spills 84 bytes and kernel
// 6 384 (their predicate rows), and each runs within 2 % of its flat
// sibling (H100, PERF.md).  The grouped kernels score inner products only;
// at BQ 32 their epilogue compiles the l2 term out (see use_l2).
//
// Order of the sums.  bf16: every output element sums its products over D
// in the same order (16-wide steps, chunk after chunk), whatever its row's
// place in the tile, so duplicate rows score identically and tie exactly.
// The order is not the f32 fmaf loop's nor cuBLAS's: the tests compare with
// a tolerance (max |err| 4.8e-7 at 1536-d unit rows against the f32
// product).  s8: the s32 sum is exact (|sum| <= 127^2 * d < 2^31 for d <
// 133,000), so the order does not matter and kernels 2 and 6 equal their
// plain versions bit for bit.  f32 (F32): fmaf over d = 0 .. D - 1 in order
// from +0.0, the FMA loop's order (block_score.cuh), the columns TMA fills
// past d being its zero-staged ones, so the f32 ring's scores are the FMA
// loop's bit for bit.  Its CTA at BQ 32 holds kFfmaLargeDepth boxes a row
// tile (156,840 bytes: one CTA an SM), at BQ 8 the tensor cores' 107,752.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, the library does not link -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "block_select.cuh"

namespace pse {
namespace tc {

constexpr int kRowTile = 128;      // corpus rows a stage holds: two m64 warpgroups
constexpr int kSwizzleBytes = 128;  // a box's width in bytes: CU_TENSOR_MAP_SWIZZLE_128B, wgmma layout type 1
constexpr int kStages = 4;         // corpus stages of the ring of kernels 1-6
constexpr int kSweepStages = 6;    // the deeper ring scripts/torch_kernel_sweep.py also times
constexpr int kQueryStages = 2;    // query stages: one box serves a pass's row tiles
constexpr int kPassRows = 512;     // rows a pass keeps in the accumulators
constexpr int kPassTiles = 4;      // row tiles of a pass
constexpr int kPitchPad = 4;       // score-tile pitch kListSlots + kPassRows + 4 floats
constexpr int kAlign = 1024;       // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int kSmallBQ = 8;        // queries a CTA at q <= 8 (m64n8k16 / m64n8k32)
constexpr int kLargeBQ = 32;       // queries a CTA above that (m64n32k16 / m64n32k32)
constexpr int kConsumers = 256;    // warps 0-7: two consumer warpgroups, then the selection
constexpr int kThreadsTc = kConsumers + 32;  // and warp 8, the producer
constexpr int kWgmmaKBytes = 32;   // bytes of D one wgmma consumes (k16 bf16, k32 s8)
static_assert(kPassTiles * kRowTile == kPassRows, "a pass is whole row tiles");
static_assert((kListSlots + kPassRows + 32 * kSubsets - 1) / (32 * kSubsets) * kListSlots <= kKeyCandidates,
              "select_pass_keys: the positions of k subsets fit the candidate buffer");

// Shared memory of one CTA, in bytes from the aligned base: the ring
// (stages corpus boxes, then kQueryStages query boxes), over which a pass's
// score tile and the warps' candidate buffers are laid once the pass's
// loads are used; then the running top-k lists and the mbarriers.
template <int BQ>
__host__ __device__ constexpr int ring_bytes(int stages) {
  return stages * kRowTile * kSwizzleBytes + kQueryStages * BQ * kSwizzleBytes;
}

template <int BQ>
__host__ __device__ constexpr int tile_bytes() {
  return BQ * (kListSlots + kPassRows + kPitchPad) * 4 + 8 * (kCandidates + kListSlots) * 8;
}

// At BQ 32 the tile lies over the ring (two CTAs an SM, whose loads and
// selections overlap); at BQ 8 it has its own memory, so the producer
// streams on through the tile's selection (also two CTAs an SM).
template <int BQ>
__host__ __device__ constexpr bool tile_over_ring() {
  return BQ > kSmallBQ;
}

template <int BQ>
__host__ __device__ constexpr int union_bytes(int stages) {
  return !tile_over_ring<BQ>()                          ? ring_bytes<BQ>(stages) + tile_bytes<BQ>()
         : ring_bytes<BQ>(stages) > tile_bytes<BQ>() ? ring_bytes<BQ>(stages)
                                                       : tile_bytes<BQ>();
}

template <int BQ>
__host__ __device__ constexpr size_t smem_bytes(int stages) {
  return kAlign + union_bytes<BQ>(stages) + BQ * kListSlots * 8 + 8 * (2 * stages + 2 * kQueryStages + 1);
}

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// never ends (a load that cannot complete) traps after some seconds, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One box of `map` at element (x along D, y along rows) into `dst`; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                            int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle, starting on a swizzle atom: rows of 128 bytes, 8-row groups
// 1024 bytes apart (stride byte offset); the leading byte offset is unused
// by a swizzled K-major operand.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16: d += A (64 x 16, descriptor a) * B^T (BQ x 16, descriptor b): the
// accumulator fragment of m64nBQk16 is BQ / 2 floats a thread.
template <int BQ>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

// s8: d += A (64 x 32, descriptor a) * B^T (BQ x 32, descriptor b), exact in
// s32.  The integer form takes the scale-d predicate only: no scale or
// transpose immediates (8-bit operands are K-major).  Its fragment has the
// f32 fragment's layout: BQ / 2 ints a thread.
template <int BQ>
struct WgmmaS8;

template <>
struct WgmmaS8<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// Operand traits: what the bf16 and the int8 scans do differently
// ---------------------------------------------------------------------------

// bf16 (kernels 1 and 5): f32 accumulators; the score is the product, or
// for l2 -(|q|^2 + |c|^2 - 2 q.c), as in the TPU kernel.
struct Bf16 {
  using Acc = float;
  static constexpr bool kFfma = false;  // wgmma consumers
  static constexpr int kBytes = 2;
  static constexpr int kBoxK = kSwizzleBytes / kBytes;  // 64 elements a box row
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int BQ>
  using Mma = Wgmma<BQ>;
  struct Scales {
    const float* qnorms;  // [q], read for l2
    const float* cnorms;  // [n], read for l2
  };
  struct Row {
    float cn;
  };
  __device__ __forceinline__ static Row row(const Scales& s, int col, bool valid, int l2) {
    return Row{(l2 && valid) ? s.cnorms[col] : 0.f};
  }
  // The score of (row, query gq) from its accumulator; `l2` is false for a
  // row the epilogue drops.
  __device__ __forceinline__ static float score(float acc, const Scales& s, const Row& r, int gq, int q,
                                                bool l2) {
    if (!l2) return acc;
    const float qn = gq < q ? s.qnorms[gq] : 0.f;
    return -__fsub_rn(__fadd_rn(qn, r.cn), __fmul_rn(2.f, acc));
  }
};

// int8 (kernels 2 and 6): s32 accumulators; the score is the TPU kernel's
// (float(acc) * qscale) * cscale, in that order, or for l2 2 s - |c|^2 (the
// query norm is constant per query).
struct S8 {
  using Acc = int;
  static constexpr bool kFfma = false;
  static constexpr int kBytes = 1;
  static constexpr int kBoxK = kSwizzleBytes / kBytes;  // 128 elements a box row
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // bytes: TMA only copies them
  template <int BQ>
  using Mma = WgmmaS8<BQ>;
  struct Scales {
    const float* qscales;  // [q]
    const float* cscales;  // [n]
    const float* cnorms;   // [n] full-precision row norms, read for l2
  };
  struct Row {
    float cs, cn;
  };
  __device__ __forceinline__ static Row row(const Scales& s, int col, bool valid, int l2) {
    return Row{valid ? s.cscales[col] : 0.f, (l2 && valid) ? s.cnorms[col] : 0.f};
  }
  __device__ __forceinline__ static float score(int acc, const Scales& s, const Row& r, int gq, int q,
                                                bool l2) {
    const float qs = gq < q ? s.qscales[gq] : 0.f;
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), qs), r.cs);
    return l2 ? __fsub_rn(__fmul_rn(2.f, v), r.cn) : v;
  }
};

// ---------------------------------------------------------------------------
// The f32 consumers (F32): one pass of kPassRows rows in IEEE fmaf
// ---------------------------------------------------------------------------

constexpr int kFfmaRows = 8;        // rows a thread keeps: r0 + 16 i of its warp pair's row tile
constexpr int kFfmaStep = 2;        // f32 chunks of a box a loop step
constexpr int kFfmaLargeDepth = 2;  // f32 boxes in flight a row tile at BQ 32
constexpr int kFfmaTileThreads = kConsumers / kPassTiles;  // a warp pair a row tile
static_assert(kFfmaTileThreads * kFfmaRows * kSmallBQ / 4 == kRowTile * kSmallBQ, "a warp pair covers its tile");

// float32 (kernels 1, 3, 4, 5 and 7 on rows with D % 4 == 0): no tensor
// cores.  The ring is the same (an f32 box row is 32 floats, 128 bytes) and
// the consumers run IEEE fmaf on it (ffma_pass).  The score is bf16's, and
// kernel 7's l2 score (no query norms: its caller subtracts |q|^2) is the
// FMA loop's 2 acc - |c|^2, so that a zero keeps its sign.
struct F32 {
  using Acc = float;
  static constexpr bool kFfma = true;  // fmaf consumers
  static constexpr int kBytes = 4;
  static constexpr int kBoxK = kSwizzleBytes / kBytes;  // 32 elements a box row
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  using Scales = Bf16::Scales;
  using Row = Bf16::Row;
  __device__ __forceinline__ static Row row(const Scales& s, int col, bool valid, int l2) {
    return Bf16::row(s, col, valid, l2);
  }
  __device__ __forceinline__ static float score(float acc, const Scales& s, const Row& r, int gq, int q,
                                                bool l2) {
    if (l2 && s.qnorms == nullptr) return __fsub_rn(__fmul_rn(2.f, acc), r.cn);
    return Bf16::score(acc, s, r, gq, q, l2);
  }
};

// The f32 ring: each row tile has its own stages t, t + kPassTiles, ...,
// one a chunk in turn, so the warp pair that reads tile t consumes every
// fill of its stages in order.  (A shared rotation, the wgmma consumers'
// way, would let a pass of fewer than kPassTiles tiles give a stage's
// fills to different warp pairs, and one pair could wait on a parity two
// fills ahead of the barrier and read a stale box.)  BQ 8: one stage a
// tile, two CTAs an SM (16 accumulators and 2 queries' 8 floats a thread
// fit the cap of 96 registers).  BQ 32: 64 accumulators and the 32 floats
// of 8 queries do not (with 4 queries at once they spilled and ran
// slower), so one CTA an SM (a cap of 168: 9 warps over 4
// SMSPs' register files), whose shared memory holds kFfmaLargeDepth boxes
// a tile.
template <int BQ>
__host__ __device__ constexpr int ffma_stages() {
  return kPassTiles * (BQ > kSmallBQ ? kFfmaLargeDepth : 1);
}

template <int BQ>
__host__ __device__ constexpr int ffma_ctas() {
  return BQ > kSmallBQ ? 1 : 2;
}

template <int kStagesT>
__device__ __forceinline__ int ffma_stage(int chunk, int tile) {
  return (chunk % (kStagesT / kPassTiles)) * kPassTiles + tile;
}

// The products of this thread's rows and queries over one box (32 floats of
// D): `rows` is its first row r0 in the corpus box (rows r0 + 16 i are 16
// box rows apart, r0 % 8 == rl), `qbox` the query box; queries qg + 4 j.
// Each output is acc = fmaf(q[d], c[d], acc), d in order: the FMA loop's
// order (block_score.cuh).  The 128-byte swizzle puts 16-byte chunk c of
// box row r at chunk c ^ (r % 8), so a load's 8 rows (r % 8 = 0..7) lie in
// 8 bank quads and its 4 queries (q % 8 = qg or qg + 4) in 4, each read by
// 4 or 8 lanes at once (a broadcast).  A thread holds its queries' 4
// floats of a chunk and streams its rows': at BQ 32, 16 16-byte loads for
// 256 fmaf.  (Loads spread through the fmaf stream by hand, or all rows'
// and queries' chunks held for 4 outer products, ran no faster on the H100.)
template <int kQ>
__device__ __forceinline__ void ffma_box(float (&acc)[kFfmaRows][kQ], const float* rows, const float* qbox,
                                         int rl, int qg) {
  const float* qrow = qbox + qg * 32;
#pragma unroll 1
  for (int c0 = 0; c0 < 8; c0 += kFfmaStep) {  // the box row's 16-byte chunks
#pragma unroll
    for (int c = c0; c < c0 + kFfmaStep; ++c) {
      const int cr = (c ^ rl) * 4;
      const int cq0 = (c ^ qg) * 4, cq1 = (c ^ (qg + 4)) * 4;  // queries qg + 4 j, j even / odd
      float4 qv[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) qv[j] = *reinterpret_cast<const float4*>(qrow + j * 128 + ((j & 1) ? cq1 : cq0));
#pragma unroll
      for (int i = 0; i < kFfmaRows; ++i) {
        const float4 cv = *reinterpret_cast<const float4*>(rows + i * 16 * 32 + cr);
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          float a = acc[i][j];
          a = fmaf(qv[j].x, cv.x, a);
          a = fmaf(qv[j].y, cv.y, a);
          a = fmaf(qv[j].z, cv.z, a);
          a = fmaf(qv[j].w, cv.w, a);
          acc[i][j] = a;
        }
      }
    }
  }
}

// One pass of the f32 consumers, and its epilogue into the score tile.
// Warps 2t and 2t + 1 own row tile t of every chunk: they wait for that
// box only (in stage ffma_stage(chunk, t)), and release it
// (kFfmaTileThreads arrivals) once read; every consumer releases the query
// box.  Lane l keeps rows r0 + 16 i, r0 = 8 (warp % 2) + l % 8, and
// queries l / 8 + 4 j, j < BQ / 4: 8 x 8 f32 accumulators at BQ 32, 8 x 2
// at BQ 8.  `chunk` counts the chunks of every pass so far and bit s of
// `full_bits` is the parity of stage s's next fill, as the producer keeps
// them.
template <typename Op, int BQ, int kStagesT, bool kGrouped>
__device__ __forceinline__ void ffma_pass(const uint8_t* ring, const uint8_t* qring, uint64_t* cfull,
                                          uint64_t* cempty, uint64_t* qfull, uint64_t* qempty, int& chunk,
                                          uint32_t& full_bits, int& qs, uint32_t& qph, int chunks, int ptiles,
                                          int prows, float* scores, const typename Op::Scales& scales,
                                          const int8_t* __restrict__ mask, const Predicates& pred, int prow0,
                                          int q0, int q, int n, int count, int l2) {
  constexpr int kQ = BQ / 4;
  constexpr int kPitch = kListSlots + kPassRows + kPitchPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = warp / 2;
  const int rl = lane % 8;
  const int r0 = (warp % 2) * 8 + rl;
  const int qg = lane / 8;
  static_assert(kStagesT % kPassTiles == 0 && kStagesT <= 32, "whole sub-rings, one parity bit a stage");
  float acc[kFfmaRows][kQ];
#pragma unroll
  for (int i = 0; i < kFfmaRows; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < chunks; ++c, ++chunk) {
    mbar_wait(&qfull[qs], qph);
    if (tile < ptiles) {
      const int s = ffma_stage<kStagesT>(chunk, tile);
      mbar_wait(&cfull[s], (full_bits >> s) & 1);
      full_bits ^= 1u << s;
      ffma_box<kQ>(acc, reinterpret_cast<const float*>(ring + s * kRowTile * kSwizzleBytes) + r0 * 32,
                   reinterpret_cast<const float*>(qring + qs * BQ * kSwizzleBytes), rl, qg);
      mbar_arrive(&cempty[s]);
    }
    mbar_arrive(&qempty[qs]);
    if (++qs == kQueryStages) {
      qs = 0;
      qph ^= 1;
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");  // every consumer is done with the ring

  // epilogue, as the wgmma consumers' (tc_block_topk): -inf past count,
  // where mask <= 0 or where the query's predicate drops the row; l2
  // compiled out of the grouped kernels at BQ 32
  const int use_l2 = (kGrouped && BQ > kSmallBQ) ? 0 : l2;
  const int8_t* pred_row[kQ] = {};
  if constexpr (kGrouped) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int gq = q0 + qg + 4 * j;
      const int id = gq < q ? pred.ids[gq] : -1;
      pred_row[j] = (id >= 0 && id < pred.m) ? pred.table + static_cast<size_t>(id) * n : nullptr;
    }
  }
#pragma unroll
  for (int i = 0; i < kFfmaRows; ++i) {
    const int lp = tile * kRowTile + r0 + 16 * i;  // the row's place in the pass
    if (lp >= prows) continue;
    const int col = prow0 + lp;
    const bool valid = col < count && (mask == nullptr || mask[col] > 0);
    const typename Op::Row rterms = Op::row(scales, col, valid, use_l2);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int ql = qg + 4 * j;
      bool keep = valid;
      if constexpr (kGrouped) keep = keep && pred_row[j] != nullptr && pred_row[j][col] > 0;
      const float s = Op::score(acc[i][j], scales, rterms, q0 + ql, q, use_l2 && keep);
      scores[ql * kPitch + kListSlots + lp] = keep ? s : -CUDART_INF_F;
    }
  }
}

// ---------------------------------------------------------------------------
// Where a CTA's rows, queries and lists come from.  FlatWork (kernels 1-6):
// query tile blockIdx.x, rows [blockIdx.y * bn, + bn) of the corpus.
// IvfWork (kernel 7): group blockIdx.x of the probe-pair work list and tile
// blockIdx.y of its cluster, rows [cluster * lrows + tile * bn, + bn) of the
// cluster-major layout, at most its end; the group's queries are rows
// [blockIdx.x * BQ, + BQ) of a group-major query buffer (gathered on the
// card, zeros past the group's size), and each pair's list goes to its own
// partial (PairRows).  A group of size 0 lies past the work list's count:
// its CTA leaves at once.
// ---------------------------------------------------------------------------

struct FlatWork {
  static constexpr bool kFlat = true;
  __device__ __forceinline__ int row0(int blk, int bn) const { return blk * bn; }
  __device__ __forceinline__ int ncols(int row0, int, int bn, int n) const { return min(bn, n - row0); }
};

struct IvfWork {
  static constexpr bool kFlat = false;
  const int* groups;        // [G][3]: cluster, first sorted position, size
  const long long* order;   // [P]: the pair (query * nprobe + probe slot) at each sorted position
  int lrows;                // slots of a cluster
  int tiles;                // tiles of bn slots a cluster
  __device__ __forceinline__ int row0(int tile, int bn) const {
    return groups[3 * blockIdx.x] * lrows + tile * bn;
  }
  __device__ __forceinline__ int ncols(int, int tile, int bn, int) const { return min(bn, lrows - tile * bn); }
};

// ---------------------------------------------------------------------------
// The kernel body: scores of queries [q0, q0 + BQ) against rows [row0,
// row0 + bn) into the score tile, then the block's top-k.  kKeys (kernel 3,
// bn <= 2048): select_pass_keys keys each score at its block-local lane as
// it reads the tile, and keeps a running list of keys; the epilogue and
// the scoring loop are kernel 1's.  Compiled out of every other
// instantiation.
// ---------------------------------------------------------------------------

template <typename Op, int BQ, int kStagesT, bool kGrouped, bool kThreshold, bool kKeys = false,
          typename Work = FlatWork>
__device__ __forceinline__ void tc_block_topk(const CUtensorMap* corpus_map,
                                              const CUtensorMap* query_map,
                                              const typename Op::Scales& scales,
                                              const int8_t* __restrict__ mask,
                                              const Predicates& pred, float* __restrict__ out_v,
                                              int* __restrict__ out_i, int n, int d, int q,
                                              int count, int k, int bn, int l2, const Work work = Work{}) {
  using Acc = typename Op::Acc;
  constexpr int kBoxK = Op::kBoxK;
  constexpr int kCorpusBox = kRowTile * kSwizzleBytes;
  constexpr int kQueryBox = BQ * kSwizzleBytes;
  constexpr int kPitch = kListSlots + kPassRows + kPitchPad;
  if constexpr (!Work::kFlat) {
    if (work.groups[3 * blockIdx.x + 2] == 0) return;  // past the group count: before any barrier
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint8_t* ring = base;                           // corpus stages, then query stages
  uint8_t* qring = ring + kStagesT * kCorpusBox;
  // the score tile and the candidates: over the ring once a pass's loads are
  // used (BQ 32), or after it (BQ 8)
  uint8_t* tile = tile_over_ring<BQ>() ? base : base + ring_bytes<BQ>(kStagesT);
  float* scores = reinterpret_cast<float*>(tile);
  float2* cands = reinterpret_cast<float2*>(tile + BQ * kPitch * 4);
  float* list_v = reinterpret_cast<float*>(base + union_bytes<BQ>(kStagesT));
  int* list_i = reinterpret_cast<int*>(list_v + BQ * kListSlots);
  uint64_t* cfull = reinterpret_cast<uint64_t*>(list_i + BQ * kListSlots);
  uint64_t* cempty = cfull + kStagesT;
  uint64_t* qfull = cempty + kStagesT;
  uint64_t* qempty = qfull + kQueryStages;
  uint64_t* pass_free = qempty + kQueryStages;  // the consumers are done with a pass's tile
  const int q0 = blockIdx.x * BQ;
  const int blk = blockIdx.y;
  const int row0 = work.row0(blk, bn);
  const int ncols = work.ncols(row0, blk, bn, n);  // the block's rows
  const int passes = (ncols + kPassRows - 1) / kPassRows;  // of kPassRows rows, the last ragged
  const int chunks = (d + kBoxK - 1) / kBoxK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesT; ++s) {
      mbar_init(&cfull[s], 1);            // the producer's arrive, plus the box's bytes
      // every consumer thread, after its wgmma wait; f32: the row tile's warp pair
      mbar_init(&cempty[s], Op::kFfma ? kFfmaTileThreads : kConsumers);
    }
    for (int s = 0; s < kQueryStages; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kConsumers);
    }
    mbar_init(pass_free, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; the roles never meet again
    if (threadIdx.x == kConsumers) {
      int cs = 0, qs = 0;
      uint32_t cph = 0, qph = 0;
      [[maybe_unused]] int chunk = 0;           // f32: chunks loaded, over every pass
      [[maybe_unused]] uint32_t full_bits = 0;  // f32: bit s, the parity of stage s's next fill
      for (int p = 0; p < passes; ++p) {
        if (tile_over_ring<BQ>() && p > 0) mbar_wait(pass_free, (p - 1) & 1);  // the tile is selected
        const int pass0 = p * kPassRows;
        const int ptiles = (min(kPassRows, ncols - pass0) + kRowTile - 1) / kRowTile;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&qempty[qs], qph ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(&qfull[qs], kQueryBox);  // out-of-bounds zeros count too
          tma_load_2d(qring + qs * kQueryBox, query_map, &qfull[qs], c * kBoxK, q0);
          if (++qs == kQueryStages) {
            qs = 0;
            qph ^= 1;
          }
          for (int t = 0; t < ptiles; ++t) {
            if constexpr (Op::kFfma) {  // row tile t's own stages (ffma_stage)
              const int st = ffma_stage<kStagesT>(chunk, t);
              mbar_wait(&cempty[st], ((full_bits >> st) & 1) ^ 1);
              full_bits ^= 1u << st;
              mbar_expect_tx(&cfull[st], kCorpusBox);
              tma_load_2d(ring + st * kCorpusBox, corpus_map, &cfull[st], c * kBoxK, row0 + pass0 + t * kRowTile);
            } else {
              mbar_wait(&cempty[cs], cph ^ 1);
              mbar_expect_tx(&cfull[cs], kCorpusBox);
              tma_load_2d(ring + cs * kCorpusBox, corpus_map, &cfull[cs], c * kBoxK,
                          row0 + pass0 + t * kRowTile);
              if (++cs == kStagesT) {
                cs = 0;
                cph ^= 1;
              }
            }
          }
          if constexpr (Op::kFfma) ++chunk;
        }
      }
    }
    return;
  }

  // consumers.  The running top-k of each query starts empty (kKeys: a
  // list of keys in list_i, INT_MIN where empty).
  for (int i = threadIdx.x; i < BQ * kListSlots; i += kConsumers) {
    list_v[i] = -CUDART_INF_F;
    list_i[i] = kKeys ? INT_MIN : INT_MAX;
  }
  // Warpgroup wg scores rows wg * 64 .. wg * 64 + 63 of each row tile.
  // Fragment of m64nBQk16 / k32: element 4 j + 2 h + e of a thread is (row r + 8 h,
  // query 8 j + qc + e), r = 16 * warp + lane / 4, qc = 2 * (lane % 4).
  const int wg = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int frag_row = wg * 64 + (t128 / 32) * 16 + (t128 % 32) / 4;
  const int qc = 2 * (t128 % 4);
  // kKeys: the lane field of the keys, max(10, bit_length(bn - 1)) bits
  [[maybe_unused]] const int lm = kKeys ? (1 << max(10, 32 - __clz(bn - 1))) - 1 : 0;
  int cs = 0, qs = 0;
  uint32_t cph = 0, qph = 0;
  [[maybe_unused]] int chunk = 0;           // f32: as the producer's
  [[maybe_unused]] uint32_t full_bits = 0;
  for (int p = 0; p < passes; ++p) {
    const int pass0 = p * kPassRows;
    const int prows = min(kPassRows, ncols - pass0);
    const int ptiles = (prows + kRowTile - 1) / kRowTile;
    if constexpr (Op::kFfma) {
      ffma_pass<Op, BQ, kStagesT, kGrouped>(ring, qring, cfull, cempty, qfull, qempty, chunk, full_bits, qs, qph,
                                            chunks, ptiles, prows, scores, scales, mask, pred, row0 + pass0, q0,
                                            q, n, count, l2);
    } else {
      Acc acc[kPassTiles][BQ / 2];
#pragma unroll
      for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) acc[t][i] = Acc(0);
      // D chunk by chunk: one query box serves every row tile of the pass
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&qfull[qs], qph);
        const uint64_t db = sw128_desc(qring + qs * kQueryBox);
#pragma unroll
        for (int t = 0; t < kPassTiles; ++t) {
          if (t < ptiles) {
            mbar_wait(&cfull[cs], cph);
            const uint64_t da = sw128_desc(ring + cs * kCorpusBox + wg * 64 * kSwizzleBytes);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kSwizzleBytes / kWgmmaKBytes; ++kk)  // 32 bytes along K: 2 in 16-byte units
              Op::template Mma<BQ>::mma(acc[t], da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(acc[t]);
            mbar_arrive(&cempty[cs]);
            if (++cs == kStagesT) {
              cs = 0;
              cph ^= 1;
            }
          }
        }
        mbar_arrive(&qempty[qs]);
        if (++qs == kQueryStages) {
          qs = 0;
          qph ^= 1;
        }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");  // both warpgroups are done with the ring

      // epilogue: -inf past count / where mask <= 0 / where the query's
      // predicate drops the row; the operand's score elsewhere.  The predicate rows
      // are looked up here: looked up before the main loop, kernel 5 on the
      // FMA loop ran 46 % slower than kernel 1 (H100).
      // The grouped kernels score inner products only (their entry points
      // pass l2 = 0).  At BQ 32 the l2 term is compiled out of them: kernel
      // 5 spills 84 bytes instead of 196.  At BQ 8 it stays in: without it
      // ptxas gives kernel 5 one register more (H100 build, PERF.md).
      const int use_l2 = (kGrouped && BQ > kSmallBQ) ? 0 : l2;
      const int8_t* pred_row[BQ / 4] = {};
      if constexpr (kGrouped) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gq = q0 + 8 * j + qc + e;
            const int id = gq < q ? pred.ids[gq] : -1;
            pred_row[2 * j + e] =
                (id >= 0 && id < pred.m) ? pred.table + static_cast<size_t>(id) * n : nullptr;
          }
      }
#pragma unroll
      for (int t = 0; t < kPassTiles; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lp = t * kRowTile + frag_row + 8 * h;  // the row's place in the pass
          if (lp >= prows) continue;
          const int col = row0 + pass0 + lp;
          const bool valid = col < count && (mask == nullptr || mask[col] > 0);
          const typename Op::Row rterms = Op::row(scales, col, valid, use_l2);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ql = 8 * j + qc + e;
              bool keep = valid;
              if constexpr (kGrouped)
                keep = keep && pred_row[2 * j + e] != nullptr && pred_row[2 * j + e][col] > 0;
              const float s = Op::score(acc[t][4 * j + 2 * h + e], scales, rterms, q0 + ql, q, use_l2 && keep);
              scores[ql * kPitch + kListSlots + lp] = keep ? s : -CUDART_INF_F;
            }
        }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");  // the tile is whole

    if constexpr (kKeys)
      select_pass_keys<BQ>(scores, kPitch, prows, list_i, q0, q, blk, gridDim.y, row0, pass0, ncols, lm, k,
                           p == passes - 1, reinterpret_cast<int*>(cands), out_v, out_i);
    else if constexpr (Work::kFlat)
      select_pass<BQ, kThreshold>(scores, kPitch, prows, list_v, list_i, q0, q, blk, gridDim.y,
                                  row0 + pass0, k, p == passes - 1, cands, out_v, out_i);
    else  // the group's first pair and size, read again here rather than held across the loop
      select_pass_pairs<BQ>(scores, kPitch, prows, list_v, list_i,
                            PairRows{work.order, work.groups[3 * blockIdx.x + 1], work.groups[3 * blockIdx.x + 2],
                                     work.tiles, blk},
                            row0 + pass0, k, p == passes - 1, cands, out_v, out_i);
    // the producer's next loads write over the tile: order these generic
    // accesses before them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(pass_free);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps through cudaGetDriverEntryPoint (no -lcuda)
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major [rows, d] tensor of the operand's type cut into [box_rows,
// Op::kBoxK] boxes (128 bytes wide) with the 128-byte swizzle; reads out of
// bounds fill zeros.  Needs a 16-byte row stride (d % 8 == 0 bf16, d % 16 ==
// 0 int8) and a 16-byte-aligned base.
template <typename Op>
inline bool make_map(CUtensorMap* map, const void* base, int rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * Op::kBytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Op::kBoxK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elems[2] = {1, 1};
  return encode(map, Op::kMapType, 2, const_cast<void*>(base), dims, strides,
                box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace pse
