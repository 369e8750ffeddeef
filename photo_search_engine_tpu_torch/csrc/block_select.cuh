// Shared pieces of the scan kernels (block_topk.cu, int8_block_topk.cu,
// their grouped variants, ivf_topk.cu and fused_topk.cu): the tile
// geometry, the per-query predicates of the grouped scans and the
// tile-local top-k selections.
//
// Selection replaces the TPU's k rounds of "max -> first occurrence ->
// eliminate" over a [BQ, BN] tile (_extract_block_topk,
// photo_search_engine_tpu/ops/topk.py:272-295).  Here one warp owns one
// query row of the score tile in shared memory.  Each lane keeps the best
// (value, column) of the columns it owns (lane, lane+32, ...); a round is a
// five-step butterfly reduction to the best value with the smallest column
// among equal values, after which only the winning lane rescans its
// columns.  Ties therefore go to the smallest row, as lax.top_k does, and
// the comparison is on exact float32 values (no packed keys).
//
// Variants beside it, by dtype and width:
// - select_pass, the threshold selection with a running top-k of the
//   tensor-core scan (block_score_tc.cuh): bf16 kernels 1 and 5 and bf16
//   kernel 4 (kernel 1 launched with a range of blocks as a CTA's rows),
//   int8 kernels 2 and 6, and as select_pass_pairs bf16 and int8 kernel 7
//   (a group of probe pairs' lists);
// - select_pass_keys, the same selection on the packed keys of kernel 3
//   (_extract_block_topk_fast, topk.py:301-342) for bf16 kernel 3, flat and
//   grouped, on the tensor cores;
// - select_block_topk_fast, kernel 3's packed keys after the FMA loop
//   (float32, and bf16 with D % 8 != 0);
// - merge_topk_ids, which carries explicit ids for kernel 4's running top-k
//   after the FMA loop (float32, and bf16 with D % 8 != 0);
// - the merge of sorted range lists in fused_topk.cu (kernel 4, every dtype).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace pse {

constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;      // corpus rows scored per pass (TN)
constexpr int kRowsPerThread = 8;   // TR: rows of the pass one thread scores
constexpr int kDepth = 32;          // D-chunk staged per step (elements, or int8x4 words)
constexpr int kPitch = kTileRows + 1;  // odd pitch: transposed staging is conflict-free

// Per-query predicates of the grouped scans (kernels 5 and 6): query gq
// keeps row col only when 0 <= ids[gq] < m and table[ids[gq] * n + col] > 0
// (table is [m][n] int8, ids is [q] int32).  A null table means no
// predicates (kernels 1 and 2).
struct Predicates {
  const int8_t* table;
  const int* ids;
  int m;
};

inline Predicates make_predicates(const void* table, const void* ids, int m) {
  return Predicates{static_cast<const int8_t*>(table), static_cast<const int*>(ids), m};
}

// The predicate row of each of a thread's TQ queries (first_q, first_q + 1,
// ...), or null where the query is padding (gq >= q, whose id is never
// read) or its id lies outside [0, m) (it keeps no row).
template <int TQ>
__device__ __forceinline__ void predicate_rows(const Predicates& p, int first_q, int q,
                                               int n, const int8_t* (&rows)[TQ]) {
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int gq = first_q + i;
    const int id = gq < q ? p.ids[gq] : -1;
    rows[i] = (id >= 0 && id < p.m) ? p.table + static_cast<size_t>(id) * n : nullptr;
  }
}

__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

// Best (value, column) among columns lane, lane+32, ... of `row`; -inf
// entries are never chosen (column stays INT_MAX).
__device__ __forceinline__ void lane_best(const float* row, int bn, int lane,
                                          float& bv, int& bc) {
  bv = -CUDART_INF_F;
  bc = INT_MAX;
  for (int c = lane; c < bn; c += 32) {
    const float v = row[c];
    if (v > bv) {  // strict: the first (smallest) column wins a tie
      bv = v;
      bc = c;
    }
  }
}

// Top-k of one score row `row` (columns [0, ncols)) by one warp, in k
// rounds: lane 0 calls emit(slot, value, id_of(column)), or emit(slot,
// -inf, INT_MAX) for a slot with no valid column.  Ties go to the smallest
// column.  `row` is consumed.
template <typename Id, typename Emit>
__device__ __forceinline__ void select_row_by(float* row, int ncols, int k, Id id_of, Emit emit) {
  const int lane = threadIdx.x % 32;
  float bv;
  int bc;
  lane_best(row, ncols, lane, bv, bc);
  for (int slot = 0; slot < k; ++slot) {
    float wv = bv;
    int wc = bc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, wc, off);
      if (better(ov, oc, wv, wc)) {
        wv = ov;
        wc = oc;
      }
    }
    if (lane == 0) emit(slot, wv, wc == INT_MAX ? INT_MAX : id_of(wc));
    if (wc != INT_MAX && lane == (wc & 31)) {
      row[wc] = -CUDART_INF_F;  // eliminate, then rescan this lane only
      lane_best(row, ncols, lane, bv, bc);
    }
  }
}

// select_row_by with ids col0 + column, written to out_v/out_i[first + slot].
__device__ __forceinline__ void select_row(float* row, int ncols, int col0, int k, size_t first,
                                           float* __restrict__ out_v, int* __restrict__ out_i) {
  select_row_by(row, ncols, k, [=](int c) { return col0 + c; }, [=](int slot, float v, int id) {
    out_v[first + slot] = v;
    out_i[first + slot] = id;
  });
}

// Top-k of rows 0 .. nrows-1 of the score tile `scores` (row pitch
// `pitch`, columns [0, ncols)): row ql's slot s goes to
// out_v/out_i[base(ql) + s], with id col0 + column.  Slots with no valid
// column hold -inf and INT_MAX.  `scores` is consumed.
template <typename Base>
__device__ void select_topk(float* scores, int pitch, int ncols, int nrows, int col0,
                            int k, Base base, float* __restrict__ out_v,
                            int* __restrict__ out_i) {
  const int warp = threadIdx.x / 32;
  for (int ql = warp; ql < nrows; ql += kWarps)  // warp-uniform
    select_row(scores + ql * pitch, ncols, col0, k, base(ql), out_v, out_i);
}

// Top-k of every query row of the [BQ, bn] score tile `scores`, written to
// out_v/out_i[(q * nb + blk) * k + slot]; row ids are global (row0 + col).
template <int BQ>
__device__ void select_block_topk(float* scores, int bn, int q0, int q,
                                  int blk, int nb, int row0, int k,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  const int nrows = q - q0 < BQ ? q - q0 : BQ;
  select_topk(scores, bn, bn, nrows, row0, k,
              [=](int ql) { return (static_cast<size_t>(q0 + ql) * nb + blk) * k; },
              out_v, out_i);
}

// ---------------------------------------------------------------------------
// Selection of the tensor-core scan (kernels 1, 2, 4, 5, 6 and 7,
// block_score_tc.cuh).  The scan scores a block in passes of rows; a score
// row of a pass holds the query's running top-k of the earlier passes in its
// first kListSlots positions (ids from the list, -inf past k) and the pass's
// rows after them (ids id0 + position - kListSlots).  Ids of equal scores
// then grow with the position, so ties to the smallest position are ties to
// the smallest row.
//
// Threshold selection.  The k rounds cost 10 shuffles and a rescan each;
// with the scoring loop on the tensor cores they took most of a block's
// time at batch 128 (5.19 ms at k = 50 against 1.88 at k = 1, H100).  Here
// one warp finds a threshold T that at least k of the row's positions
// reach, keeps only the positions at or above it, and places each kept one
// by its rank:
// 1. each lane keeps the maxima of kSubsets disjoint subsets of its
//    positions (position lane + 32 i goes to subset i % kSubsets): 128
//    maxima of distinct positions;
// 2. T is the k-th largest of them (k <= 64 <= 128), so at least k
//    positions score >= T, and every position of the top-k does; it is
//    found bit by bit on order-preserving keys, 32 warp sums in registers;
// 3. the live positions (> -inf) scoring >= T are compacted, with their
//    ids, into the warp's candidate buffer;
// 4. each candidate's rank is the number of candidates before it in
//    (value descending, id ascending) order; rank < k is its slot.
// The comparison is on exact f32 values.  A row with more than kCandidates
// candidates (many equal scores at T) takes the k rounds instead.
// ---------------------------------------------------------------------------

constexpr int kSubsets = 4;       // subset maxima a lane keeps
constexpr int kListSlots = 64;    // the running top-k at the head of a score row (k <= 64)
constexpr int kCandidates = 192;  // (value, id) slots of a warp's candidates; the row's result follows

// An order-preserving map of float32 to uint32 (a < b iff key(a) < key(b)
// for non-NaN values; -inf is the smallest) and its inverse.
__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t bits = __float_as_uint(v);
  return bits & 0x80000000u ? ~bits : bits | 0x80000000u;
}

__device__ __forceinline__ float from_ordered_key(uint32_t key) {
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}

// Which score rows a CTA selects, and where each row's list goes on the
// last pass.  BlockRows (kernels 1, 2, 4, 5 and 6): queries q0 .. q - 1 of
// the tile, query q0 + ql's list of block blk at [(q0 + ql) * nb + blk] *
// k.  PairRows (kernel 7): the `size` probe pairs of a group, the pair at
// sorted position first + ql being order[first + ql] = query * nprobe +
// probe slot, whose list of the cluster's tile `tile` goes to [pair *
// tiles + tile] * k.
struct BlockRows {
  int q0, q, blk, nb;
  template <int BQ>
  __device__ __forceinline__ int nrows() const { return q - q0 < BQ ? q - q0 : BQ; }
  __device__ __forceinline__ size_t first(int ql, int k) const {
    return (static_cast<size_t>(q0 + ql) * nb + blk) * k;
  }
};

struct PairRows {
  const long long* order;
  int first_pair, size, tiles, tile;
  template <int BQ>
  __device__ __forceinline__ int nrows() const { return size; }
  __device__ __forceinline__ size_t first(int ql, int k) const {
    return (static_cast<size_t>(order[first_pair + ql]) * tiles + tile) * k;
  }
};

// One pass's selection for every query row of the score tile (pitch
// `pitch`, positions [0, kListSlots + prows)): the running list
// list_v/list_i ([BQ][kListSlots]) is copied into each row's head, and the
// row's new top-k replaces it, or, on the last pass, goes to
// out_v/out_i[rows.first(ql, k) + slot].  kThreshold: the threshold
// selection, else the k rounds.  `buf` holds kWarps * (kCandidates +
// kListSlots) pairs.  Inlined into the two out-of-line entries below.
template <int BQ, bool kThreshold, typename Rows>
__device__ __forceinline__ void select_pass_rows(float* scores, int pitch, int prows, float* list_v,
                                                 int* list_i, const Rows& rows, int id0, int k, bool last,
                                                 float2* buf, float* __restrict__ out_v,
                                                 int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float2* cand = buf + warp * (kCandidates + kListSlots);
  float2* best = cand + kCandidates;  // the row's new top-k: (value, id) by slot
  const int nrows = rows.template nrows<BQ>();
  const int ncols = kListSlots + prows;
  for (int ql = warp; ql < nrows; ql += kWarps) {  // warp-uniform
    float* row = scores + ql * pitch;
    float* lv = list_v + ql * kListSlots;
    int* li = list_i + ql * kListSlots;
    for (int s = lane; s < kListSlots; s += 32) row[s] = lv[s];
    __syncwarp();
    auto id_of = [=](int c) { return c < kListSlots ? li[c] : id0 + c - kListSlots; };
    int total = kCandidates + 1;
    if constexpr (kThreshold) {
      float m[kSubsets];
#pragma unroll
      for (int s = 0; s < kSubsets; ++s) m[s] = -CUDART_INF_F;
      for (int c0 = 0; c0 < ncols; c0 += 32 * kSubsets)
#pragma unroll
        for (int s = 0; s < kSubsets; ++s) {
          const int c = c0 + 32 * s + lane;
          if (c < ncols) m[s] = fmaxf(m[s], row[c]);
        }
      // T, the k-th largest maximum: the largest key x that at least k of
      // the maxima reach, built bit by bit from the top
      uint32_t key[kSubsets];
#pragma unroll
      for (int s = 0; s < kSubsets; ++s) key[s] = ordered_key(m[s]);
      uint32_t prefix = 0;
      for (int bit = 31; bit >= 0; --bit) {
        const uint32_t trial = prefix | (1u << bit);
        int reach = 0;
#pragma unroll
        for (int s = 0; s < kSubsets; ++s) reach += key[s] >= trial;
        if (__reduce_add_sync(0xffffffffu, reach) >= k) prefix = trial;
      }
      const float t = from_ordered_key(prefix);
      total = 0;
      for (int c0 = 0; c0 < ncols; c0 += 32) {
        const int c = c0 + lane;
        const float v = c < ncols ? row[c] : -CUDART_INF_F;
        const bool take = v >= t && v != -CUDART_INF_F;
        const unsigned ballot = __ballot_sync(0xffffffffu, take);
        const int pos = total + __popc(ballot & ((1u << lane) - 1));
        if (take && pos < kCandidates) cand[pos] = make_float2(v, __int_as_float(id_of(c)));
        total += __popc(ballot);
      }
      __syncwarp();
    }
    if (total > kCandidates) {
      select_row_by(row, ncols, k, id_of,
                    [=](int slot, float v, int id) { best[slot] = make_float2(v, __int_as_float(id)); });
    } else {
      for (int i = lane; i < total; i += 32) {
        const float2 mine = cand[i];
        const int id = __float_as_int(mine.y);
        int rank = 0;
        for (int j = 0; j < total; ++j) {  // one broadcast read a step
          const float2 o = cand[j];
          rank += better(o.x, __float_as_int(o.y), mine.x, id);
        }
        if (rank < k) best[rank] = mine;
      }
      for (int s = total + lane; s < k; s += 32) best[s] = make_float2(-CUDART_INF_F, __int_as_float(INT_MAX));
    }
    __syncwarp();  // every id is read from the list before the list is rewritten
    const size_t first = rows.first(ql, k);
    for (int s = lane; s < kListSlots; s += 32) {
      const float2 b = s < k ? best[s] : make_float2(-CUDART_INF_F, __int_as_float(INT_MAX));
      if (!last) {
        lv[s] = b.x;
        li[s] = __float_as_int(b.y);
      } else if (s < k) {
        out_v[first + s] = b.x;
        out_i[first + s] = __float_as_int(b.y);
      }
    }
    __syncwarp();  // the buffers are free for the next row
  }
}

// select_pass_rows for a tile of queries q0 .. q - 1 and block blk of nb
// (kernels 1, 2, 4, 5 and 6).  Kept out of line, as the packed-key
// selection is.
template <int BQ, bool kThreshold>
__device__ __noinline__ void select_pass(float* scores, int pitch, int prows, float* list_v,
                                         int* list_i, int q0, int q, int blk, int nb, int id0,
                                         int k, bool last, float2* buf,
                                         float* __restrict__ out_v, int* __restrict__ out_i) {
  select_pass_rows<BQ, kThreshold>(scores, pitch, prows, list_v, list_i, BlockRows{q0, q, blk, nb}, id0, k,
                                   last, buf, out_v, out_i);
}

// select_pass_rows for a group of probe pairs (kernel 7), threshold
// selection.  Out of line, as select_pass.
template <int BQ>
__device__ __noinline__ void select_pass_pairs(float* scores, int pitch, int prows, float* list_v,
                                               int* list_i, PairRows rows, int id0, int k, bool last,
                                               float2* buf, float* __restrict__ out_v,
                                               int* __restrict__ out_i) {
  select_pass_rows<BQ, true>(scores, pitch, prows, list_v, list_i, rows, id0, k, last, buf, out_v, out_i);
}

// ---------------------------------------------------------------------------
// Kernel 3: packed-key selection (_extract_block_topk_fast).  The score's
// bits become a totally ordered int32 key (the sign flip below), and the
// low lane_bits = max(10, bit_length(bn - 1)) bits are replaced by
// lm - column, so every key is unique and ties go to the smallest column.
// A round is one __reduce_max_sync; the winning column falls out of the
// key's low bits, and its value is the key's window top (m | lm) with the
// flip inverted: quantized upward, as on the TPU.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int flip_key(int bits) {  // an involution
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// The packed key of score `v` at block-local lane `lane` (lm: the lane
// field's mask).  -inf is keyed too: its keys are ordered and unique, above
// INT_MIN, the empty slot.
__device__ __forceinline__ int pack_key(float v, int lane, int lm) {
  return (flip_key(__float_as_int(v)) & ~lm) | (lm - lane);
}

// Candidates of select_pass_keys: the warp's float2 buffer holds twice as
// many ints, less the row's result.  A key at or above the threshold lies
// in one of the k subsets whose maxima reach it (keys are unique), and a
// subset holds at most ceil((kListSlots + kPassRows) / (32 kSubsets))
// positions, so the candidates always fit and no round fallback is needed
// (static_assert in block_score_tc.cuh, which defines kPassRows).
constexpr int kKeyCandidates = 2 * (kCandidates + kListSlots) - kListSlots;

// select_pass on kernel 3's packed keys (bf16 kernel 3 on the tensor cores,
// flat and grouped).  The score tile is kernel 1's (f32 scores of the pass
// after kListSlots unused head positions); the running top-k is a list of
// keys (list, [BQ][kListSlots], INT_MIN where empty).  Each position is
// keyed as it is read: the list's key, or the pass's score keyed at its
// block-local lane pass0 + c - kListSlots, so the epilogue and the scoring
// loop before it stay kernel 1's.  Keys are unique and totally ordered, so
// the block's top-k is the top-k of the running list and the pass, a key's
// rank is the number of larger keys, and no tie rule is needed; -inf keys
// are kept (the TPU emits them).  The last pass decodes: value
// flip_key(key | lm), id row0 + lm - (key & lm); a block of fewer than k
// rows (ncols) fills its slots with lanes ncols, ncols + 1, ... at -inf, as
// the TPU's tile padded with -inf does.  Out of line, as select_pass.
template <int BQ>
__device__ __noinline__ void select_pass_keys(const float* scores, int pitch, int prows, int* list, int q0,
                                              int q, int blk, int nb, int row0, int pass0, int ncols, int lm,
                                              int k, bool last, int* buf, float* __restrict__ out_v,
                                              int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* cand = buf + warp * 2 * (kCandidates + kListSlots);
  int* best = cand + kKeyCandidates;  // the row's new top-k keys, by slot
  const int nrows = q - q0 < BQ ? q - q0 : BQ;
  const int npos = kListSlots + prows;
  for (int ql = warp; ql < nrows; ql += kWarps) {  // warp-uniform
    const float* row = scores + ql * pitch;
    int* lk = list + ql * kListSlots;
    // position c's key as an unsigned, order-preserving value (INT_MIN, the
    // empty slot, is 0); whether c is in the list is uniform over a warp's 32
    auto key_at = [=](int c) {
      const int key = c < kListSlots ? lk[c] : pack_key(row[c], pass0 + c - kListSlots, lm);
      return static_cast<uint32_t>(key) ^ 0x80000000u;
    };
    // T, the k-th largest of the subset maxima
    uint32_t m[kSubsets];
#pragma unroll
    for (int s = 0; s < kSubsets; ++s) m[s] = 0;
    for (int c0 = 0; c0 < npos; c0 += 32 * kSubsets)
#pragma unroll
      for (int s = 0; s < kSubsets; ++s) {
        const int c = c0 + 32 * s + lane;
        if (c < npos) m[s] = max(m[s], key_at(c));
      }
    uint32_t prefix = 0;
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t trial = prefix | (1u << bit);
      int reach = 0;
#pragma unroll
      for (int s = 0; s < kSubsets; ++s) reach += m[s] >= trial;
      if (__reduce_add_sync(0xffffffffu, reach) >= k) prefix = trial;
    }
    int total = 0;
    for (int c0 = 0; c0 < npos; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t u = c < npos ? key_at(c) : 0u;
      const bool take = u >= prefix && u != 0u;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (take) cand[total + __popc(ballot & ((1u << lane) - 1))] = static_cast<int>(u ^ 0x80000000u);
      total += __popc(ballot);
    }
    __syncwarp();
    for (int i = lane; i < total; i += 32) {
      const int mine = cand[i];
      int rank = 0;
      for (int j = 0; j < total; ++j) rank += cand[j] > mine;  // one broadcast read a step
      if (rank < k) best[rank] = mine;
    }
    for (int s = total + lane; s < k; s += 32) best[s] = INT_MIN;
    __syncwarp();  // every key is read from the list before the list is rewritten
    const size_t first = (static_cast<size_t>(q0 + ql) * nb + blk) * k;
    for (int s = lane; s < kListSlots; s += 32) {
      const int key = s < k ? best[s] : INT_MIN;
      if (!last) {
        lk[s] = key;
      } else if (s < k) {
        const bool real = s < total;  // else a lane past the block's rows: ncols + (s - total)
        out_v[first + s] = real ? __int_as_float(flip_key(key | lm)) : -CUDART_INF_F;
        out_i[first + s] = row0 + (real ? lm - (key & lm) : ncols + s - total);
      }
    }
    __syncwarp();  // the buffers are free for the next row
  }
}

__device__ __forceinline__ int lane_best_key(const int* keys, int ncols, int lane) {
  int best = INT_MIN;
  for (int c = lane; c < ncols; c += 32) best = max(best, keys[c]);
  return best;
}

// As select_block_topk, with packed keys; requires k <= bn <= 2048.  The
// tile is turned into keys in place.  A slot past the valid rows holds
// -inf and the column its key decodes to, as the TPU kernel writes it.
// Kept out of line: inlined into the kernel, it changed how the compiler
// scheduled the scoring loop before it, and kernel 3 ran 43 % slower than
// kernel 1 at batches 1 and 8 (5.56 against 3.88 ms at 1M x 1536, H100);
// out of line the two take the same time there.
template <int BQ>
__device__ __noinline__ void select_block_topk_fast(float* scores, int bn, int q0, int q, int blk,
                                       int nb, int row0, int k,
                                       float* __restrict__ out_v,
                                       int* __restrict__ out_i) {
  const int lane_bits = max(10, 32 - __clz(bn - 1));
  const int lm = (1 << lane_bits) - 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nrows = q - q0 < BQ ? q - q0 : BQ;
  for (int ql = warp; ql < nrows; ql += kWarps) {  // warp-uniform
    int* keys = reinterpret_cast<int*>(scores + ql * bn);
    // each lane keys, and later rescans, only its own columns
    for (int c = lane; c < bn; c += 32)
      keys[c] = (flip_key(__float_as_int(scores[ql * bn + c])) & ~lm) | (lm - c);
    int best = lane_best_key(keys, bn, lane);
    const size_t first = (static_cast<size_t>(q0 + ql) * nb + blk) * k;
    for (int slot = 0; slot < k; ++slot) {
      const int m = __reduce_max_sync(0xffffffffu, best);
      const int col = lm - (m & lm);
      if (lane == 0) {
        out_v[first + slot] = __int_as_float(flip_key(m | lm));
        out_i[first + slot] = row0 + col;
      }
      if (lane == (col & 31) && col < bn) {  // keys are unique: one owner
        keys[col] = INT_MIN;
        best = lane_best_key(keys, bn, lane);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Selection with explicit ids (kernel 4).  The candidates of one warp are
// the list av/ai[0, na) and the score row b[0, ncols) with ids b0 + column;
// the order is value descending, then id ascending, and -inf never wins.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool better_id(float v, int id, float bv, int bid) {
  return v > bv || (v == bv && v != -CUDART_INF_F && id < bid);
}

// Best live candidate among the entries lane, lane + 32, ... of both lists;
// pos is its position (list first, then na + column), -1 when none.
__device__ __forceinline__ void lane_best_ids(const float* av, const int* ai, int na,
                                              const float* b, int ncols, int b0,
                                              int lane, float& bv, int& bid, int& pos) {
  bv = -CUDART_INF_F;
  bid = INT_MAX;
  pos = -1;
  for (int s = lane; s < na; s += 32)
    if (better_id(av[s], ai[s], bv, bid)) {
      bv = av[s];
      bid = ai[s];
      pos = s;
    }
  for (int c = lane; c < ncols; c += 32)
    if (better_id(b[c], b0 + c, bv, bid)) {
      bv = b[c];
      bid = b0 + c;
      pos = na + c;
    }
}

// The warp's best (value, id) of the lanes' candidates: a five-step butterfly.
__device__ __forceinline__ void warp_best_id(float& v, int& id) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    if (better(ov, oi, v, id)) {  // a lane with no candidate holds (-inf, INT_MAX)
      v = ov;
      id = oi;
    }
  }
}

// One warp replaces the list av/ai[0, k) (k <= 64) with the top-k of the list
// and the score row b (ids b0 + column).  Ids must be unique among live
// entries.  Both inputs are consumed.  Empty slots hold -inf and INT_MAX.
__device__ __forceinline__ void merge_topk_ids(float* av, int* ai, int k, float* b, int ncols, int b0) {
  const int lane = threadIdx.x % 32;
  float bv;
  int bid, pos;
  lane_best_ids(av, ai, k, b, ncols, b0, lane, bv, bid, pos);
  // this lane's result slots, lane and lane + 32, kept in registers
  float keep_v0 = -CUDART_INF_F, keep_v1 = -CUDART_INF_F;
  int keep_i0 = INT_MAX, keep_i1 = INT_MAX;
  for (int slot = 0; slot < k; ++slot) {
    float wv = bv;
    int wid = bid;
    warp_best_id(wv, wid);
    if (slot == lane) {
      keep_v0 = wv;
      keep_i0 = wid;
    } else if (slot == lane + 32) {
      keep_v1 = wv;
      keep_i1 = wid;
    }
    if (pos >= 0 && bid == wid && bv == wv) {  // the owner: eliminate, rescan
      if (pos < k)
        av[pos] = -CUDART_INF_F;
      else
        b[pos - k] = -CUDART_INF_F;
      lane_best_ids(av, ai, k, b, ncols, b0, lane, bv, bid, pos);
    }
  }
  __syncwarp();  // every lane is done reading the old list
  if (lane < k) {
    av[lane] = keep_v0;
    ai[lane] = keep_i0;
  }
  if (lane + 32 < k) {
    av[lane + 32] = keep_v1;
    ai[lane + 32] = keep_i1;
  }
  __syncwarp();
}

}  // namespace pse
