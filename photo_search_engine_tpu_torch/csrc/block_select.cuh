// Shared pieces of the scan kernels (block_topk.cu, int8_block_topk.cu,
// their grouped variants, and ivf_topk.cu): the tile geometry, the
// per-query predicates of the grouped scans and the tile-local top-k
// selection.
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

// Top-k of rows 0 .. nrows-1 of the score tile `scores` (row pitch
// `pitch`, columns [0, ncols)): row ql's slot s goes to
// out_v/out_i[base(ql) + s], with id col0 + column.  Slots with no valid
// column hold -inf and INT_MAX.  `scores` is consumed.
template <typename Base>
__device__ void select_topk(float* scores, int pitch, int ncols, int nrows, int col0,
                            int k, Base base, float* __restrict__ out_v,
                            int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int ql = warp; ql < nrows; ql += kWarps) {  // warp-uniform
    float* row = scores + ql * pitch;
    float bv;
    int bc;
    lane_best(row, ncols, lane, bv, bc);
    const size_t first = base(ql);
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
      if (lane == 0) {
        out_v[first + slot] = wv;
        out_i[first + slot] = wc == INT_MAX ? INT_MAX : col0 + wc;
      }
      if (wc != INT_MAX && lane == (wc & 31)) {
        row[wc] = -CUDART_INF_F;  // eliminate, then rescan this lane only
        lane_best(row, ncols, lane, bv, bc);
      }
    }
  }
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

}  // namespace pse
