// The scoring loop of the exact scans (float32 or bfloat16 corpus): kernel 1
// and its variants in block_topk.cu (grouped, packed-key) and kernel 4 in
// fused_topk.cu.  One call scores the BQ queries of one CTA against one
// block of `bn` corpus rows and leaves the scores in a [BQ, bn] shared-memory
// tile, -inf where the row is invalid.  Every caller accumulates in the same
// order, so the kernels built on it give bit-identical scores; the f32 ring
// (the F32 operand of block_score_tc.cuh) sums in this order too.
//
// Each thread keeps a TQ x 8 register tile of f32 accumulators (fmaf, IEEE,
// no TF32, no tensor cores yet; bf16 is widened with __bfloat162float), and D
// is staged 32 at a time, transposed with an odd pitch so both the staging
// writes and the FMA reads are free of bank conflicts.  The epilogue (count,
// mask, predicate, l2) writes the tile; selection is the caller's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_select.cuh"

namespace pse {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared memory of one scoring CTA, in floats: the score tile, then the
// staged queries and corpus rows.  Callers place their own data after it.
template <int BQ>
__host__ __device__ constexpr size_t score_smem_floats(int bn) {
  return static_cast<size_t>(BQ) * bn + kDepth * (BQ + 1) + kDepth * kPitch;
}

// Scores of queries [q0, q0 + BQ) against rows [row0, row0 + bn) into
// scores[ql * bn + lc]: the inner product (l2 as -(|q|^2 + |c|^2 - 2 q.c)),
// or -inf past n or count, where mask <= 0, or where the query's predicate
// (kGrouped) drops the row.  `smem` is laid out as score_smem_floats says.
// Ends without a barrier: the caller synchronises before reading the tile.
template <typename T, int BQ, bool kGrouped>
__device__ __forceinline__ void score_block(const T* __restrict__ corpus,
                                            const T* __restrict__ queries,
                                            const float* __restrict__ qnorms,
                                            const float* __restrict__ cnorms,
                                            const int8_t* __restrict__ mask,
                                            const Predicates& pred, float* smem, int n,
                                            int d, int q, int count, int bn, int l2,
                                            int q0, int row0) {
  constexpr int TQ = BQ / kWarps;  // queries per thread
  float* scores = smem;              // [BQ][bn]
  float* q_s = scores + BQ * bn;     // [kDepth][BQ + 1]
  float* c_s = q_s + kDepth * (BQ + 1);  // [kDepth][kPitch]

  const int tid = threadIdx.x;
  const int rg = tid % 32;  // row group: rows rg + 32 * j of the pass
  const int qg = tid / 32;  // query group: queries qg * TQ + i

  for (int sub = 0; sub < bn; sub += kTileRows) {
    float acc[TQ][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDepth) {
      for (int e = tid; e < BQ * kDepth; e += kThreads) {
        const int ql = e / kDepth, dd = e % kDepth;
        const int gq = q0 + ql, gd = d0 + dd;
        q_s[dd * (BQ + 1) + ql] =
            (gq < q && gd < d) ? widen(queries[static_cast<size_t>(gq) * d + gd]) : 0.f;
      }
      // a warp reads 32 consecutive elements of one row (coalesced) and
      // writes them down one column of the transposed tile
      const int dd = tid % 32;
      const int gd = d0 + dd;
#pragma unroll 4
      for (int i = 0; i < kTileRows / kWarps; ++i) {
        const int r = i * kWarps + tid / 32;
        const int grow = row0 + sub + r;
        c_s[dd * kPitch + r] = (sub + r < bn && grow < n && gd < d)
                                   ? widen(corpus[static_cast<size_t>(grow) * d + gd])
                                   : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < kDepth; ++e) {
        float qv[TQ], cv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < TQ; ++i) qv[i] = q_s[e * (BQ + 1) + qg * TQ + i];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) cv[j] = c_s[e * kPitch + rg + 32 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: -inf past count / where mask <= 0 / where the query's
    // predicate drops the row; l2 as in the TPU kernel.  The predicate rows
    // are looked up here: looked up before the D loop, their pointers stayed
    // live across it and kernel 5 ran 46% slower than kernel 1 (H100).
    const int8_t* pred_row[TQ] = {};
    if constexpr (kGrouped) predicate_rows<TQ>(pred, q0 + qg * TQ, q, n, pred_row);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int lc = sub + rg + 32 * j;
      if (lc >= bn) continue;
      const int col = row0 + lc;
      const bool valid = col < n && col < count && (mask == nullptr || mask[col] > 0);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int ql = qg * TQ + i;
        bool keep = valid;
        if constexpr (kGrouped) keep = keep && pred_row[i] != nullptr && pred_row[i][col] > 0;
        float s = acc[i][j];
        if (l2 && keep) {
          const float qn = (q0 + ql < q) ? qnorms[q0 + ql] : 0.f;
          s = -__fsub_rn(__fadd_rn(qn, cnorms[col]), __fmul_rn(2.f, s));
        }
        scores[ql * bn + lc] = keep ? s : -CUDART_INF_F;
      }
    }
  }
}

}  // namespace pse
