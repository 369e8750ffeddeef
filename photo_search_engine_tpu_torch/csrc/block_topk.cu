// Kernel 1: exact block top-k scan (float32 or bfloat16 corpus), and
// kernel 5, the same scan with a predicate per query.
//
// Kernel 1 replaces: _block_topk_kernel with fast=False and
// _extract_block_topk (photo_search_engine_tpu/ops/topk.py:345-389,
// 272-295), launched there by _pallas_twophase_impl (:391-480).
//
// Kernel 5 replaces: _grouped_kernel (photo_search_engine_tpu/ops/
// grouped_mask.py:167-211), launched there by _grouped_impl (:214-286).
// The TPU kernel selects each query's predicate row with a one-hot
// [BQ, M] x [M, BN] product on the MXU; here the epilogue reads the row
// directly (Predicates in block_select.cuh): one int8 per row and query,
// beside 2 or 4 bytes per element of D, so kernel 5 costs what kernel 1
// costs.  Inner product only, as on the TPU.  It is the same template
// with kGrouped = true, so kernel 1's code is unchanged.
//
// What bounds it on the H100: at 1M x 1536 bf16 every batch reads the
// 3.1 GB corpus.  At batch 1 that read is the cost (about 1 ms at
// 3.35 TB/s).  At batch 256 the product is 2 * 256 * 1M * 1536 = 0.8 TFLOP,
// which plain FP32 FMAs (67 TFLOP/s peak) cannot do in less than ~12 ms, so
// this kernel is bound by compute there.
//
// What the design does about it: each CTA owns one block of `bn` corpus
// rows for BQ queries, so every corpus element it stages in shared memory
// feeds BQ queries (32 at large batch) and the corpus is read from device
// memory once per query block; query blocks run on blockIdx.x, so CTAs that
// share a corpus block run together and the re-reads hit L2.  Each thread
// keeps a TQ x 8 register tile of f32 accumulators (fmaf, IEEE, no TF32,
// no tensor cores yet; bf16 is widened with __bfloat162float), and D is
// staged 32 at a time, transposed with an odd pitch so both the staging
// writes and the FMA reads are free of bank conflicts.  Scores never leave
// the SM: the epilogue (count, mask, l2) writes them to a [BQ, bn] tile in
// shared memory, and the selection (block_select.cuh) writes only k
// partials per query and block.  wgmma, TMA and a pipelined ring of tiles
// are later work.
//
// Outputs: [Q, NB, k] float32 scores (higher is better; l2 as
// -(|q|^2 + |c|^2 - 2 q.c)) and int32 global row ids, padded with -inf and
// INT_MAX.  The merge over blocks (phase B) is a stable sort in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_select.cuh"

namespace {

using namespace pse;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int BQ, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ corpus, const T* __restrict__ queries,
                  const float* __restrict__ qnorms,
                  const float* __restrict__ cnorms,
                  const int8_t* __restrict__ mask, Predicates pred,
                  float* __restrict__ out_v, int* __restrict__ out_i, int n,
                  int d, int q, int count, int k, int bn, int l2) {
  constexpr int TQ = BQ / kWarps;  // queries per thread
  extern __shared__ float smem[];
  float* scores = smem;              // [BQ][bn]
  float* q_s = scores + BQ * bn;     // [kDepth][BQ + 1]
  float* c_s = q_s + kDepth * (BQ + 1);  // [kDepth][kPitch]

  const int tid = threadIdx.x;
  const int rg = tid % 32;  // row group: rows rg + 32 * j of the pass
  const int qg = tid / 32;  // query group: queries qg * TQ + i
  const int q0 = blockIdx.x * BQ;
  const int blk = blockIdx.y;
  const int row0 = blk * bn;

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
  __syncthreads();
  select_block_topk<BQ>(scores, bn, q0, q, blk, gridDim.y, row0, k, out_v, out_i);
}

template <typename T, int BQ, bool kGrouped>
cudaError_t run(const void* corpus, const void* queries, const void* qnorms,
                const void* cnorms, const void* mask, Predicates pred, void* out_v,
                void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * bn + kDepth * (BQ + 1) + kDepth * kPitch);
  auto kernel = block_topk_kernel<T, BQ, kGrouped>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return err;
  }
  const dim3 grid((q + BQ - 1) / BQ, (n + bn - 1) / bn);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(corpus), static_cast<const T*>(queries),
      static_cast<const float*>(qnorms), static_cast<const float*>(cnorms),
      static_cast<const int8_t*>(mask), pred, static_cast<float*>(out_v),
      static_cast<int*>(out_i), n, d, q, count, k, bn, l2);
  return cudaGetLastError();
}

template <typename T, bool kGrouped>
int dispatch(const void* corpus, const void* queries, const void* qnorms,
             const void* cnorms, const void* mask, Predicates pred, void* out_v,
             void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q <= 8)
    return run<T, 8, kGrouped>(corpus, queries, qnorms, cnorms, mask, pred, out_v, out_i,
                               n, d, q, count, k, bn, l2, s);
  return run<T, 32, kGrouped>(corpus, queries, qnorms, cnorms, mask, pred, out_v, out_i,
                              n, d, q, count, k, bn, l2, s);
}

}  // namespace

extern "C" int pse_block_topk_f32(const void* corpus, const void* queries,
                                  const void* qnorms, const void* cnorms,
                                  const void* mask, void* out_v, void* out_i,
                                  int n, int d, int q, int count, int k, int bn,
                                  int l2, void* stream) {
  return dispatch<float, false>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{},
                                out_v, out_i, n, d, q, count, k, bn, l2, stream);
}

extern "C" int pse_block_topk_bf16(const void* corpus, const void* queries,
                                   const void* qnorms, const void* cnorms,
                                   const void* mask, void* out_v, void* out_i,
                                   int n, int d, int q, int count, int k, int bn,
                                   int l2, void* stream) {
  return dispatch<__nv_bfloat16, false>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{},
                                        out_v, out_i, n, d, q, count, k, bn, l2, stream);
}

// Kernel 5: table is [m][n] int8, ids [q] int32 (see Predicates).
extern "C" int pse_grouped_block_topk_f32(const void* corpus, const void* queries,
                                          const void* table, const void* ids,
                                          void* out_v, void* out_i, int n, int d,
                                          int q, int count, int k, int bn, int m,
                                          void* stream) {
  return dispatch<float, true>(corpus, queries, nullptr, nullptr, nullptr,
                               pse::make_predicates(table, ids, m), out_v, out_i, n, d, q,
                               count, k, bn, 0, stream);
}

extern "C" int pse_grouped_block_topk_bf16(const void* corpus, const void* queries,
                                           const void* table, const void* ids,
                                           void* out_v, void* out_i, int n, int d,
                                           int q, int count, int k, int bn, int m,
                                           void* stream) {
  return dispatch<__nv_bfloat16, true>(corpus, queries, nullptr, nullptr, nullptr,
                                       pse::make_predicates(table, ids, m), out_v, out_i, n,
                                       d, q, count, k, bn, 0, stream);
}
