// Kernel 2: int8 block top-k scan (the nomination pass of the int8 tier),
// and kernel 6, the same scan with a predicate per query.
//
// Kernel 2 replaces: _int8_block_kernel (photo_search_engine_tpu/ops/
// quantized.py:192-229) with _quant_block_dot feed "int8" (:166-189),
// launched there by _int8_rescore_impl (:239-336).
//
// Kernel 6 replaces: _int8_grouped_kernel (photo_search_engine_tpu/ops/
// quantized.py:339-376), launched there by _int8_grouped_impl (:379-457).
// As in kernel 5 (block_topk.cu), the epilogue reads each query's predicate
// row directly instead of the TPU's one-hot MXU product; it is the same
// template with kGrouped = true, so kernel 2's code is unchanged.  The pool
// and the exact rescore stay in the wrapper (ops/quantized.py).
//
// What bounds it on the H100: the int8 shadow of a 1M x 1536 corpus is
// 1.5 GB, half the bf16 bytes, so at batch 1 the read costs about 0.5 ms.
// At batch 256 the product is 2 * 256 * 1M * 1536 = 0.8 TOP; __dp4a does
// four multiply-adds per instruction, so this kernel is bound by the
// integer pipe there, ahead of the memory.
//
// What the design does about it: the same CTA shape as kernel 1 (one block
// of `bn` rows for BQ queries, query blocks on blockIdx.x so a corpus block
// is re-read from L2), with D staged as int8x4 words and an exact int32
// dot by __dp4a.  The int32 sum becomes f32 and is scaled by the query
// scale, then the row scale ((acc * qs) * cs, the TPU order); l2 orders
// by 2s - |c|^2 (the query norm is constant per query).  Invalid rows
// (past count, mask <= 0) are -inf.
//
// Selection: the per-block top-kloc is chosen on exact f32 values with
// ties to the smallest row (block_select.cuh), not with the TPU's packed
// int32 keys (topk.py:301-342).  The nominated pool is only a superset
// filter that the exact rescore re-orders, and the packed keys differ from
// exact f32 order only inside a +-2^-13 relative window, so the two can
// nominate different rows only among near-ties of the quantized score.
//
// Requires D % 4 == 0 (rows are read as int8x4 words; the wrapper checks).
// Outputs: [Q, NB, k] float32 quantized scores and int32 global row ids,
// padded with -inf and INT_MAX.

#include <cuda_runtime.h>

#include "block_select.cuh"

namespace {

using namespace pse;

template <int BQ, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
int8_block_topk_kernel(const int* __restrict__ corpus,   // [n][d/4] int8x4
                       const int* __restrict__ queries,  // [q][d/4] int8x4
                       const float* __restrict__ qscales,
                       const float* __restrict__ cscales,
                       const float* __restrict__ cnorms,
                       const int8_t* __restrict__ mask, Predicates pred,
                       float* __restrict__ out_v, int* __restrict__ out_i, int n,
                       int d, int q, int count, int k, int bn, int l2) {
  constexpr int TQ = BQ / kWarps;
  extern __shared__ float smem[];
  float* scores = smem;                                         // [BQ][bn]
  int* q_s = reinterpret_cast<int*>(scores + BQ * bn);          // [kDepth][BQ + 1]
  int* c_s = q_s + kDepth * (BQ + 1);                           // [kDepth][kPitch]

  const int words = d / 4;
  const int tid = threadIdx.x;
  const int rg = tid % 32;
  const int qg = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int blk = blockIdx.y;
  const int row0 = blk * bn;

  for (int sub = 0; sub < bn; sub += kTileRows) {
    int acc[TQ][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < words; w0 += kDepth) {
      for (int e = tid; e < BQ * kDepth; e += kThreads) {
        const int ql = e / kDepth, ww = e % kDepth;
        const int gq = q0 + ql, gw = w0 + ww;
        q_s[ww * (BQ + 1) + ql] =
            (gq < q && gw < words) ? queries[static_cast<size_t>(gq) * words + gw] : 0;
      }
      const int ww = tid % 32;
      const int gw = w0 + ww;
#pragma unroll 4
      for (int i = 0; i < kTileRows / kWarps; ++i) {
        const int r = i * kWarps + tid / 32;
        const int grow = row0 + sub + r;
        c_s[ww * kPitch + r] = (sub + r < bn && grow < n && gw < words)
                                   ? corpus[static_cast<size_t>(grow) * words + gw]
                                   : 0;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < kDepth; ++e) {
        int qv[TQ], cv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < TQ; ++i) qv[i] = q_s[e * (BQ + 1) + qg * TQ + i];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) cv[j] = c_s[e * kPitch + rg + 32 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = __dp4a(qv[i], cv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // the predicate rows are looked up here, after the D loop (block_topk.cu)
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
        float s = -CUDART_INF_F;
        if (keep) {
          const float qs = (q0 + ql < q) ? qscales[q0 + ql] : 0.f;
          s = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qs), cscales[col]);
          if (l2) s = __fsub_rn(__fmul_rn(2.f, s), cnorms[col]);
        }
        scores[ql * bn + lc] = s;
      }
    }
  }
  __syncthreads();
  select_block_topk<BQ>(scores, bn, q0, q, blk, gridDim.y, row0, k, out_v, out_i);
}

template <int BQ, bool kGrouped>
cudaError_t run(const void* corpus, const void* queries, const void* qscales,
                const void* cscales, const void* cnorms, const void* mask,
                Predicates pred, void* out_v, void* out_i, int n, int d, int q,
                int count, int k, int bn, int l2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * bn + kDepth * (BQ + 1) + kDepth * kPitch);
  auto kernel = int8_block_topk_kernel<BQ, kGrouped>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return err;
  }
  const dim3 grid((q + BQ - 1) / BQ, (n + bn - 1) / bn);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(corpus), static_cast<const int*>(queries),
      static_cast<const float*>(qscales), static_cast<const float*>(cscales),
      static_cast<const float*>(cnorms), static_cast<const int8_t*>(mask), pred,
      static_cast<float*>(out_v), static_cast<int*>(out_i), n, d, q, count, k, bn, l2);
  return cudaGetLastError();
}

template <bool kGrouped>
int dispatch(const void* corpus, const void* queries, const void* qscales,
             const void* cscales, const void* cnorms, const void* mask,
             Predicates pred, void* out_v, void* out_i, int n, int d, int q,
             int count, int k, int bn, int l2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q <= 8)
    return run<8, kGrouped>(corpus, queries, qscales, cscales, cnorms, mask, pred, out_v,
                            out_i, n, d, q, count, k, bn, l2, s);
  return run<16, kGrouped>(corpus, queries, qscales, cscales, cnorms, mask, pred, out_v,
                           out_i, n, d, q, count, k, bn, l2, s);
}

}  // namespace

extern "C" int pse_int8_block_topk(const void* corpus, const void* queries,
                                   const void* qscales, const void* cscales,
                                   const void* cnorms, const void* mask,
                                   void* out_v, void* out_i, int n, int d, int q,
                                   int count, int k, int bn, int l2, void* stream) {
  return dispatch<false>(corpus, queries, qscales, cscales, cnorms, mask, pse::Predicates{},
                         out_v, out_i, n, d, q, count, k, bn, l2, stream);
}

// Kernel 6: table is [m][n] int8, ids [q] int32 (see Predicates).
extern "C" int pse_int8_grouped_block_topk(const void* corpus, const void* queries,
                                           const void* qscales, const void* cscales,
                                           const void* table, const void* ids,
                                           void* out_v, void* out_i, int n, int d,
                                           int q, int count, int k, int bn, int m,
                                           void* stream) {
  return dispatch<true>(corpus, queries, qscales, cscales, nullptr, nullptr,
                        pse::make_predicates(table, ids, m), out_v, out_i, n, d, q, count,
                        k, bn, 0, stream);
}
