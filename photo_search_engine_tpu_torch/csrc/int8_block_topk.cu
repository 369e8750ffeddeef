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
// 1.54 GB, half the bf16 bytes, so every batch up to 32 costs at least its
// read, 0.46 ms at 3.35 TB/s.  The product, 2 * 256 * 1M * 1536 = 0.8 TOP
// at batch 256, is 0.4 ms at the 1,979 TOP/s of the int8 tensor cores, so
// the bytes bound every batch; above 32 queries what the SMs take in (the
// corpus once per query tile of 32, from L2) and the selection come next.
// The first port's __dp4a loop (4 multiply-adds an instruction, nothing in
// flight while it ran, query tiles of 16) took 1.35 ms at batch 1 and 27.1
// ms at batch 128; this design takes 0.58 and 1.60 ms (H100, PERF.md).
//
// What the design does about it (d % 16 == 0: block_score_tc.cuh with the
// S8 operand).  Kernel 1's tensor-core scan, unchanged but for the operand:
// a producer warp keeps a ring of 4 corpus boxes ([128 rows, 128 bytes], 16
// KB) and 2 query boxes filled by TMA (128-byte swizzle); two consumer
// warpgroups multiply their 64 rows of each corpus box by the query box
// with wgmma m64n8k32 / m64n32k32 s8 x s8 -> s32 (exact, so the result is
// bit-identical to the plain version) and keep a pass of 512 rows in
// registers.  The epilogue turns each s32 sum into the TPU kernel's score,
// (float(acc) * qscale) * cscale, then 2 s - |c|^2 for l2 (the query norm
// is constant per query), -inf past count, where mask <= 0 or where the
// query's predicate drops the row; the threshold selection (block_select.cuh,
// select_pass) keeps each query's running top-k over the passes.  BQ 8 at
// q <= 8 (the micro-batcher's batches), else 32: 107,752 and 108,136 bytes
// of shared memory a CTA, two CTAs an SM.  A 2048-row block (the JAX
// default_block_n_int8 at D 1536) is 4 passes, so the nomination pool and
// its guard stay the JAX package's.
//
// Which loop runs.  TMA needs a 16-byte row stride, 16 int8 elements: the
// tensor cores take d % 16 == 0 on 16-byte-aligned bases (the wrappers
// check them and raise); other widths with d % 4 == 0 take the __dp4a loop
// below (BQ 8, D staged as int8x4 words, an exact int32 dot by __dp4a, a
// [BQ, bn] score tile and the k warp rounds of select_block_topk)
// (quantized.int8_scoring_loop names the loop).
//
// Selection: the per-block top-kloc is chosen on exact f32 values with
// ties to the smallest row (block_select.cuh), not with the TPU's packed
// int32 keys (topk.py:301-342).  The nominated pool is only a superset
// filter that the exact rescore re-orders, and the packed keys differ from
// exact f32 order only inside a +-2^-13 relative window, so the two can
// nominate different rows only among near-ties of the quantized score.
//
// Outputs: [Q, NB, k] float32 quantized scores and int32 global row ids,
// padded with -inf and INT_MAX.

#include <cuda_runtime.h>
#include <cstdint>

#include "block_score_tc.cuh"
#include "block_select.cuh"

namespace {

using namespace pse;

// The __dp4a loop (d % 16 != 0).
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

// Kernels 2 and 6 on the tensor cores (block_score_tc.cuh, the S8 operand).
template <int BQ, bool kGrouped>
__global__ void __launch_bounds__(tc::kThreadsTc, 2)
tc_int8_block_topk_kernel(const __grid_constant__ CUtensorMap corpus_map,
                          const __grid_constant__ CUtensorMap query_map,
                          const float* __restrict__ qscales, const float* __restrict__ cscales,
                          const float* __restrict__ cnorms, const int8_t* __restrict__ mask,
                          Predicates pred, float* __restrict__ out_v, int* __restrict__ out_i, int n,
                          int d, int q, int count, int k, int bn, int l2) {
  tc::tc_block_topk<tc::S8, BQ, tc::kStages, kGrouped, true>(
      &corpus_map, &query_map, tc::S8::Scales{qscales, cscales, cnorms}, mask, pred, out_v, out_i, n,
      d, q, count, k, bn, l2);
}

template <int BQ, bool kGrouped>
cudaError_t run_tc(const void* corpus, const void* queries, const void* qscales,
                   const void* cscales, const void* cnorms, const void* mask, Predicates pred,
                   void* out_v, void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
                   cudaStream_t stream) {
  CUtensorMap corpus_map, query_map;
  if (!tc::make_map<tc::S8>(&corpus_map, corpus, n, d, tc::kRowTile) ||
      !tc::make_map<tc::S8>(&query_map, queries, q, d, BQ))
    return cudaErrorInvalidValue;
  const size_t smem = tc::smem_bytes<BQ>(tc::kStages);
  auto kernel = tc_int8_block_topk_kernel<BQ, kGrouped>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid((q + BQ - 1) / BQ, (n + bn - 1) / bn);
  kernel<<<grid, tc::kThreadsTc, smem, stream>>>(
      corpus_map, query_map, static_cast<const float*>(qscales), static_cast<const float*>(cscales),
      static_cast<const float*>(cnorms), static_cast<const int8_t*>(mask), pred,
      static_cast<float*>(out_v), static_cast<int*>(out_i), n, d, q, count, k, bn, l2);
  return cudaGetLastError();
}

// The tensor cores where TMA can read the rows (a 16-byte row stride, d %
// 16 == 0, and 16-byte-aligned bases); other widths take the __dp4a loop at
// BQ 8, and the wrappers count those launches apart.
template <bool kGrouped>
int dispatch(const void* corpus, const void* queries, const void* qscales,
             const void* cscales, const void* cnorms, const void* mask,
             Predicates pred, void* out_v, void* out_i, int n, int d, int q,
             int count, int k, int bn, int l2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d % 16 != 0)
    return run<8, kGrouped>(corpus, queries, qscales, cscales, cnorms, mask, pred, out_v,
                            out_i, n, d, q, count, k, bn, l2, s);
  if (reinterpret_cast<uintptr_t>(corpus) % 16 || reinterpret_cast<uintptr_t>(queries) % 16)
    return cudaErrorMisalignedAddress;
  if (q <= tc::kSmallBQ)
    return run_tc<tc::kSmallBQ, kGrouped>(corpus, queries, qscales, cscales, cnorms, mask, pred,
                                          out_v, out_i, n, d, q, count, k, bn, l2, s);
  return run_tc<tc::kLargeBQ, kGrouped>(corpus, queries, qscales, cscales, cnorms, mask, pred,
                                        out_v, out_i, n, d, q, count, k, bn, l2, s);
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
