// Kernel 1: exact block top-k scan (float32 or bfloat16 corpus); kernel 5,
// the same scan with a predicate per query; kernel 3, either of them with
// packed-key selection.
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
// Kernel 3 replaces: _block_topk_kernel with fast=True, that is
// _extract_block_topk_fast (photo_search_engine_tpu/ops/topk.py:301-342),
// launched by _pallas_twophase_impl (:395-480), and _grouped_kernel with
// fast=True (grouped_mask.py:167-211, grouped_mask_search(impl=
// "pallas_fast")).  It is kFast = true: the scoring loop is kernel 1's
// (block_score.cuh), only the selection differs.  Each score becomes a
// unique 32-bit key whose low bits hold the column (select_block_topk_fast
// in block_select.cuh), so a round of the warp's selection is one
// __reduce_max_sync instead of a five-step butterfly over (value, column)
// pairs (10 shuffles).  The partials hold the quantized scores the TPU
// kernel writes; the wrapper rescores the k winners exactly.
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
// INT_MAX (kernel 3: quantized scores, and -inf slots carry the column the
// key decodes to, as on the TPU).  The merge over blocks (phase B) is a
// stable sort in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_score.cuh"
#include "block_select.cuh"

namespace {

using namespace pse;

template <typename T, int BQ, bool kGrouped, bool kFast>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ corpus, const T* __restrict__ queries,
                  const float* __restrict__ qnorms,
                  const float* __restrict__ cnorms,
                  const int8_t* __restrict__ mask, Predicates pred,
                  float* __restrict__ out_v, int* __restrict__ out_i, int n,
                  int d, int q, int count, int k, int bn, int l2) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int blk = blockIdx.y;
  const int row0 = blk * bn;
  score_block<T, BQ, kGrouped>(corpus, queries, qnorms, cnorms, mask, pred, smem, n, d, q,
                               count, bn, l2, q0, row0);
  __syncthreads();
  if constexpr (kFast)
    select_block_topk_fast<BQ>(smem, bn, q0, q, blk, gridDim.y, row0, k, out_v, out_i);
  else
    select_block_topk<BQ>(smem, bn, q0, q, blk, gridDim.y, row0, k, out_v, out_i);
}

template <typename T, int BQ, bool kGrouped, bool kFast>
cudaError_t run(const void* corpus, const void* queries, const void* qnorms,
                const void* cnorms, const void* mask, Predicates pred, void* out_v,
                void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * score_smem_floats<BQ>(bn);
  auto kernel = block_topk_kernel<T, BQ, kGrouped, kFast>;
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

template <typename T, bool kGrouped, bool kFast = false>
int dispatch(const void* corpus, const void* queries, const void* qnorms,
             const void* cnorms, const void* mask, Predicates pred, void* out_v,
             void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q <= 8)
    return run<T, 8, kGrouped, kFast>(corpus, queries, qnorms, cnorms, mask, pred, out_v,
                                      out_i, n, d, q, count, k, bn, l2, s);
  return run<T, 32, kGrouped, kFast>(corpus, queries, qnorms, cnorms, mask, pred, out_v,
                                     out_i, n, d, q, count, k, bn, l2, s);
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

// Kernel 3: kernel 1 with packed-key selection; the outputs hold the
// quantized scores (see select_block_topk_fast).
extern "C" int pse_fast_block_topk_f32(const void* corpus, const void* queries,
                                       const void* qnorms, const void* cnorms,
                                       const void* mask, void* out_v, void* out_i,
                                       int n, int d, int q, int count, int k, int bn,
                                       int l2, void* stream) {
  return dispatch<float, false, true>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{},
                                      out_v, out_i, n, d, q, count, k, bn, l2, stream);
}

extern "C" int pse_fast_block_topk_bf16(const void* corpus, const void* queries,
                                        const void* qnorms, const void* cnorms,
                                        const void* mask, void* out_v, void* out_i,
                                        int n, int d, int q, int count, int k, int bn,
                                        int l2, void* stream) {
  return dispatch<__nv_bfloat16, false, true>(corpus, queries, qnorms, cnorms, mask,
                                              pse::Predicates{}, out_v, out_i, n, d, q,
                                              count, k, bn, l2, stream);
}

// Kernel 3 through kernel 5's body: grouped_mask_search(impl="pallas_fast").
extern "C" int pse_fast_grouped_block_topk_f32(const void* corpus, const void* queries,
                                               const void* table, const void* ids,
                                               void* out_v, void* out_i, int n, int d,
                                               int q, int count, int k, int bn, int m,
                                               void* stream) {
  return dispatch<float, true, true>(corpus, queries, nullptr, nullptr, nullptr,
                                     pse::make_predicates(table, ids, m), out_v, out_i, n, d,
                                     q, count, k, bn, 0, stream);
}

extern "C" int pse_fast_grouped_block_topk_bf16(const void* corpus, const void* queries,
                                                const void* table, const void* ids,
                                                void* out_v, void* out_i, int n, int d,
                                                int q, int count, int k, int bn, int m,
                                                void* stream) {
  return dispatch<__nv_bfloat16, true, true>(corpus, queries, nullptr, nullptr, nullptr,
                                             pse::make_predicates(table, ids, m), out_v,
                                             out_i, n, d, q, count, k, bn, 0, stream);
}
