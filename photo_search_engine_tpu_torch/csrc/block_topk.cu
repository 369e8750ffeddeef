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
// "pallas_fast")).  Each score becomes a unique 32-bit key whose low bits
// hold the block-local column, so ties go to the smallest column and the
// winning column falls out of the key.  bf16 with d % 8 == 0 runs kernel 1's
// (or 5's) tensor-core scan with kKeys (block_score_tc.cuh): its scoring
// loop and epilogue unchanged, then select_pass_keys (block_select.cuh)
// keys each score as it reads the tile and keeps a running list of keys
// across the block's passes; a block of fewer than k rows fills its slots
// with the -inf lanes past its rows, as the TPU's padded tile does.  (Keyed
// in the epilogue instead, the BQ 32 instantiations spilled 32 and 144
// bytes, and kernel 3 took 0.3 ms more than kernel 1 at k = 1, batch 128.)  float32, and bf16 with d % 8 != 0, take the FMA loop (kFast =
// true) and select_block_topk_fast, k rounds of one __reduce_max_sync.  The
// partials hold the quantized scores the TPU kernel writes; the wrapper
// rescores the k winners exactly.
//
// What bounds it on the H100: at 1M x 1536 bf16 every batch reads the
// 3.1 GB corpus once from device memory: 0.92 ms at 3.35 TB/s.  The product
// is 2 * q * 1M * 1536 operations: 0.4 TFLOP at batch 128, 0.40 ms at the
// 989 TFLOP/s of bf16 on the tensor cores, so the bytes bound every batch
// up to about 300.  The first port's f32 fmaf loop ran at about 10 TFLOP/s
// and 0.8 TB/s (39.9 ms at batch 128, 3.9 ms at batch 1).
//
// What the design does about it (bf16, d % 8 == 0: block_score_tc.cuh).
// One CTA owns one block of `bn` corpus rows for BQ queries (8 at q <= 8,
// the micro-batcher's batches, else 32); query tiles run on blockIdx.x, so
// the CTAs of one corpus block run together and its re-reads hit L2.  A
// producer warp keeps a ring of 4 corpus boxes ([128 rows, 64], 16 KB) and
// 2 query boxes filled by TMA (128-byte swizzle): 64 KB in flight a CTA,
// two CTAs an SM, against the 25-30 KB an SM that 3.35 TB/s needs.  Two
// consumer warpgroups multiply their 64 rows of each corpus box by the
// query box with wgmma (m64n8k16 / m64n32k16, bf16 inputs, f32
// accumulators: the TPU kernel's DEFAULT-precision dot) and keep a pass of
// 512 rows in registers, so a query box serves 4 corpus boxes.  After a
// pass they apply count, mask, predicate and l2 to the accumulators and
// store them into a score tile laid over the idle ring (BQ 32); the
// threshold selection (block_select.cuh, select_pass) keeps the positions
// at or above the k-th largest of 128 subset maxima and places each by its
// rank, merging each query's running top-k of the earlier passes: exact
// f32 comparisons, ties to the smallest row, at a fraction of the cost of
// k warp rounds.  108 KB of shared memory a CTA at BQ 32, 105 KB at BQ 8.
// At batch 128 the SMs' intake of corpus re-reads (one per query tile of
// 32) and the selection remain: 2.15 ms against the 0.93 ms bound (PERF.md).
//
// Which loop runs.  bf16 with d % 8 == 0 takes the tensor cores (the
// wrappers check 16-byte-aligned bases).  float32 with d % 4 == 0 takes the
// same ring with IEEE fmaf consumers (the F32 operand of
// block_score_tc.cuh; no TF32: f32 is scored at full precision, as the JAX
// package's Precision.HIGHEST), whose sums run in the FMA loop's order, so
// its partials are the FMA loop's bit for bit; the wrapper chooses it
// (ring != 0) and may ask for the FMA loop instead on the same rows, to
// compare the two.  Other widths, whose rows TMA cannot stride, take the FMA
// loop of block_score.cuh: a TQ x 8 register tile of fmaf, D staged 32 at a
// time.  The same rule holds for kernel 3 here and for kernel 4
// (fused_topk.cu).  topk.scoring_loop names the loop a launch runs.
//
// f32 on the ring (H100, 1M x 1536, PERF.md): within 1.2x of the bytes at
// batch 1 and 8; at 128, 54 % of the 67 TFLOP/s FFMA bound.  One CTA an SM
// at a query tile of 32 (its 64 accumulators and 8 queries' floats do not
// fit two CTAs' registers), so nothing overlaps a pass's selection (top-50
// adds 5 % over top-1 at 128).
//
// Outputs: [Q, NB, k] float32 scores (higher is better; l2 as
// -(|q|^2 + |c|^2 - 2 q.c)) and int32 global row ids, padded with -inf and
// INT_MAX (kernel 3: quantized scores, and -inf slots carry the column the
// key decodes to, as on the TPU).  The merge over blocks (phase B) is a
// stable sort in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "block_score.cuh"
#include "block_score_tc.cuh"
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

// The bf16 kernels 1 and 5 on the tensor cores (block_score_tc.cuh), and
// kernel 3 through either (kKeys).
template <int BQ, int kStagesT, bool kGrouped, bool kThreshold, bool kKeys>
__global__ void __launch_bounds__(tc::kThreadsTc, 2)
tc_block_topk_kernel(const __grid_constant__ CUtensorMap corpus_map,
                     const __grid_constant__ CUtensorMap query_map,
                     const float* __restrict__ qnorms, const float* __restrict__ cnorms,
                     const int8_t* __restrict__ mask, Predicates pred,
                     float* __restrict__ out_v, int* __restrict__ out_i, int n, int d, int q,
                     int count, int k, int bn, int l2) {
  tc::tc_block_topk<tc::Bf16, BQ, kStagesT, kGrouped, kThreshold, kKeys>(
      &corpus_map, &query_map, tc::Bf16::Scales{qnorms, cnorms}, mask, pred, out_v, out_i, n, d, q,
      count, k, bn, l2);
}

// The f32 kernels 1, 3 and 5 on the same ring with fmaf consumers (the F32
// operand of block_score_tc.cuh; its stages and CTAs an SM by query tile);
// kernel 4 launches kernel 1's over its ranges.
template <int BQ, bool kGrouped, bool kKeys>
__global__ void __launch_bounds__(tc::kThreadsTc, tc::ffma_ctas<BQ>())
fma_ring_block_topk_kernel(const __grid_constant__ CUtensorMap corpus_map,
                           const __grid_constant__ CUtensorMap query_map,
                           const float* __restrict__ qnorms, const float* __restrict__ cnorms,
                           const int8_t* __restrict__ mask, Predicates pred,
                           float* __restrict__ out_v, int* __restrict__ out_i, int n, int d, int q,
                           int count, int k, int bn, int l2) {
  tc::tc_block_topk<tc::F32, BQ, tc::ffma_stages<BQ>(), kGrouped, true, kKeys>(
      &corpus_map, &query_map, tc::F32::Scales{qnorms, cnorms}, mask, pred, out_v, out_i, n, d, q,
      count, k, bn, l2);
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

// The ring kernel of an operand: bf16 (wgmma) at any ring depth and
// selection, f32 (fmaf) at its own depth (tc::ffma_stages) with the
// threshold selection.
template <typename Op, int BQ, int kStagesT, bool kGrouped, bool kThreshold, bool kKeys>
constexpr auto ring_kernel() {
  if constexpr (Op::kFfma) {
    static_assert(kThreshold, "the f32 ring selects by threshold");
    return fma_ring_block_topk_kernel<BQ, kGrouped, kKeys>;
  } else {
    return tc_block_topk_kernel<BQ, kStagesT, kGrouped, kThreshold, kKeys>;
  }
}

template <int BQ, int kStagesT, bool kGrouped, bool kThreshold, bool kKeys, typename Op>
cudaError_t run_tc(const void* corpus, const void* queries, const void* qnorms,
                   const void* cnorms, const void* mask, Predicates pred, void* out_v,
                   void* out_i, int n, int d, int q, int count, int k, int bn, int l2,
                   cudaStream_t stream) {
  CUtensorMap corpus_map, query_map;
  if (!tc::make_map<Op>(&corpus_map, corpus, n, d, tc::kRowTile) ||
      !tc::make_map<Op>(&query_map, queries, q, d, BQ))
    return cudaErrorInvalidValue;
  size_t smem = tc::smem_bytes<BQ>(kStagesT);
  if constexpr (Op::kFfma) smem = tc::smem_bytes<BQ>(tc::ffma_stages<BQ>());
  auto kernel = ring_kernel<Op, BQ, kStagesT, kGrouped, kThreshold, kKeys>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid((q + BQ - 1) / BQ, (n + bn - 1) / bn);
  kernel<<<grid, tc::kThreadsTc, smem, stream>>>(
      corpus_map, query_map, static_cast<const float*>(qnorms),
      static_cast<const float*>(cnorms), static_cast<const int8_t*>(mask), pred,
      static_cast<float*>(out_v), static_cast<int*>(out_i), n, d, q, count, k, bn, l2);
  return cudaGetLastError();
}

template <int kStagesT, bool kGrouped, bool kThreshold, bool kKeys = false, typename Op = tc::Bf16>
int dispatch_tc(const void* corpus, const void* queries, const void* qnorms, const void* cnorms,
                const void* mask, Predicates pred, void* out_v, void* out_i, int n, int d, int q,
                int count, int k, int bn, int l2, cudaStream_t s) {
  if (q <= tc::kSmallBQ)
    return run_tc<tc::kSmallBQ, kStagesT, kGrouped, kThreshold, kKeys, Op>(
        corpus, queries, qnorms, cnorms, mask, pred, out_v, out_i, n, d, q, count, k, bn, l2, s);
  return run_tc<tc::kLargeBQ, kStagesT, kGrouped, kThreshold, kKeys, Op>(
      corpus, queries, qnorms, cnorms, mask, pred, out_v, out_i, n, d, q, count, k, bn, l2, s);
}

// bf16 kernels 1 and 5 (kKeys: kernel 3 through them): the tensor cores
// where TMA can read the rows (a 16-byte row stride, d % 8 == 0, and
// 16-byte-aligned bases); other widths take the FMA loop, and the wrappers
// count those launches apart.
template <bool kGrouped, bool kKeys = false>
int dispatch_bf16(const void* corpus, const void* queries, const void* qnorms, const void* cnorms,
                  const void* mask, Predicates pred, void* out_v, void* out_i, int n, int d,
                  int q, int count, int k, int bn, int l2, void* stream) {
  if (d % 8 != 0)
    return dispatch<__nv_bfloat16, kGrouped, kKeys>(corpus, queries, qnorms, cnorms, mask, pred, out_v,
                                                    out_i, n, d, q, count, k, bn, l2, stream);
  if (reinterpret_cast<uintptr_t>(corpus) % 16 || reinterpret_cast<uintptr_t>(queries) % 16)
    return cudaErrorMisalignedAddress;
  return dispatch_tc<tc::kStages, kGrouped, true, kKeys>(corpus, queries, qnorms, cnorms, mask, pred,
                                                         out_v, out_i, n, d, q, count, k, bn, l2,
                                                         static_cast<cudaStream_t>(stream));
}

// float32 kernels 1 and 5 (kKeys: kernel 3 through them) on the loop the
// wrapper chose (topk.scoring_loop): ring != 0 the TMA ring with fmaf
// consumers, which takes rows TMA can stride (d % 4 == 0) on
// 16-byte-aligned bases and refuses others (cudaErrorInvalidValue) rather
// than run another loop; ring == 0 the FMA loop, any d.
template <bool kGrouped, bool kKeys = false>
int dispatch_f32(const void* corpus, const void* queries, const void* qnorms, const void* cnorms,
                 const void* mask, Predicates pred, void* out_v, void* out_i, int n, int d, int q,
                 int count, int k, int bn, int l2, int ring, void* stream) {
  if (!ring)
    return dispatch<float, kGrouped, kKeys>(corpus, queries, qnorms, cnorms, mask, pred, out_v, out_i, n, d,
                                            q, count, k, bn, l2, stream);
  if (d % 4 != 0 || reinterpret_cast<uintptr_t>(corpus) % 16 || reinterpret_cast<uintptr_t>(queries) % 16)
    return cudaErrorInvalidValue;
  return dispatch_tc<tc::kStages, kGrouped, true, kKeys, tc::F32>(corpus, queries, qnorms, cnorms, mask, pred,
                                                                  out_v, out_i, n, d, q, count, k, bn, l2,
                                                                  static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int pse_block_topk_f32(const void* corpus, const void* queries,
                                  const void* qnorms, const void* cnorms,
                                  const void* mask, void* out_v, void* out_i,
                                  int n, int d, int q, int count, int k, int bn,
                                  int l2, int ring, void* stream) {
  return dispatch_f32<false>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{}, out_v, out_i, n, d, q,
                             count, k, bn, l2, ring, stream);
}

extern "C" int pse_block_topk_bf16(const void* corpus, const void* queries,
                                   const void* qnorms, const void* cnorms,
                                   const void* mask, void* out_v, void* out_i,
                                   int n, int d, int q, int count, int k, int bn,
                                   int l2, void* stream) {
  return dispatch_bf16<false>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{}, out_v,
                              out_i, n, d, q, count, k, bn, l2, stream);
}

// Kernel 1, bf16, on the tensor cores at a chosen ring depth (2, 4 or 6
// stages) and selection (0: the k rounds, 1: the threshold), for
// scripts/torch_kernel_sweep.py; needs d % 8 == 0.
extern "C" int pse_block_topk_bf16_geometry(const void* corpus, const void* queries,
                                            const void* qnorms, const void* cnorms,
                                            const void* mask, void* out_v, void* out_i, int n,
                                            int d, int q, int count, int k, int bn, int l2,
                                            int stages, int threshold, void* stream) {
  using pse::tc::kStages;
  using pse::tc::kSweepStages;
  if (d % 8 != 0 || reinterpret_cast<uintptr_t>(corpus) % 16 ||
      reinterpret_cast<uintptr_t>(queries) % 16)
    return cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(corpus, queries, qnorms, cnorms, mask, pse::Predicates{}, out_v, out_i, n, d, q,
                  count, k, bn, l2, static_cast<cudaStream_t>(stream));
  };
  if (stages == kStages)
    return threshold ? run(dispatch_tc<kStages, false, true>) : run(dispatch_tc<kStages, false, false>);
  if (stages == kSweepStages)
    return threshold ? run(dispatch_tc<kSweepStages, false, true>)
                     : run(dispatch_tc<kSweepStages, false, false>);
  if (stages == 2 && threshold) return run(dispatch_tc<2, false, true>);
  return cudaErrorInvalidValue;
}

// Kernel 5: table is [m][n] int8, ids [q] int32 (see Predicates).
extern "C" int pse_grouped_block_topk_f32(const void* corpus, const void* queries,
                                          const void* table, const void* ids,
                                          void* out_v, void* out_i, int n, int d,
                                          int q, int count, int k, int bn, int m,
                                          int ring, void* stream) {
  return dispatch_f32<true>(corpus, queries, nullptr, nullptr, nullptr, pse::make_predicates(table, ids, m),
                            out_v, out_i, n, d, q, count, k, bn, 0, ring, stream);
}

extern "C" int pse_grouped_block_topk_bf16(const void* corpus, const void* queries,
                                           const void* table, const void* ids,
                                           void* out_v, void* out_i, int n, int d,
                                           int q, int count, int k, int bn, int m,
                                           void* stream) {
  return dispatch_bf16<true>(corpus, queries, nullptr, nullptr, nullptr,
                             pse::make_predicates(table, ids, m), out_v, out_i, n, d, q, count,
                             k, bn, 0, stream);
}

// Kernel 3: kernel 1 with packed-key selection; the outputs hold the
// quantized scores (see select_pass_keys, select_block_topk_fast).
extern "C" int pse_fast_block_topk_f32(const void* corpus, const void* queries,
                                       const void* qnorms, const void* cnorms,
                                       const void* mask, void* out_v, void* out_i,
                                       int n, int d, int q, int count, int k, int bn,
                                       int l2, int ring, void* stream) {
  return dispatch_f32<false, true>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{}, out_v, out_i, n,
                                   d, q, count, k, bn, l2, ring, stream);
}

extern "C" int pse_fast_block_topk_bf16(const void* corpus, const void* queries,
                                        const void* qnorms, const void* cnorms,
                                        const void* mask, void* out_v, void* out_i,
                                        int n, int d, int q, int count, int k, int bn,
                                        int l2, void* stream) {
  return dispatch_bf16<false, true>(corpus, queries, qnorms, cnorms, mask, pse::Predicates{}, out_v,
                                    out_i, n, d, q, count, k, bn, l2, stream);
}

// Kernel 3 through kernel 5's body: grouped_mask_search(impl="pallas_fast").
extern "C" int pse_fast_grouped_block_topk_f32(const void* corpus, const void* queries,
                                               const void* table, const void* ids,
                                               void* out_v, void* out_i, int n, int d,
                                               int q, int count, int k, int bn, int m,
                                               int ring, void* stream) {
  return dispatch_f32<true, true>(corpus, queries, nullptr, nullptr, nullptr, pse::make_predicates(table, ids, m),
                                  out_v, out_i, n, d, q, count, k, bn, 0, ring, stream);
}

extern "C" int pse_fast_grouped_block_topk_bf16(const void* corpus, const void* queries,
                                                const void* table, const void* ids,
                                                void* out_v, void* out_i, int n, int d,
                                                int q, int count, int k, int bn, int m,
                                                void* stream) {
  return dispatch_bf16<true, true>(corpus, queries, nullptr, nullptr, nullptr,
                                   pse::make_predicates(table, ids, m), out_v, out_i, n, d, q, count,
                                   k, bn, 0, stream);
}
