// Kernel 4: the fused running top-k scan (float32 or bfloat16 corpus).
//
// Replaces: _topk_kernel (photo_search_engine_tpu/ops/topk.py:483-556),
// launched there by _pallas_impl (:563-630), exact_search(impl=
// "pallas_fused").  On the TPU one grid row walks every corpus block in
// order for its query tile, keeps the top-k in VMEM scratch, and merges a
// block only when the block's best score reaches the running k-th value;
// no [Q, NB, k] partials reach HBM.
//
// What bounds it on the H100: the same work as kernel 1.  At 1M x 1536 bf16
// every batch reads the 3.1 GB corpus (about 0.92 ms at 3.35 TB/s); the
// product (0.39 TFLOP at batch 128) takes 0.40 ms on the bf16 tensor cores,
// 5.9 ms as f32 FMAs at 67 TFLOP/s.
//
// What the design does about it: Hopper runs CTAs in parallel and in no
// order, and one CTA per query tile would keep 1 of 132 SMs busy at batch 1,
// so the sequential grid is not copied.  The grid is (query tile, range):
// each range is a contiguous run of blocks, with enough ranges to fill the
// card's CTA slots (topk.fused_ranges).  Each CTA keeps a [BQ, k] running
// top-k over its range, and a second kernel merges the [Q, S, k] range
// partials to [Q, k] on the card (ties to the smallest row id), one warp
// per query walking the heads of the S sorted lists.
//
// Which loop runs.
// - bf16 with d % 8 == 0 (16-byte-aligned bases): kernel 1's entry point,
//   pse_block_topk_bf16 (block_topk.cu, the tensor-core scan of
//   block_score_tc.cuh), with a range of blocks_per_range * bn rows as its
//   block, so that its [Q, S, k] outputs are the range partials; no kernel
//   of its own, then the merge below.  The scan's passes of 512 rows carry
//   each query's running top-k, and select_pass keeps only the positions at
//   or above the running k-th (the TPU kernel's skip, row by row).  Each
//   output element sums over D in the same order wherever its row lies and
//   the selections are exact with ties to the smallest row, so the result
//   equals kernel 1 followed by merge_partials bit for bit, ranges included.
// - float32 with d % 4 == 0 (ring != 0, the wrapper's choice): the same,
//   through kernel 1's entry point pse_block_topk_f32 on the f32 ring
//   (fmaf consumers on the TMA ring), then the merge.
// - other float32 widths (or ring == 0), and bf16 with d % 8 != 0: kernel
//   1's FMA loop (block_score.cuh, fmaf) block by block, each merged into
//   the running top-k by merge_block (value, then row id), unless the
//   block's best cannot reach the query's running k-th.
//
// Outputs: the [Q, S, k] range partials and the [Q, k] result, float32
// scores (higher is better; l2 as -(|q|^2 + |c|^2 - 2 q.c)) and int32 row
// ids, padded with -inf and INT_MAX.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "block_score.cuh"
#include "block_select.cuh"

// Kernel 1 (block_topk.cu): kernel 4's scan on the ring, bf16 on the
// tensor cores, f32 with fmaf consumers (ring != 0).
extern "C" int pse_block_topk_bf16(const void* corpus, const void* queries, const void* qnorms,
                                   const void* cnorms, const void* mask, void* out_v, void* out_i,
                                   int n, int d, int q, int count, int k, int bn, int l2,
                                   void* stream);
extern "C" int pse_block_topk_f32(const void* corpus, const void* queries, const void* qnorms,
                                  const void* cnorms, const void* mask, void* out_v, void* out_i,
                                  int n, int d, int q, int count, int k, int bn, int l2, int ring,
                                  void* stream);

namespace {

using namespace pse;

// The FMA loop's merge (float32, and bf16 with d % 8 != 0): each query row
// of the block's score tile merges into its running top-k, one warp per
// row, unless the block cannot displace the row's k-th entry.  Kept out of
// line, as kernel 3's selection is (block_select.cuh): inlined, it changed
// how the compiler scheduled the scoring loop, and this kernel took 48.9 ms
// at batch 128 (1M x 1536 bf16, top-50, H100), 46.7 out of line.  A query
// seldom skips a whole block: the running k-th is seldom above a block's
// best.
__device__ __noinline__ void merge_block(float* scores, int bn, int nrows, int k, int row0,
                                         float* run_v, int* run_i) {
  const int lane = threadIdx.x % 32;
  for (int ql = threadIdx.x / 32; ql < nrows; ql += kWarps) {  // warp-uniform
    float* row = scores + ql * bn;
    float bmax = -CUDART_INF_F;
    for (int c = lane; c < bn; c += 32) bmax = fmaxf(bmax, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
    // the block cannot displace the query's running k-th entry: skip it
    if (bmax == -CUDART_INF_F || bmax < run_v[ql * k + k - 1]) continue;
    merge_topk_ids(run_v + ql * k, run_i + ql * k, k, row, bn, row0);
  }
}

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const T* __restrict__ corpus, const T* __restrict__ queries,
                  const float* __restrict__ qnorms, const float* __restrict__ cnorms,
                  const int8_t* __restrict__ mask, float* __restrict__ part_v,
                  int* __restrict__ part_i, int n, int d, int q, int count, int k, int bn,
                  int l2, int blocks_per_range) {
  extern __shared__ float smem[];
  float* run_v = smem + score_smem_floats<BQ>(bn);       // [BQ][k], after the score tile
  int* run_i = reinterpret_cast<int*>(run_v + BQ * k);   // [BQ][k]
  const int q0 = blockIdx.x * BQ;
  const int range = blockIdx.y;
  const int nb = (n + bn - 1) / bn;
  const int b_end = min(nb, (range + 1) * blocks_per_range);
  const int nrows = q - q0 < BQ ? q - q0 : BQ;

  for (int e = threadIdx.x; e < BQ * k; e += kThreads) {
    run_v[e] = -CUDART_INF_F;
    run_i[e] = INT_MAX;
  }
  for (int blk = range * blocks_per_range; blk < b_end; ++blk) {
    const int row0 = blk * bn;
    score_block<T, BQ, false>(corpus, queries, qnorms, cnorms, mask, Predicates{}, smem, n, d,
                              q, count, bn, l2, q0, row0);
    __syncthreads();
    merge_block(smem, bn, nrows, k, row0, run_v, run_i);
    __syncthreads();  // the tile and the staging are rewritten next
  }
  for (int e = threadIdx.x; e < nrows * k; e += kThreads) {
    const int ql = e / k, s = e % k;
    const size_t out = (static_cast<size_t>(q0 + ql) * gridDim.y + range) * k + s;
    part_v[out] = run_v[e];
    part_i[out] = run_i[e];
  }
}

// One warp per query merges its S range lists (each sorted by value
// descending, then id ascending) to the top-k: lane l owns ranges l, l + 32,
// ...; a round picks the best head by the butterfly and its owner advances
// that list.  heads: [kWarps][S] ints of shared memory.
__global__ void __launch_bounds__(kThreads)
fused_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                   float* __restrict__ out_v, int* __restrict__ out_i, int q, int s,
                   int k) {
  extern __shared__ int heads[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gq = blockIdx.x * kWarps + warp;
  if (gq >= q) return;  // warp-uniform, and no block barrier follows
  int* head = heads + warp * s;
  for (int r = lane; r < s; r += 32) head[r] = 0;
  __syncwarp();
  const float* pv = part_v + static_cast<size_t>(gq) * s * k;
  const int* pi = part_i + static_cast<size_t>(gq) * s * k;

  auto lane_best = [&](float& bv, int& bid, int& br) {
    bv = -CUDART_INF_F;
    bid = INT_MAX;
    br = -1;
    for (int r = lane; r < s; r += 32) {
      if (head[r] >= k) continue;
      const float v = pv[r * k + head[r]];
      const int id = pi[r * k + head[r]];
      if (better_id(v, id, bv, bid)) {
        bv = v;
        bid = id;
        br = r;
      }
    }
  };
  float bv;
  int bid, br;
  lane_best(bv, bid, br);
  for (int slot = 0; slot < k; ++slot) {
    float wv = bv;
    int wid = bid;
    warp_best_id(wv, wid);
    if (lane == 0) {
      out_v[static_cast<size_t>(gq) * k + slot] = wv;
      out_i[static_cast<size_t>(gq) * k + slot] = wid;
    }
    if (br >= 0 && bid == wid && bv == wv) {  // the owner advances its list
      ++head[br];
      lane_best(bv, bid, br);
    }
  }
}

cudaError_t merge(const void* part_v, const void* part_i, void* out_v, void* out_i, int q,
                  int ranges, int k, cudaStream_t stream) {
  const size_t merge_smem = sizeof(int) * kWarps * static_cast<size_t>(ranges);
  fused_merge_kernel<<<(q + kWarps - 1) / kWarps, kThreads, merge_smem, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), q, ranges, k);
  return cudaGetLastError();
}

template <typename T, int BQ>
cudaError_t run(const void* corpus, const void* queries, const void* qnorms,
                const void* cnorms, const void* mask, void* part_v, void* part_i,
                void* out_v, void* out_i, int n, int d, int q, int count, int k, int bn,
                int l2, int ranges, int blocks_per_range, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (score_smem_floats<BQ>(bn) + 2 * static_cast<size_t>(BQ) * k);
  auto kernel = fused_topk_kernel<T, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return err;
  }
  kernel<<<dim3((q + BQ - 1) / BQ, ranges), kThreads, smem, stream>>>(
      static_cast<const T*>(corpus), static_cast<const T*>(queries),
      static_cast<const float*>(qnorms), static_cast<const float*>(cnorms),
      static_cast<const int8_t*>(mask), static_cast<float*>(part_v),
      static_cast<int*>(part_i), n, d, q, count, k, bn, l2, blocks_per_range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(part_v, part_i, out_v, out_i, q, ranges, k, stream);
}

// `ring` (float32 only: the wrapper's choice of loop; bf16 takes the
// tensor cores whenever d % 8 == 0).
template <typename T>
int dispatch(const void* corpus, const void* queries, const void* qnorms, const void* cnorms,
             const void* mask, void* part_v, void* part_i, void* out_v, void* out_i, int n,
             int d, int q, int count, int k, int bn, int l2, int ranges,
             int blocks_per_range, int ring, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  if (kBf16 ? d % 8 == 0 : ring != 0) {  // the ring: kernel 1 with a range as its block, then the merge
    const long long span = static_cast<long long>(blocks_per_range) * bn;
    if (span > INT_MAX) return cudaErrorInvalidValue;
    const int err = kBf16 ? pse_block_topk_bf16(corpus, queries, qnorms, cnorms, mask, part_v, part_i, n, d, q,
                                                count, k, static_cast<int>(span), l2, stream)
                          : pse_block_topk_f32(corpus, queries, qnorms, cnorms, mask, part_v, part_i, n, d, q,
                                               count, k, static_cast<int>(span), l2, 1, stream);
    if (err != cudaSuccess) return err;
    return merge(part_v, part_i, out_v, out_i, q, ranges, k, s);
  }
  if (q <= 8)
    return run<T, 8>(corpus, queries, qnorms, cnorms, mask, part_v, part_i, out_v, out_i, n, d,
                     q, count, k, bn, l2, ranges, blocks_per_range, s);
  return run<T, 32>(corpus, queries, qnorms, cnorms, mask, part_v, part_i, out_v, out_i, n, d,
                    q, count, k, bn, l2, ranges, blocks_per_range, s);
}

}  // namespace

// part_v/part_i: [q][ranges][k]; out_v/out_i: [q][k].  Range r covers blocks
// [r * blocks_per_range, (r + 1) * blocks_per_range) of `bn` rows.  bf16
// with d % 8 == 0 runs on the tensor cores (16-byte-aligned bases, else
// cudaErrorMisalignedAddress); float32 with ring != 0 on the ring with fmaf
// consumers (d % 4 == 0 and 16-byte-aligned bases, else
// cudaErrorInvalidValue); everything else on the FMA loop.
extern "C" int pse_fused_topk_f32(const void* corpus, const void* queries, const void* qnorms,
                                  const void* cnorms, const void* mask, void* part_v,
                                  void* part_i, void* out_v, void* out_i, int n, int d, int q,
                                  int count, int k, int bn, int l2, int ranges,
                                  int blocks_per_range, int ring, void* stream) {
  return dispatch<float>(corpus, queries, qnorms, cnorms, mask, part_v, part_i, out_v, out_i, n,
                         d, q, count, k, bn, l2, ranges, blocks_per_range, ring, stream);
}

extern "C" int pse_fused_topk_bf16(const void* corpus, const void* queries, const void* qnorms,
                                   const void* cnorms, const void* mask, void* part_v,
                                   void* part_i, void* out_v, void* out_i, int n, int d, int q,
                                   int count, int k, int bn, int l2, int ranges,
                                   int blocks_per_range, void* stream) {
  return dispatch<__nv_bfloat16>(corpus, queries, qnorms, cnorms, mask, part_v, part_i, out_v,
                                 out_i, n, d, q, count, k, bn, l2, ranges, blocks_per_range, 0,
                                 stream);
}
