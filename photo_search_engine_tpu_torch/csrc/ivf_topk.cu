// Kernel 7: the IVF probed-cluster scan, over a float32, bfloat16 or int8
// cluster-major layout.
//
// Replaces: _ivf_kernel (photo_search_engine_tpu/models/ivf.py:247-326),
// launched there by _ivf_pallas (:335-420).
//
// The TPU kernel walks a sequential grid over the union of the probed
// clusters (scalar-prefetched ids), keeps a running top-k in VMEM scratch
// from one grid step to the next, and picks each query's probe flag with a
// one-hot sum over nlist lanes.  On the H100 blocks run in parallel and in
// no order, so none of that carries over.  Instead the wrapper
// (ops/ivf_scan.py probe_groups) sorts the (cluster, query, probe slot)
// pairs by cluster and cuts them into groups of at most BQ queries that
// probe the same cluster.  One CTA takes one (group, tile of `bn` slots of
// that cluster): it reads its own group entry and its queries' ids (this
// replaces the scalar prefetch), scores only those queries against the
// tile, so no probe flag is needed and no unprobed pair is scored, and
// writes each query's top-kk of the tile to the query's own partial slot
// [q][probe][tile][kk].  Phase B, the merge over probes and tiles, is a
// stable sort in PyTorch, as for kernel 1.  A tile never contributes more
// than its own rows, so any k is exact.
//
// What bounds it on the H100: at batch 1 with nprobe 64 of 1024 clusters of
// L = 1536 slots at 1536-d bf16, the bytes of the probed clusters: 64 x 1536
// x 3 KB = 302 MB (0.09 ms at 3.35 TB/s; about 0.4 ms at the 770 GB/s that
// kernel 1's loads reach).  At batch 128 the FMAs over the probe pairs:
// 8192 pairs x 1536 slots x 1536 = 19.3 G FMAs (38.6 GFLOP), which the
// FP32 pipe (67 TFLOP/s peak) cannot do in less than 0.6 ms.
//
// What the design does about it: the tile geometry, the fmaf / __dp4a
// accumulation and the selection are kernel 1's and kernel 2's
// (block_select.cuh): each thread keeps a TQ x 8 register tile of
// accumulators, D is staged 32 at a time, transposed with an odd pitch, and
// the scores stay in a [BQ, bn] shared-memory tile until the selection
// writes kk of them per query.  Every slot a CTA stages feeds all the
// queries of its group, and the groups of one cluster are neighbours on
// blockIdx.x, so a tile that a second group re-reads comes from L2.  The
// wrapper picks BQ (8, 16 or 32) from the mean number of queries per probed
// cluster, and a warp whose queries are all padding skips the products, so
// at batch 1 the CTAs spend their issue slots on the loads.  wgmma, TMA and
// wider loads are later work, as for kernel 1.
//
// Scores (higher is better): ip <q, c>; l2 2<q, c> - |c|^2 (the wrapper
// subtracts |q|^2, as the TPU kernel's caller does); int8 (acc * qs) * cs
// with acc the exact int32 dot.  Slots where row_valid is 0 (padding, or
// dropped by a filter) are -inf.  Ids are global layout slots (cluster * L
// + row); slots with no valid row hold -inf and INT_MAX.  The int8 layout
// needs D % 4 == 0 (rows are read as int8x4 words; the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "block_select.cuh"

namespace {

using namespace pse;

// One staged element: float for the float layouts, an int8x4 word for int8.
template <typename Word> struct Staged { using type = float; };
template <> struct Staged<int> { using type = int; };

__device__ __forceinline__ float stage(float x) { return x; }
__device__ __forceinline__ float stage(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int stage(int x) { return x; }

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return __dp4a(a, b, c); }

// the int8 score: the exact int32 dot, then the query scale, then the row's
__device__ __forceinline__ float scaled(int acc, float qs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), qs), cs);
}

template <typename Word, int BQ>
__global__ void __launch_bounds__(kThreads)
ivf_topk_kernel(const Word* __restrict__ corpus,    // [nlist * L][words]
                const Word* __restrict__ queries,   // [q][words]
                const float* __restrict__ qscales,  // [q], int8 only
                const float* __restrict__ cscales,  // [nlist * L], int8 only
                const float* __restrict__ cnorms,   // [nlist * L], l2 only
                const int8_t* __restrict__ row_valid,
                const int* __restrict__ groups,     // [n_groups][3]: cluster, first pair, size
                const int* __restrict__ pair_query, const int* __restrict__ pair_slot,
                float* __restrict__ out_v, int* __restrict__ out_i, int tiles,
                int lrows, int words, int nprobe, int kk, int bn, int l2) {
  using S = typename Staged<Word>::type;
  constexpr bool kInt8 = std::is_same<Word, int>::value;
  constexpr int TQ = BQ / kWarps;  // queries per thread
  extern __shared__ float smem[];
  float* scores = smem;                                 // [BQ][bn]
  S* q_s = reinterpret_cast<S*>(scores + BQ * bn);      // [kDepth][BQ + 1]
  S* c_s = q_s + kDepth * (BQ + 1);                     // [kDepth][kPitch]
  __shared__ int qid_s[BQ];
  __shared__ int slot_s[BQ];

  const int tid = threadIdx.x;
  const int rg = tid % 32;  // row group: rows rg + 32 * j of the pass
  const int qg = tid / 32;  // query group: queries qg * TQ + i
  const int cluster = groups[3 * blockIdx.x];
  const int first = groups[3 * blockIdx.x + 1];
  const int size = groups[3 * blockIdx.x + 2];
  const int tile = blockIdx.y;
  const int row0 = cluster * lrows + tile * bn;        // first slot of the tile
  const int rows = min(bn, lrows - tile * bn);         // slots of the tile
  for (int i = tid; i < BQ; i += kThreads) {
    qid_s[i] = i < size ? pair_query[first + i] : -1;
    slot_s[i] = i < size ? pair_slot[first + i] : 0;
  }
  __syncthreads();
  const bool active = qg * TQ < size;  // warp-uniform: this warp has a live query

  for (int sub = 0; sub < rows; sub += kTileRows) {
    S acc[TQ][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = S(0);

    for (int w0 = 0; w0 < words; w0 += kDepth) {
      for (int e = tid; e < BQ * kDepth; e += kThreads) {
        const int ql = e / kDepth, ww = e % kDepth;
        const int qid = qid_s[ql], gw = w0 + ww;
        q_s[ww * (BQ + 1) + ql] =
            (qid >= 0 && gw < words) ? stage(queries[static_cast<size_t>(qid) * words + gw]) : S(0);
      }
      // a warp reads 32 consecutive words of one slot (coalesced) and
      // writes them down one column of the transposed tile
      const int ww = tid % 32;
      const int gw = w0 + ww;
#pragma unroll 4
      for (int i = 0; i < kTileRows / kWarps; ++i) {
        const int r = i * kWarps + tid / 32;
        c_s[ww * kPitch + r] =
            (sub + r < rows && gw < words)
                ? stage(corpus[static_cast<size_t>(row0 + sub + r) * words + gw])
                : S(0);
      }
      __syncthreads();
      if (active) {
#pragma unroll 8
        for (int e = 0; e < kDepth; ++e) {
          S qv[TQ], cv[kRowsPerThread];
#pragma unroll
          for (int i = 0; i < TQ; ++i) qv[i] = q_s[e * (BQ + 1) + qg * TQ + i];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) cv[j] = c_s[e * kPitch + rg + 32 * j];
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = mac(qv[i], cv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // epilogue: -inf where row_valid is 0 or the query is padding; the
    // int8 scaling and the l2 merge as in the TPU kernel
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int lc = sub + rg + 32 * j;
      if (lc >= rows) continue;
      const int col = row0 + lc;
      const bool live = row_valid[col] > 0;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int ql = qg * TQ + i;
        float s = -CUDART_INF_F;
        if (live && ql < size) {
          if constexpr (kInt8) {
            s = scaled(acc[i][j], qscales[qid_s[ql]], cscales[col]);
          } else {
            s = acc[i][j];
          }
          if (l2) s = __fsub_rn(__fmul_rn(2.f, s), cnorms[col]);
        }
        scores[ql * bn + lc] = s;
      }
    }
  }
  __syncthreads();
  select_topk(scores, bn, rows, size, row0, kk,
              [&](int ql) {
                return ((static_cast<size_t>(qid_s[ql]) * nprobe + slot_s[ql]) * tiles + tile) * kk;
              },
              out_v, out_i);
}

template <typename Word, int BQ>
cudaError_t run(const void* corpus, const void* queries, const void* qscales,
                const void* cscales, const void* cnorms, const void* row_valid,
                const void* groups, const void* pair_query, const void* pair_slot,
                void* out_v, void* out_i, int n_groups, int tiles, int lrows, int words,
                int nprobe, int kk, int bn, int l2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * bn + kDepth * (BQ + 1) + kDepth * kPitch);
  auto kernel = ivf_topk_kernel<Word, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return err;
  }
  const dim3 grid(n_groups, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Word*>(corpus), static_cast<const Word*>(queries),
      static_cast<const float*>(qscales), static_cast<const float*>(cscales),
      static_cast<const float*>(cnorms), static_cast<const int8_t*>(row_valid),
      static_cast<const int*>(groups), static_cast<const int*>(pair_query),
      static_cast<const int*>(pair_slot), static_cast<float*>(out_v), static_cast<int*>(out_i),
      tiles, lrows, words, nprobe, kk, bn, l2);
  return cudaGetLastError();
}

template <typename Word>
int dispatch(const void* corpus, const void* queries, const void* qscales, const void* cscales,
             const void* cnorms, const void* row_valid, const void* groups,
             const void* pair_query, const void* pair_slot, void* out_v, void* out_i,
             int n_groups, int tiles, int lrows, int words, int nprobe, int kk, int bn,
             int bq, int l2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bq == 8)
    return run<Word, 8>(corpus, queries, qscales, cscales, cnorms, row_valid, groups,
                        pair_query, pair_slot, out_v, out_i, n_groups, tiles, lrows, words,
                        nprobe, kk, bn, l2, s);
  if (bq == 16)
    return run<Word, 16>(corpus, queries, qscales, cscales, cnorms, row_valid, groups,
                         pair_query, pair_slot, out_v, out_i, n_groups, tiles, lrows, words,
                         nprobe, kk, bn, l2, s);
  if (bq == 32)
    return run<Word, 32>(corpus, queries, qscales, cscales, cnorms, row_valid, groups,
                         pair_query, pair_slot, out_v, out_i, n_groups, tiles, lrows, words,
                         nprobe, kk, bn, l2, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// All three take the same arguments: d is the width in elements; qscales
// and cscales are read by the int8 entry only, cnorms only when l2 != 0.
#define PSE_IVF_ENTRY(name, Word, words_of_d)                                                \
  extern "C" int name(const void* corpus, const void* queries, const void* qscales,          \
                      const void* cscales, const void* cnorms, const void* row_valid,        \
                      const void* groups, const void* pair_query, const void* pair_slot,     \
                      void* out_v, void* out_i, int n_groups, int tiles, int lrows, int d,   \
                      int nprobe, int kk, int bn, int bq, int l2, void* stream) {            \
    return dispatch<Word>(corpus, queries, qscales, cscales, cnorms, row_valid, groups,      \
                          pair_query, pair_slot, out_v, out_i, n_groups, tiles, lrows,       \
                          words_of_d, nprobe, kk, bn, bq, l2, stream);                       \
  }

PSE_IVF_ENTRY(pse_ivf_topk_f32, float, d)
PSE_IVF_ENTRY(pse_ivf_topk_bf16, __nv_bfloat16, d)
PSE_IVF_ENTRY(pse_ivf_topk_int8, int, d / 4)
