// Kernel 7: the IVF probed-cluster scan, over a float32, bfloat16 or int8
// cluster-major layout.
//
// Replaces: _ivf_kernel (photo_search_engine_tpu/models/ivf.py:247-326),
// launched there by _ivf_pallas (:335-420); the work list below replaces
// the probe matrix and cluster selection the JAX search builds around it
// (:899-909).
//
// The TPU kernel walks a sequential grid over the union of the probed
// clusters (scalar-prefetched ids), keeps a running top-k in VMEM scratch
// from one grid step to the next, and picks each query's probe flag with a
// one-hot sum over nlist lanes.  On the H100 blocks run in parallel and in
// no order, so none of that carries over.  Instead the (query, probe slot)
// pairs, sorted stably by cluster (torch.sort in the wrapper), are cut on
// the card into groups of at most BQ pairs that probe the same cluster
// (ivf_work_kernel: one CTA, no read-back to the host), each group's queries
// are copied into a group-major buffer (ivf_gather_kernel), and one CTA of
// the scan takes one (group, tile of `bn` slots of that cluster): it scores
// only the group's queries against the tile, so no probe flag is needed and
// no unprobed pair is scored, and writes each pair's top-kk of the tile to
// the pair's own partial [q][probe][tile][kk].  The grid is sized on the
// host by a bound on the group count (ops/ivf_scan.py ivf_group_bound);
// CTAs past the true count leave at once.  Phase B, the merge over probes
// and tiles, is a stable sort in PyTorch, as for kernel 1.  A tile never
// contributes more than its own rows, so any k is exact.  A probe id
// outside [0, nlist) forms no group: its pair's partials hold -inf and
// INT_MAX (written by the gather), and no row outside the layout is read.
//
// What bounds it on the H100: at batch 1 with nprobe 64 of 1024 clusters of
// L = 1536 slots at 1536-d bf16, the bytes of the probed clusters: 64 x 1536
// x 3 KB = 302 MB, 0.09 ms at 3.35 TB/s.  At batch 128 nearly every cluster
// is probed, 4.8 GB, 1.45 ms; the products (38.6 GFLOP) take 0.04 ms at the
// bf16 tensor cores' 989 TFLOP/s.  int8 halves the bytes.
//
// What the design does about it (bf16 with D % 8 == 0 and int8 with D % 16
// == 0, kk <= 64): kernels 1 and 2's tensor-core scan, block_score_tc.cuh,
// with IvfWork: a producer warp keeps TMA loads of the cluster's rows and of
// the group's query rows in flight, two consumer warpgroups run wgmma (bf16
// with f32 accumulators, or s8 with exact s32 ones), passes of 512 rows keep
// a running top-k per pair, select_pass_pairs writes each pair's list.  A
// tile of bn = L slots walks a whole cluster in one CTA (one partial list a
// pair, not L / 256); at batch 1 the tile is cut smaller so that the few
// groups still fill the SMs (the wrapper's ivf_geometry, from the sweep).
// The groups of one cluster are neighbours on blockIdx.x, so a cluster that
// a second group re-reads comes from L2.
//
// float32 with D % 4 == 0 and kk <= 64: the same ring with IEEE fmaf
// consumers (the F32 operand), whose sums run in the FMA loop's order, so
// its partials are the FMA loop's bit for bit at the same tile and group.
//
// The FMA / __dp4a loop (other float32 widths; bf16 with D % 8 != 0; int8
// with D % 16 != 0; kk > 64, the exact scan of candidate_k 500): kernel 1's
// FMA tile geometry and warp selection.  Each
// thread keeps a TQ x 8 register tile of fmaf / __dp4a accumulators, D is
// staged 32 at a time, transposed with an odd pitch, and the scores stay in
// a [BQ, bn] shared-memory tile until the selection writes kk of them per
// pair; a warp whose queries are all padding skips the products.
//
// Scores (higher is better): ip <q, c>; l2 2<q, c> - |c|^2 (the wrapper
// subtracts |q|^2, as the TPU kernel's caller does; the bf16 trait's l2
// -((|q|^2 + |c|^2) - 2 acc) with no query norm is that exactly); int8
// (acc * qs) * cs with acc the exact int32 dot.  Slots where row_valid is 0
// (padding, or dropped by a filter) are -inf.  Ids are global layout slots
// (cluster * L + row); slots with no valid row hold -inf and INT_MAX.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "block_score_tc.cuh"
#include "block_select.cuh"

namespace {

using namespace pse;

// ---------------------------------------------------------------------------
// The work list: groups of probe pairs, and the group-major query buffer
// ---------------------------------------------------------------------------

constexpr int kWorkThreads = 1024;   // one CTA walks the sorted pairs
constexpr int kGatherThreads = 256;  // a CTA a group

// The first position of `key` in sorted[0, i] (sorted[i] == key).
__device__ __forceinline__ int run_start(const int* sorted, int i, int key) {
  int lo = 0;
  while (lo < i) {
    const int mid = (lo + i) / 2;
    if (sorted[mid] < key)
      lo = mid + 1;
    else
      i = mid;
  }
  return lo;
}

// Calls start(i, key) for every position i of sorted[lo, hi) that starts a
// group: a probe id in [0, nlist) whose distance from the first position
// of its id is a multiple of bq.
template <typename Start>
__device__ __forceinline__ void group_starts(const int* sorted, int lo, int hi, int nlist, int bq, Start start) {
  int first = 0;
  for (int i = lo; i < hi; ++i) {
    const int key = sorted[i];
    if (i == lo || key != sorted[i - 1]) first = (i > 0 && sorted[i - 1] == key) ? run_start(sorted, i, key) : i;
    if (key >= 0 && key < nlist && (i - first) % bq == 0) start(i, key);
  }
}

// groups[g] = (cluster, first sorted position, size) for the g-th group in
// sorted order, (-1, 0, 0) from the group count to g_max.  Each thread
// walks a contiguous share of the p sorted ids; a scan of the threads'
// counts gives each its first group index.
__global__ void __launch_bounds__(kWorkThreads)
ivf_work_kernel(const int* __restrict__ sorted, int p, int nlist, int bq, int g_max, int* __restrict__ groups) {
  __shared__ int sums[kWorkThreads];
  const int t = threadIdx.x;
  const int per = (p + kWorkThreads - 1) / kWorkThreads;
  const int lo = min(p, t * per), hi = min(p, lo + per);
  int count = 0;
  group_starts(sorted, lo, hi, nlist, bq, [&](int, int) { ++count; });
  sums[t] = count;
  __syncthreads();
  for (int off = 1; off < kWorkThreads; off <<= 1) {  // inclusive scan
    const int v = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  const int total = sums[kWorkThreads - 1];
  int g = sums[t] - count;
  group_starts(sorted, lo, hi, nlist, bq, [&](int i, int key) {
    int size = 1;
    while (size < bq && i + size < p && sorted[i + size] == key) ++size;
    if (g < g_max) {  // always, by the bound on the group count
      groups[3 * g] = key;
      groups[3 * g + 1] = i;
      groups[3 * g + 2] = size;
    }
    ++g;
  });
  for (int e = total + t; e < g_max; e += kWorkThreads) {
    groups[3 * e] = -1;
    groups[3 * e + 1] = 0;
    groups[3 * e + 2] = 0;
  }
}

// CTA g copies the query rows of group g's pairs into rows [g * bq, g * bq
// + bq) of qbuf, zeros past the group's size (and their scales into qsbuf,
// int8), then writes -inf / INT_MAX into the partials of the pairs at
// sorted positions [g * span, g * span + span) whose probe id lies outside
// [0, nlist): no group scores those.  vec: rows move as 16-byte words.
__global__ void __launch_bounds__(kGatherThreads)
ivf_gather_kernel(const uint8_t* __restrict__ queries, const float* __restrict__ qscales,
                  const int* __restrict__ sorted, const long long* __restrict__ order,
                  const int* __restrict__ groups, uint8_t* __restrict__ qbuf, float* __restrict__ qsbuf,
                  float* __restrict__ out_v, int* __restrict__ out_i, int row_bytes, bool vec, int nprobe,
                  int bq, int p, int span, int nlist, int per_pair) {
  const int g = blockIdx.x;
  const int first = groups[3 * g + 1], size = groups[3 * g + 2];
  auto query_of = [&](int j) { return static_cast<size_t>(order[first + j] / nprobe); };
  if (size > 0) {
    uint8_t* dst = qbuf + static_cast<size_t>(g) * bq * row_bytes;
    if (vec) {
      const int words = row_bytes / 16;
      for (int e = threadIdx.x; e < bq * words; e += kGatherThreads) {
        const int j = e / words, w = e % words;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (j < size) v = reinterpret_cast<const uint4*>(queries + query_of(j) * row_bytes)[w];
        reinterpret_cast<uint4*>(dst)[e] = v;
      }
    } else {
      for (int e = threadIdx.x; e < bq * row_bytes; e += kGatherThreads) {
        const int j = e / row_bytes;
        dst[e] = j < size ? queries[query_of(j) * row_bytes + e % row_bytes] : 0;
      }
    }
    if (qsbuf != nullptr && threadIdx.x < bq)
      qsbuf[g * bq + threadIdx.x] = threadIdx.x < size ? qscales[query_of(threadIdx.x)] : 0.f;
  }
  for (int e = threadIdx.x; e < span * per_pair; e += kGatherThreads) {
    const int pos = g * span + e / per_pair;
    if (pos >= p) break;
    const int key = sorted[pos];
    if (key < 0 || key >= nlist) {
      const size_t at = static_cast<size_t>(order[pos]) * per_pair + e % per_pair;
      out_v[at] = -CUDART_INF_F;
      out_i[at] = INT_MAX;
    }
  }
}

// ---------------------------------------------------------------------------
// The FMA / __dp4a loop
// ---------------------------------------------------------------------------

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
                const Word* __restrict__ qbuf,      // [G * BQ][words], group-major
                const float* __restrict__ qsbuf,    // [G * BQ], int8 only
                const float* __restrict__ cscales,  // [nlist * L], int8 only
                const float* __restrict__ cnorms,   // [nlist * L], l2 only
                const int8_t* __restrict__ row_valid,
                const int* __restrict__ groups, const long long* __restrict__ order,
                float* __restrict__ out_v, int* __restrict__ out_i, int tiles,
                int lrows, int words, int kk, int bn, int l2) {
  using S = typename Staged<Word>::type;
  constexpr bool kInt8 = std::is_same<Word, int>::value;
  constexpr int TQ = BQ / kWarps;  // queries per thread
  const int size = groups[3 * blockIdx.x + 2];
  if (size == 0) return;  // past the group count
  extern __shared__ float smem[];
  float* scores = smem;                                 // [BQ][bn]
  S* q_s = reinterpret_cast<S*>(scores + BQ * bn);      // [kDepth][BQ + 1]
  S* c_s = q_s + kDepth * (BQ + 1);                     // [kDepth][kPitch]
  __shared__ long long pair_s[BQ];

  const int tid = threadIdx.x;
  const int rg = tid % 32;  // row group: rows rg + 32 * j of the pass
  const int qg = tid / 32;  // query group: queries qg * TQ + i
  const int cluster = groups[3 * blockIdx.x];
  const int first = groups[3 * blockIdx.x + 1];
  const size_t g0 = static_cast<size_t>(blockIdx.x) * BQ;  // the group's rows of qbuf
  const int tile = blockIdx.y;
  const int row0 = cluster * lrows + tile * bn;        // first slot of the tile
  const int rows = min(bn, lrows - tile * bn);         // slots of the tile
  for (int i = tid; i < BQ; i += kThreads) pair_s[i] = i < size ? order[first + i] : 0;
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
        const int gw = w0 + ww;
        q_s[ww * (BQ + 1) + ql] = gw < words ? stage(qbuf[(g0 + ql) * words + gw]) : S(0);
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
            s = scaled(acc[i][j], qsbuf[g0 + ql], cscales[col]);
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
              [&](int ql) { return (static_cast<size_t>(pair_s[ql]) * tiles + tile) * kk; }, out_v, out_i);
}

template <typename Word, int BQ>
cudaError_t run_fma(const void* corpus, const void* qbuf, const void* qsbuf, const void* cscales,
                    const void* cnorms, const void* row_valid, const void* groups, const void* order,
                    void* out_v, void* out_i, int g_max, int tiles, int lrows, int words, int kk, int bn,
                    int l2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ) * bn + kDepth * (BQ + 1) + kDepth * kPitch);
  auto kernel = ivf_topk_kernel<Word, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch does not report it
    return err;
  }
  const dim3 grid(g_max, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Word*>(corpus), static_cast<const Word*>(qbuf), static_cast<const float*>(qsbuf),
      static_cast<const float*>(cscales), static_cast<const float*>(cnorms),
      static_cast<const int8_t*>(row_valid), static_cast<const int*>(groups),
      static_cast<const long long*>(order), static_cast<float*>(out_v), static_cast<int*>(out_i), tiles,
      lrows, words, kk, bn, l2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor cores (block_score_tc.cuh with IvfWork)
// ---------------------------------------------------------------------------

template <typename Op, int BQ>
__global__ void __launch_bounds__(tc::kThreadsTc, 2)
tc_ivf_topk_kernel(const __grid_constant__ CUtensorMap corpus_map, const __grid_constant__ CUtensorMap query_map,
                   const typename Op::Scales scales, const int8_t* __restrict__ row_valid, const tc::IvfWork work,
                   float* __restrict__ out_v, int* __restrict__ out_i, int n, int d, int q, int kk, int bn,
                   int l2) {
  tc::tc_block_topk<Op, BQ, tc::kStages, false, true, false, tc::IvfWork>(
      &corpus_map, &query_map, scales, row_valid, Predicates{}, out_v, out_i, n, d, q, n, kk, bn, l2, work);
}

// float32 on the same ring with fmaf consumers (the F32 operand): the FMA
// loop's sums in the FMA loop's order, so the same scores bit for bit.
template <int BQ>
__global__ void __launch_bounds__(tc::kThreadsTc, tc::ffma_ctas<BQ>())
fma_ring_ivf_topk_kernel(const __grid_constant__ CUtensorMap corpus_map,
                         const __grid_constant__ CUtensorMap query_map, const tc::F32::Scales scales,
                         const int8_t* __restrict__ row_valid, const tc::IvfWork work, float* __restrict__ out_v,
                         int* __restrict__ out_i, int n, int d, int q, int kk, int bn, int l2) {
  tc::tc_block_topk<tc::F32, BQ, tc::ffma_stages<BQ>(), false, true, false, tc::IvfWork>(
      &corpus_map, &query_map, scales, row_valid, Predicates{}, out_v, out_i, n, d, q, n, kk, bn, l2, work);
}

// The query map covers the g_max * BQ rows of qbuf; `q` is the rows whose
// scales the operand reads: the int8 scales of qbuf, none for bf16, whose
// K7 score has no query-norm term.
template <typename Op, int BQ>
cudaError_t run_tc(const void* corpus, const void* qbuf, const typename Op::Scales& scales, int q,
                   const void* row_valid, const tc::IvfWork& work, void* out_v, void* out_i, int n, int d,
                   int g_max, int kk, int bn, int l2, cudaStream_t stream) {
  CUtensorMap corpus_map, query_map;
  if (!tc::make_map<Op>(&corpus_map, corpus, n, d, tc::kRowTile) ||
      !tc::make_map<Op>(&query_map, qbuf, g_max * BQ, d, BQ))
    return cudaErrorInvalidValue;
  size_t smem = tc::smem_bytes<BQ>(tc::kStages);
  if constexpr (Op::kFfma) smem = tc::smem_bytes<BQ>(tc::ffma_stages<BQ>());
  auto kernel = [] {
    if constexpr (Op::kFfma)
      return fma_ring_ivf_topk_kernel<BQ>;
    else
      return tc_ivf_topk_kernel<Op, BQ>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid(g_max, work.tiles);
  kernel<<<grid, tc::kThreadsTc, smem, stream>>>(corpus_map, query_map, scales,
                                                 static_cast<const int8_t*>(row_valid), work,
                                                 static_cast<float*>(out_v), static_cast<int*>(out_i), n, d, q,
                                                 kk, bn, l2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One search over a work list from pse_ivf_work: the gather, then the scan
// on the loop the wrapper chose (ring: the TMA ring, wgmma for bf16 and
// int8, fmaf for float32; else the FMA / __dp4a loop)
// ---------------------------------------------------------------------------

template <typename T> struct Fma { using Word = T; };
template <> struct Fma<int8_t> { using Word = int; };  // int8x4 words

template <typename T>
int run_ivf(const void* corpus, const void* queries, const void* qscales, const void* cscales,
            const void* cnorms, const void* row_valid, const void* sorted, const void* order, void* groups,
            void* qbuf, void* qsbuf, void* out_v, void* out_i, int nlist, int lrows, int d, int q,
            int nprobe, int kk, int bn, int bq, int g_max, int l2, int ring, void* stream) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  auto s = static_cast<cudaStream_t>(stream);
  if ((bq != tc::kSmallBQ && bq != tc::kLargeBQ) || bn < 1 || kk < 1 || kk > bn) return cudaErrorInvalidValue;
  const int p = q * nprobe;
  const int n = nlist * lrows;
  const int tiles = (lrows + bn - 1) / bn;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qbuf) % 16 == 0;
  ivf_gather_kernel<<<g_max, kGatherThreads, 0, s>>>(
      static_cast<const uint8_t*>(queries), static_cast<const float*>(kInt8 ? qscales : nullptr),
      static_cast<const int*>(sorted), static_cast<const long long*>(order), static_cast<const int*>(groups),
      static_cast<uint8_t*>(qbuf), static_cast<float*>(kInt8 ? qsbuf : nullptr), static_cast<float*>(out_v),
      static_cast<int*>(out_i), row_bytes, vec, nprobe, bq, p, (p + g_max - 1) / g_max, nlist, tiles * kk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const tc::IvfWork work{static_cast<const int*>(groups), static_cast<const long long*>(order), lrows, tiles};
  if (ring) {
    using Op = std::conditional_t<kInt8, tc::S8, std::conditional_t<std::is_same<T, float>::value, tc::F32, tc::Bf16>>;
    if (d % (16 / sizeof(T)) != 0 || kk > kListSlots || reinterpret_cast<uintptr_t>(corpus) % 16 ||
        reinterpret_cast<uintptr_t>(qbuf) % 16)
      return cudaErrorInvalidValue;
    typename Op::Scales scales;
    int scaled_rows = 0;
    if constexpr (kInt8) {
      scales = tc::S8::Scales{static_cast<const float*>(qsbuf), static_cast<const float*>(cscales),
                              static_cast<const float*>(cnorms)};
      scaled_rows = g_max * bq;
    } else {  // no query norms: the caller subtracts |q|^2
      scales = typename Op::Scales{nullptr, static_cast<const float*>(cnorms)};
    }
    if (bq == tc::kSmallBQ)
      return run_tc<Op, tc::kSmallBQ>(corpus, qbuf, scales, scaled_rows, row_valid, work, out_v, out_i, n, d,
                                      g_max, kk, bn, l2, s);
    return run_tc<Op, tc::kLargeBQ>(corpus, qbuf, scales, scaled_rows, row_valid, work, out_v, out_i, n, d,
                                    g_max, kk, bn, l2, s);
  }
  using Word = typename Fma<T>::Word;
  const int words = d / static_cast<int>(sizeof(Word) / sizeof(T));
  if (bq == tc::kSmallBQ)
    return run_fma<Word, tc::kSmallBQ>(corpus, qbuf, qsbuf, cscales, cnorms, row_valid, groups, order, out_v,
                                       out_i, g_max, tiles, lrows, words, kk, bn, l2, s);
  return run_fma<Word, tc::kLargeBQ>(corpus, qbuf, qsbuf, cscales, cnorms, row_valid, groups, order, out_v,
                                     out_i, g_max, tiles, lrows, words, kk, bn, l2, s);
}

}  // namespace

// The work list (ops/ivf_scan.ivf_work_list): sorted is the [p] stably
// sorted probe ids (int32), groups [g_max][3] int32.
extern "C" int pse_ivf_work(const void* sorted, void* groups, int p, int nlist, int bq, int g_max,
                            void* stream) {
  ivf_work_kernel<<<1, kWorkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted), p, nlist, bq, g_max, static_cast<int*>(groups));
  return cudaGetLastError();
}

// All three take the same arguments: d is the width in elements; ring
// chooses the loop (ops/ivf_scan.ivf_scoring_loop): the TMA ring, or the
// FMA / __dp4a loop; sorted
// and order are torch.sort's values (int32) and indices (int64) of the
// flattened [q, nprobe] probe ids, and groups ([g_max][3] int32) the work
// list pse_ivf_work cut from them at the same bq; qbuf ([g_max * bq][d],
// the corpus type) and qsbuf ([g_max * bq] float32, int8 only) are scratch
// the call fills; qscales and cscales are read by the int8 entry only,
// cnorms only when l2 != 0.
#define PSE_IVF_ENTRY(name, T)                                                                         \
  extern "C" int name(const void* corpus, const void* queries, const void* qscales, const void* cscales, \
                      const void* cnorms, const void* row_valid, const void* sorted, const void* order,  \
                      void* groups, void* qbuf, void* qsbuf, void* out_v, void* out_i, int nlist,        \
                      int lrows, int d, int q, int nprobe, int kk, int bn, int bq, int g_max, int l2,    \
                      int ring, void* stream) {                                                          \
    return run_ivf<T>(corpus, queries, qscales, cscales, cnorms, row_valid, sorted, order, groups, qbuf, \
                      qsbuf, out_v, out_i, nlist, lrows, d, q, nprobe, kk, bn, bq, g_max, l2, ring,      \
                      stream);                                                                           \
  }

PSE_IVF_ENTRY(pse_ivf_topk_f32, float)
PSE_IVF_ENTRY(pse_ivf_topk_bf16, __nv_bfloat16)
PSE_IVF_ENTRY(pse_ivf_topk_int8, int8_t)
