// One fused BFS level step, hand-written for sm_90a: AND + popcount counts
// over the transposed padded postings, the level's masking rules, and an
// exact top-k in lax.top_k order (values descending, lower column first on
// ties).
//
// Replaces the TPU kernel src/repro/kernels/level_step.py::level_step_pallas
// (body _level_step_kernel with _masked_counts and _topk_rounds), method
// "fused" of the BFS.
//
//   masks (R, Wm) uint32, Wm <= W_pad; packed_t_pad (V_pad, W_pad) uint32;
//   terms (R,) int32; valid (R,) int32; visited (Q, v) int32, row r belongs
//   to query r / rows_per_query.  Out: weights, ids (R, k) int32, k <= v.
//
// The TPU walks the V tiles in order and carries a running top-k between
// grid steps.  Blocks on Hopper run in parallel and carry nothing, so the
// level is two launches:
//   (a) level_tiles: one CTA per (32-row tile, 128-column tile) computes
//       the counts, applies the masks (self and visited columns and invalid
//       rows to -1, padding columns >= v to -2) and extracts the tile's
//       exact top-kt, kt = min(k, 128), by kt rounds of first-maximum
//       selection.  The candidates go to scratch (R, n_tiles, kt) as int64
//       keys count * 2^32 + (2^32 - 1 - column): keys are unique per row and
//       their order is the lax.top_k order.  The (R, V) count matrix never
//       reaches device memory.
//   (b) level_merge: one CTA per row takes the row's n_tiles * kt keys and
//       extracts the final k the same way.  Every global top-k column is in
//       its tile's top-kt, so the result is exact, values and tie order.
//
// What bounds it on an H100: the integer pipe, as in postings.cu.  At the
// serving batch (R = 256 rows, W = 12,382, V_pad = 65,536) the counts are
// 2.1e11 AND+popc+add: ~50 ms at 16 __popc per clock per SM, against ~1 ms
// to stream packed_t_pad once.  Design: packed_t_pad is row-major along W,
// so a thread-per-column read would be strided; each CTA instead loads a
// (128 columns x 32 words) tile with coalesced row reads into shared memory
// (row stride 33, so the per-column reads are conflict-free) and a
// (32 words x 32 rows) chunk of the masks laid out [w][row] for 16-byte
// broadcast loads.  Two threads share a column, 16 rows each.  Row tiles
// vary fastest in the grid so CTAs sharing a column tile reread it from L2.
// Skipping all-zero mask words is later work.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 128;          // columns per CTA
constexpr int kTileR = 32;           // frontier rows per CTA
constexpr int kRowsPerThread = 16;   // kThreads / kTileV threads share a column
constexpr int kWords = 32;           // words of W staged per step
constexpr int kMaskStride = kTileR + 4;
constexpr int kPtStride = kWords + 1;
constexpr int kCountStride = kTileV + 1;
constexpr long long kNone = LLONG_MIN;  // "no candidate"

__device__ __forceinline__ long long make_key(int count, int col) {
  return (long long)count * 4294967296LL + (long long)(0xFFFFFFFFu - (uint32_t)col);
}

__device__ __forceinline__ long long warp_max(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_xor_sync(0xFFFFFFFFu, x, off);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
level_tiles(const uint32_t* __restrict__ masks, const uint32_t* __restrict__ pt,
            const int32_t* __restrict__ terms, const int32_t* __restrict__ valid,
            const int32_t* __restrict__ visited, long long* __restrict__ scratch,
            int R, int Wm, int Wp, int Vp, int v, int kt, int rows_per_query,
            int dedup) {
  __shared__ __align__(16) uint32_t smask[kWords * kMaskStride];
  __shared__ uint32_t spt[kTileV * kPtStride];
  __shared__ int scount[kTileR * kCountStride];

  const int r0 = blockIdx.x * kTileR;
  const int tile = blockIdx.y;
  const int v0 = tile * kTileV;
  const int tid = threadIdx.x;
  const int col = tid % kTileV;
  const int half = tid / kTileV;

  int acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0;

  for (int w0 = 0; w0 < Wm; w0 += kWords) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kTileR * kWords; i += kThreads) {
      const int r = i / kWords, w = i % kWords;
      uint32_t m = 0;
      if (r0 + r < R && w0 + w < Wm) m = masks[(long long)(r0 + r) * Wm + w0 + w];
      smask[w * kMaskStride + r] = m;
    }
    for (int i = tid; i < kTileV * kWords; i += kThreads) {
      const int c = i / kWords, w = i % kWords;
      uint32_t p = 0;
      if (v0 + c < Vp && w0 + w < Wm) p = pt[(long long)(v0 + c) * Wp + w0 + w];
      spt[c * kPtStride + w] = p;
    }
    __syncthreads();
    const int nw = min(kWords, Wm - w0);
    const uint32_t* prow = spt + col * kPtStride;
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      const uint32_t pw = prow[w];
      const uint4* m4 = reinterpret_cast<const uint4*>(
          smask + w * kMaskStride + half * kRowsPerThread);
#pragma unroll
      for (int q = 0; q < kRowsPerThread / 4; ++q) {
        const uint4 m = m4[q];
        acc[4 * q + 0] += __popc(m.x & pw);
        acc[4 * q + 1] += __popc(m.y & pw);
        acc[4 * q + 2] += __popc(m.z & pw);
        acc[4 * q + 3] += __popc(m.w & pw);
      }
    }
  }

  // masking rules (_masked_counts), into shared memory
  const int cg = v0 + col;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = half * kRowsPerThread + j;
    const int rg = r0 + r;
    int c = acc[j];
    if (rg < R && cg < Vp) {
      const int t = max(terms[rg], 0);
      if (cg == t) c = -1;
      if (dedup && cg < v &&
          visited[(long long)(rg / rows_per_query) * v + cg] != 0) c = -1;
      if (valid[rg] == 0) c = -1;
      if (cg >= v) c = -2;
    }
    scount[r * kCountStride + col] = c;
  }
  __syncthreads();

  // per-tile exact top-kt: one warp per row, four columns per lane
  const int warp = tid / 32, lane = tid % 32;
  const int n_tiles = gridDim.y;
  for (int r = warp; r < kTileR; r += kThreads / 32) {
    const int rg = r0 + r;
    if (rg >= R) break;
    long long keys[kTileV / 32];
#pragma unroll
    for (int j = 0; j < kTileV / 32; ++j) {
      const int c = lane + 32 * j;
      keys[j] = (v0 + c < Vp) ? make_key(scount[r * kCountStride + c], v0 + c)
                              : kNone;
    }
    long long prev = LLONG_MAX;
    long long* dst = scratch + ((long long)rg * n_tiles + tile) * kt;
    for (int round = 0; round < kt; ++round) {
      long long best = kNone;
#pragma unroll
      for (int j = 0; j < kTileV / 32; ++j)
        if (keys[j] < prev && keys[j] > best) best = keys[j];
      best = warp_max(best);
      if (lane == 0) dst[round] = best;
      prev = best;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
level_merge(const long long* __restrict__ scratch, int n_cand, int k,
            int32_t* __restrict__ w_out, int32_t* __restrict__ i_out) {
  __shared__ long long partial[2][kThreads / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long* cand = scratch + (long long)row * n_cand;
  long long prev = LLONG_MAX;
  for (int round = 0; round < k; ++round) {
    long long best = kNone;
    for (int i = tid; i < n_cand; i += kThreads) {
      const long long key = cand[i];
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) partial[round & 1][warp] = best;
    __syncthreads();
    best = partial[round & 1][0];
#pragma unroll
    for (int j = 1; j < kThreads / 32; ++j) {
      const long long x = partial[round & 1][j];
      best = x > best ? x : best;
    }
    if (tid == 0) {
      const long long count = best >> 32;  // arithmetic: counts may be < 0
      w_out[(long long)row * k + round] = (int32_t)count;
      i_out[(long long)row * k + round] =
          (int32_t)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFLL));
    }
    prev = best;
  }
}

}  // namespace

extern "C" int level_step_launch(const void* masks, const void* packed_t_pad,
                                 const void* terms, const void* valid,
                                 const void* visited, void* scratch,
                                 void* w_out, void* i_out, int R, int Wm,
                                 int Wp, int Vp, int v, int k,
                                 int rows_per_query, int dedup, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const int n_tiles = (Vp + kTileV - 1) / kTileV;
  const int kt = k < kTileV ? k : kTileV;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((R + kTileR - 1) / kTileR, n_tiles);
  level_tiles<<<grid, kThreads, 0, s>>>(
      (const uint32_t*)masks, (const uint32_t*)packed_t_pad,
      (const int32_t*)terms, (const int32_t*)valid, (const int32_t*)visited,
      (long long*)scratch, R, Wm, Wp, Vp, v, kt, rows_per_query, dedup);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  level_merge<<<R, kThreads, 0, s>>>((const long long*)scratch, n_tiles * kt,
                                     k, (int32_t*)w_out, (int32_t*)i_out);
  return (int)cudaGetLastError();
}
