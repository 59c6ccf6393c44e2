// One fused BFS level step, hand-written for sm_90a: AND + popcount counts
// over the active mask words only, the level's masking rules, and an exact
// top-k in lax.top_k order (values descending, lower column first on ties).
//
// Replaces the TPU kernel src/repro/kernels/level_step.py::level_step_pallas
// (body _level_step_kernel with _masked_counts and _topk_rounds), method
// "fused" of the BFS.
//
//   masks (R, W) uint32; packed (W, V) uint32, the index's own postings;
//   terms (R,) int32; valid (R,) int32; visited (Q, v) int32, row r belongs
//   to query r / rows_per_query.  Out: weights, ids (R, k) int32, k <= v.
//   Columns v..V-1 are padding: they rank below every real column.
//
// The TPU walks the V tiles in order and carries a running top-k between
// grid steps.  Blocks on Hopper run in parallel and carry nothing, so the
// level is three launches:
//   (1) the compaction launch of postings.cu (launched by the wrapper):
//       for each tile of 4 mask rows, the words at which any row is
//       nonzero, and the tile's mask words there staged [word][row];
//   (2) level_tiles: one CTA per (4-row tile, 256 columns), one column per
//       thread, counts over the tile's active words with the loop of
//       active_words.cuh, applies the masks in registers (the row's own
//       term, the visited columns of the row's own query and invalid rows to
//       -1, padding columns >= v to -2), and extracts each row's exact
//       top-kt, kt = min(k, 256), one warp a row, by kt rounds of
//       first-maximum selection.  The candidates go to scratch
//       (R, n_tiles, kt) as int64 keys count * 2^32 + (2^32 - 1 - column):
//       keys are unique per row and their order is the lax.top_k order.
//       The (R, V) count matrix never reaches device memory;
//   (3) level_merge: one CTA per row takes the row's n_tiles * kt keys and
//       extracts the final k the same way.  Every global top-k column is in
//       its tile's top-kt, so the result is exact, values and tie order.
//
// What bounds it on an H100: the popcounts the data needs, as in postings.cu
// (a zero mask word adds nothing).  At the CSL serving frontier (R = 256,
// W = 12,382, V = 65,536) about 4% of the mask words are nonzero; the count
// loop walks only each tile's active words and waits on the gather of their
// packed rows, which is coalesced along V in the index's (W, V) layout.  A
// tile may straddle two queries (rows_per_query need not be a multiple of
// 4): visited is looked up per row.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "active_words.cuh"

namespace {

using active_words::kRows;
constexpr int kThreads = 256;         // columns per CTA of launch 2
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
level_tiles(const uint32_t* __restrict__ staged, const int* __restrict__ words,
            const int* __restrict__ n_active,
            const uint32_t* __restrict__ packed,
            const int32_t* __restrict__ terms, const int32_t* __restrict__ valid,
            const int32_t* __restrict__ visited, long long* __restrict__ scratch,
            int R, int W, int V, int v, int kt, int rows_per_query,
            int dedup) {
  __shared__ active_words::Stage sm;
  __shared__ int scount[kRows][kThreads];
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int v0 = blockIdx.y * kThreads;
  const int c = threadIdx.x, cg = v0 + c;

  int acc[kRows] = {0, 0, 0, 0};
  active_words::count(staged, words, n_active, packed, tile, W, V, cg, sm,
                      acc);

  // masking rules (_masked_counts), in registers
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int rg = r0 + r;
    int x = acc[r];
    if (rg < R && cg < V) {
      if (cg == max(terms[rg], 0)) x = -1;
      if (dedup && cg < v &&
          visited[(long long)(rg / rows_per_query) * v + cg] != 0) x = -1;
      if (valid[rg] == 0) x = -1;
      if (cg >= v) x = -2;
    }
    scount[r][c] = x;
  }
  __syncthreads();

  // per-row exact top-kt: warp r takes row r, eight columns a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = r0 + warp;
  if (warp >= kRows || rg >= R) return;
  long long keys[kThreads / 32];
#pragma unroll
  for (int j = 0; j < kThreads / 32; ++j) {
    const int col = lane + 32 * j;
    keys[j] = v0 + col < V ? make_key(scount[warp][col], v0 + col) : kNone;
  }
  long long prev = LLONG_MAX;
  long long* dst = scratch + ((long long)rg * gridDim.y + blockIdx.y) * kt;
  for (int round = 0; round < kt; ++round) {
    long long best = kNone;
#pragma unroll
    for (int j = 0; j < kThreads / 32; ++j)
      if (keys[j] < prev && keys[j] > best) best = keys[j];
    best = warp_max(best);
    if (lane == 0) dst[round] = best;
    prev = best;
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

// Launches (2) and (3) over the output of postings_compact_launch: staged
// (T, W, 4), words (T, W), n_active (T,), T = ceil(R / 4).  The wrapper
// allocates scratch (R, ceil(V / 256), min(k, 256)) int64.
extern "C" int level_step_launch(const void* staged, const void* words,
                                 const void* n_active, const void* packed,
                                 const void* terms, const void* valid,
                                 const void* visited, void* scratch,
                                 void* w_out, void* i_out, int R, int W, int V,
                                 int v, int k, int rows_per_query, int dedup,
                                 void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  const int n_tiles = (V + kThreads - 1) / kThreads;
  const int kt = k < kThreads ? k : kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((R + kRows - 1) / kRows, n_tiles);
  level_tiles<<<grid, kThreads, 0, s>>>(
      (const uint32_t*)staged, (const int*)words, (const int*)n_active,
      (const uint32_t*)packed, (const int32_t*)terms, (const int32_t*)valid,
      (const int32_t*)visited, (long long*)scratch, R, W, V, v, kt,
      rows_per_query, dedup);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  level_merge<<<R, kThreads, 0, s>>>((const long long*)scratch,
                                          n_tiles * kt, k, (int32_t*)w_out,
                                          (int32_t*)i_out);
  return (int)cudaGetLastError();
}
