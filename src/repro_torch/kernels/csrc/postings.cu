// Bit-packed postings intersection + popcount, hand-written for sm_90a,
// walking only the mask words that are nonzero.
//
//   counts[b, v] = sum_w popc(masks[b, w] & packed[w, v])
//   masks (B, W), packed (W, V): uint32 bit patterns; counts (B, V) int32.
//
// Replaces the TPU kernel src/repro/kernels/postings.py::postings_counts_pallas
// (body _postings_kernel), the count source of method "pallas".
//
// What bounds it on an H100: the popcounts that the data needs.  A zero mask
// word adds nothing, so the work is (nonzero mask words) x V AND+popc+add;
// __popc issues at 16 per clock per SM (CUDA programming guide, compute
// capability 9.0).  At the CSL serving frontier (B = 256, W = 12,382,
// V = 65,536) only about 4% of the mask words are nonzero: every frontier
// row is its parent's mask ANDed with one posting list, so a row's nonzero
// words lie inside its query's seed support.  A kernel that walks all W
// words issues some 29 times the popcounts the data needs.  This one walks
// each tile's nonzero words only, and what it waits on is then the gather
// of those words' packed rows: at the level-0 frontier, one nonzero row a
// query and almost no popcounts, it takes over half its level-1 time
// (chip_smoke.py, phase kernels).
//
// Design: two launches, over tiles of 4 mask rows (kRows).
//   Launch 1 (compaction), one CTA per tile: reads the tile's masks once and
//   writes, in ascending order, the words at which any row of the tile is
//   nonzero (the tile's "active words"), their count, and the tile's mask
//   words at those positions staged [word][row] (rows past B read as zero),
//   so that launch 2 copies them into shared memory in one coalesced pass.
//   Launch 2, one CTA per (tile, 256 columns), one column per thread: walks
//   only its tile's active-word list (the loop of active_words.cuh, which
//   the fused level step shares): each packed[w, v] load is coalesced
//   along V and reused from a register for the tile's 4 rows, and a thread
//   keeps 16 of them in flight: these gathered rows, not the popcounts, are
//   what the kernel waits on.  The tile's staged mask words sit in shared
//   memory [word][row], so the 4 rows come in one 16-byte broadcast load.
//   At 4 rows a tile a listed word's group of four rows is nonzero by
//   construction, so the list is the all-zero group skip.  Row tiles vary
//   fastest in the grid, so the CTAs that share a column tile run together
//   and share packed in L2.
// The kernel is generic: it does not assume that a tile is one query.  The
// height is a measured choice (PERF.md): at the CSL level-1 frontier 4 rows
// beat 8 and 16 on an H100.  A shorter tile tests fewer rows at each active
// word; a taller one shares each gathered packed word among more rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "active_words.cuh"

namespace {

using active_words::kRows;         // mask rows a tile; the wrapper's ROWS
constexpr int kThreads = 256;      // launch 2: columns of V per CTA
constexpr int kCompactThreads = 512;

// Launch 1.  words (T, W) int32: active word indices, ascending, first
// n_active[t] valid; staged (T, W, kRows) uint32: the tile's masks at them.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const uint32_t* __restrict__ masks, int B, int W,
               int* __restrict__ words, int* __restrict__ n_active,
               uint32_t* __restrict__ staged) {
  __shared__ int warp_cnt[kCompactThreads / 32];
  const int tile = blockIdx.x, b0 = tile * kRows;
  const int nr = min(kRows, B - b0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned lt = (1u << lane) - 1u;
  int* wl = words + (long long)tile * W;
  uint4* st = reinterpret_cast<uint4*>(staged + (long long)tile * W * kRows);
  const uint32_t* mb = masks + (long long)b0 * W;
  int base = 0;
  for (int w0 = 0; w0 < W; w0 += kCompactThreads) {
    const int w = w0 + tid;
    uint32_t m[kRows] = {0u, 0u, 0u, 0u};
    if (w < W)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) m[r] = __ldg(mb + (long long)r * W + w);
    const bool active = (m[0] | m[1] | m[2] | m[3]) != 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kCompactThreads / 32; ++i) {
      const int c = warp_cnt[i];
      off += i < warp ? c : 0;
      total += c;
    }
    if (active) {
      const int pos = base + off + __popc(ballot & lt);
      wl[pos] = w;
      st[pos] = make_uint4(m[0], m[1], m[2], m[3]);
    }
    base += total;
    __syncthreads();  // warp_cnt is rewritten by the next chunk
  }
  if (tid == 0) n_active[tile] = base;
}

// Launch 2.
__global__ void __launch_bounds__(kThreads)
sparse_counts_kernel(const uint32_t* __restrict__ staged,
                     const int* __restrict__ words,
                     const int* __restrict__ n_active,
                     const uint32_t* __restrict__ packed,
                     int32_t* __restrict__ out, int B, int W, int V) {
  __shared__ active_words::Stage sm;
  const int tile = blockIdx.x, b0 = tile * kRows;
  const long long v = (long long)blockIdx.y * kThreads + threadIdx.x;
  int acc[kRows] = {0, 0, 0, 0};
  active_words::count(staged, words, n_active, packed, tile, W, V, v, sm, acc);
  if (v < V) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (b0 + r < B) out[(long long)(b0 + r) * V + v] = acc[r];
  }
}

}  // namespace

// Launch 1 alone.  The wrapper allocates words (T, W) int32, n_active (T,)
// int32 and staged (T, W, 4) int32, T = ceil(B / 4).
extern "C" int postings_compact_launch(const void* masks, void* words,
                                       void* n_active, void* staged, int B,
                                       int W, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  compact_kernel<<<(B + kRows - 1) / kRows, kCompactThreads, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)masks, B, W, (int*)words, (int*)n_active,
      (uint32_t*)staged);
  return (int)cudaGetLastError();
}

// Launch 2 over the output of launch 1.
extern "C" int postings_counts_launch(const void* staged, const void* words,
                                      const void* n_active,
                                      const void* packed, void* out, int B,
                                      int W, int V, void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaGetLastError();
  const dim3 grid((B + kRows - 1) / kRows, (V + kThreads - 1) / kThreads);
  sparse_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)staged, (const int*)words, (const int*)n_active,
      (const uint32_t*)packed, (int32_t*)out, B, W, V);
  return (int)cudaGetLastError();
}
