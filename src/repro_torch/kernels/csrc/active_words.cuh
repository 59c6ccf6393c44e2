// The count loop over one row tile's active mask words, shared by the
// postings kernel (postings.cu) and the fused level step (level_step.cu).
//
// A tile is kRows consecutive mask rows.  The compaction launch of
// postings.cu lists, for each tile t, the words at which any of its rows is
// nonzero, ascending (words[t, :n_active[t]]), and stages the tile's mask
// words there [word][row] (staged[t, j, r]), so that the count loop copies
// them into shared memory in one coalesced pass.  The count loop, one column
// of packed (W, V) per thread, walks only those words: each packed[w, v]
// load is coalesced along V and reused from a register for the tile's rows,
// and a thread keeps kBatch of them in flight, since the gather of packed
// rows, not the popcounts, is what it waits on.
#pragma once

#include <stdint.h>

namespace active_words {

constexpr int kRows = 4;     // mask rows a tile; postings.ROWS in Python
constexpr int kWords = 64;   // active words staged in shared memory per step
constexpr int kBatch = 16;   // packed loads in flight per thread

// Shared memory of the count loop, declared by the calling kernel.
struct Stage {
  uint4 masks[kWords];
  int words[kWords];
};

// acc[r] += sum over the tile's active words w of
// popc(masks[tile * kRows + r, w] & packed[w, v]).  Every thread of the CTA
// calls it (it synchronises the CTA); a thread whose column v >= V adds
// nothing.
__device__ __forceinline__ void count(const uint32_t* __restrict__ staged,
                                      const int* __restrict__ words,
                                      const int* __restrict__ n_active,
                                      const uint32_t* __restrict__ packed,
                                      int tile, int W, int V, long long v,
                                      Stage& sm, int (&acc)[kRows]) {
  const bool col_ok = v < V;
  const int n = n_active[tile];
  const uint4* st4 =
      reinterpret_cast<const uint4*>(staged + (long long)tile * W * kRows);
  const int* wl = words + (long long)tile * W;
  for (int j0 = 0; j0 < n; j0 += kWords) {
    const int nw = min(kWords, n - j0);
    __syncthreads();  // the previous chunk is consumed
    // words past nw read as zero, so the last batch adds nothing for them
    if (threadIdx.x < kWords)
      sm.masks[threadIdx.x] = threadIdx.x < nw ? st4[j0 + threadIdx.x]
                                               : make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < nw) sm.words[threadIdx.x] = wl[j0 + threadIdx.x];
    __syncthreads();
    if (col_ok) {
      for (int jb = 0; jb < nw; jb += kBatch) {
        // kBatch independent loads in flight before any is used
        uint32_t pw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          pw[u] = jb + u < nw
                      ? __ldg(packed + (long long)sm.words[jb + u] * V + v)
                      : 0u;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const uint4 m = sm.masks[jb + u];
          acc[0] += __popc(m.x & pw[u]);
          acc[1] += __popc(m.y & pw[u]);
          acc[2] += __popc(m.z & pw[u]);
          acc[3] += __popc(m.w & pw[u]);
        }
      }
    }
  }
}

}  // namespace active_words
