// Bit-packed postings intersection + popcount, hand-written for sm_90a.
//
//   counts[b, v] = sum_w popc(masks[b, w] & packed[w, v])
//   masks (B, W), packed (W, V): uint32 bit patterns; counts (B, V) int32.
//
// Replaces the TPU kernel src/repro/kernels/postings.py::postings_counts_pallas
// (body _postings_kernel), the count source of method "pallas".
//
// What bounds it on an H100: not the bytes.  Each packed word is read once
// per row tile but feeds B popcounts; at the serving batch (B = 256 frontier
// rows, W = 12,382, V = 65,536) that is 2.1e11 AND+popc+add against 3.3 GB
// of operands.  __popc issues at 16 per clock per SM (CUDA programming
// guide, compute capability 9.0), so the integer pipe needs ~50 ms where
// streaming the operands once needs ~1 ms.
//
// Design: one CTA per (32-row tile, 256-column tile), one column per thread,
// so each packed[w, v] load is coalesced along V and reused from a register
// for all 32 rows.  A loop over W stages 64-word chunks of the 32 mask rows
// in shared memory, laid out [w][row] so that four rows come in one 16-byte
// broadcast load.  packed is not staged: every word of it is used by one
// thread only.  Row tiles vary fastest in the grid, so the CTAs that share a
// column tile run together and reread it from L2.  The kernel masks the
// ragged edges of B, W and V itself; the wrapper pads nothing.
// Skipping all-zero mask words and a carry-save popcount are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // columns of V per CTA, one per thread
constexpr int kRows = 32;      // mask rows per CTA: accumulators per thread
constexpr int kWords = 64;     // words of W staged per step
constexpr int kStride = kRows + 4;  // 16-byte aligned rows, 4-way store conflicts

__global__ void __launch_bounds__(kThreads)
postings_kernel(const uint32_t* __restrict__ masks,
                const uint32_t* __restrict__ packed,
                int32_t* __restrict__ out, int B, int W, int V) {
  __shared__ __align__(16) uint32_t sm[kWords * kStride];
  const int b0 = blockIdx.x * kRows;
  const long long v = (long long)blockIdx.y * kThreads + threadIdx.x;
  const bool col_ok = v < V;

  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < W; w0 += kWords) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kRows * kWords; i += kThreads) {
      const int r = i / kWords, w = i % kWords;  // coalesced along a row
      uint32_t m = 0;
      if (b0 + r < B && w0 + w < W) m = masks[(long long)(b0 + r) * W + w0 + w];
      sm[w * kStride + r] = m;
    }
    __syncthreads();
    if (col_ok) {
      const int nw = min(kWords, W - w0);
      const uint32_t* p = packed + (long long)w0 * V + v;
#pragma unroll 4
      for (int w = 0; w < nw; ++w) {
        const uint32_t pw = __ldg(p + (long long)w * V);
        const uint4* m4 = reinterpret_cast<const uint4*>(sm + w * kStride);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const uint4 m = m4[q];
          acc[4 * q + 0] += __popc(m.x & pw);
          acc[4 * q + 1] += __popc(m.y & pw);
          acc[4 * q + 2] += __popc(m.z & pw);
          acc[4 * q + 3] += __popc(m.w & pw);
        }
      }
    }
  }
  if (col_ok) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (b0 + r < B) out[(long long)(b0 + r) * V + v] = acc[r];
  }
}

}  // namespace

extern "C" int postings_counts_launch(const void* masks, const void* packed,
                                      void* out, int B, int W, int V,
                                      void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaGetLastError();
  const dim3 grid((B + kRows - 1) / kRows, (V + kThreads - 1) / kThreads);
  postings_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)packed, (int32_t*)out, B, W, V);
  return (int)cudaGetLastError();
}
