// Co-occurrence counts over the 0/1 incidence, int8 tensor cores, sm_90a.
//
//   C[m, n] = sum_k A[m, k] * B[n, k]        (int32 accumulation)
//   A (M, K) int8, row m at A + m * lda; B (N, K) int8, row n at B + n * ldb;
//   C (M, N) int32, row-major.  K, the document axis, is contiguous in both.
//
// This is x_l^T @ x_r of the reference with x_l = A^T and x_r = B^T: A is a
// row block's unpacked filter masks, B the term-major dense incidence
// (QueryContext.x_dense's storage).  Counts of 0/1 operands are exact in
// int32 for any K < 2^31.
//
// Replaces the TPU kernel src/repro/kernels/cooccur.py:36
// (cooccur_gemm_pallas, body _cooccur_kernel), the count source of
// materialize(method="pallas").  The TPU kernel carried its output block
// across a sequential K grid axis; here each CTA owns one 128 x 128 output
// tile and walks all of K itself, so there is no split-K, no atomic and the
// result is deterministic.
//
// What bounds it on an H100: bytes.  At the CSL row block (M = 128 terms,
// N = 65,536 terms, K = 396,224 doc slots) one launch streams the 26 GB
// incidence once: 7.8 ms at 3.35 TB/s, against 3.4 ms for its 6.65e12
// int8 operations at 1,979 TOP/s.
//
// Design: 8 warps in a 2 x 4 layout, each owning a 64 x 32 sub-tile as
// 4 x 4 mma.sync.m16n8k32 int8 tiles (64 int32 accumulators a thread).  A
// and B tiles of 128 rows x 64 bytes of K go through a 4-stage cp.async
// ring in shared memory (16-byte copies; an 80-byte row pitch makes every
// 32-bit fragment load conflict-free).  The ragged M, N and K edges are
// zero-filled by the copies (cp.async's src-size operand), so the caller
// pads nothing.  Operands whose rows are not 16-byte aligned (odd K or
// leading dimensions) take a byte-load path into the same ring.  N tiles
// vary slowest, so CTAs that share a B tile run together.
//
// What a later redesign would change: every CTA rereads all of A from L2
// (at the CSL block A is 51 MB and 512 CTAs read it); wgmma with TMA loads,
// a larger M per launch (more row blocks share one pass over B) and a
// fused per-row top-k (no (M, N) count write) are the next steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // output rows per CTA
constexpr int kBN = 128;               // output columns per CTA
constexpr int kBK = 64;                // bytes of K per stage
constexpr int kStages = 4;
constexpr int kPitch = kBK + 16;       // smem row pitch in bytes
constexpr int kThreads = 256;          // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16;       // m16 tiles per warp
constexpr int kNT = kWarpN / 8;        // n8 tiles per warp
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kSmemBytes = kStages * kStageBytes;   // 81,920

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + 128) x K bytes [k0, k0 + 64) of g into s;
// bytes outside (rows, K) read as zero.
template <bool kVec>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          long long ld, int rows, int row0,
                                          int K, int k0) {
  if (kVec) {
    for (int i = threadIdx.x; i < kBM * (kBK / 16); i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const int gr = row0 + r, gk = k0 + c;
      const int8_t* src = g;            // a valid address for empty copies
      int n = 0;
      if (gr < rows && gk < K) {
        n = min(16, K - gk);
        src = g + (long long)gr * ld + gk;
      }
      cp_async16(s + r * kPitch + c, src, n);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gk = k0 + c;
      s[r * kPitch + c] =
          (gr < rows && gk < K) ? g[(long long)gr * ld + gk] : (int8_t)0;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
cooccur_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int32_t* __restrict__ C, int M, int N, int K, long long lda,
               long long ldb) {
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * kWarpM;  // 0 or 64
  const int wn = (warp & 3) * kWarpN;   // 0, 32, 64, 96
  const int g = lane >> 2, t = lane & 3;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      int8_t* st = smem + s * kStageBytes;
      load_tile<kVec>(st, A, lda, M, m0, K, s * kBK);
      load_tile<kVec>(st + kBM * kPitch, B, ldb, N, n0, K, s * kBK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // ... and stage kt-1 is consumed
    const int pf = kt + kStages - 1;
    if (pf < nk) {
      int8_t* st = smem + (pf % kStages) * kStageBytes;
      load_tile<kVec>(st, A, lda, M, m0, K, pf * kBK);
      load_tile<kVec>(st + kBM * kPitch, B, ldb, N, n0, K, pf * kBK);
    }
    cp_async_commit();

    const int8_t* sA = smem + (kt % kStages) * kStageBytes;
    const int8_t* sB = sA + kBM * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = sA + (wm + i * 16 + g) * kPitch + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = sB + (wn + j * 8 + g) * kPitch + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        int32_t* out = C + (long long)row * N + col;
        if (col < N) out[0] = acc[i][j][2 * h];
        if (col + 1 < N) out[1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <bool kVec>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           long long lda, long long ldb, cudaStream_t stream) {
  // shared memory above 48 KB is an opt-in of the function, per device
  const cudaError_t e = cudaFuncSetAttribute(
      cooccur_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cooccur_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)c, M, N, K, lda, ldb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cooccur_counts_launch(const void* a, const void* b, void* c,
                                     int M, int N, int K, long long lda,
                                     long long ldb, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0) {  // an empty sum: all counts are zero
    cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t),
                    (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  const bool vec = lda % 16 == 0 && ldb % 16 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  return vec ? launch<true>(a, b, c, M, N, K, lda, ldb, (cudaStream_t)stream)
             : launch<false>(a, b, c, M, N, K, lda, ldb,
                             (cudaStream_t)stream);
}
