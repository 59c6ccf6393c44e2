// DLRM dot interaction, hand-written for sm_90a.
//
//   out[b, p(i, j)] = sum_e x[b, i, e] * x[b, j, e]   for F > i > j >= 0,
//   p(i, j) = i (i - 1) / 2 + j  (the strict lower triangle, row-major)
//   x (B, F, E) fp32 or bf16, contiguous; out (B, F (F - 1) / 2) in x's
//   type; sums in fp32.  F <= 64, E <= 256.
//
// Replaces the TPU kernel src/repro/kernels/dot_interaction.py:32
// (dot_interaction_pallas, body _dot_interaction_kernel), the interaction
// of dlrm_logits.  The TPU kernel formed each batch tile's (F, F) Gram on
// the matrix unit and gathered the triangle in its epilogue; here the
// triangle is computed directly and the Gram never exists.
//
// What bounds it on an H100: bytes.  At dlrm-rm2 (F = 27, E = 64, fp32) a
// sample is 6,912 bytes in and 1,404 bytes out for 22,464 FMAs, about 2.7
// FMAs a byte, far below the card's fp32 ridge of about 10.  Tensor cores
// would not help, and TF32 would break the reference's 1e-5 tolerance.
//
// Design: a CTA of 256 threads takes kSB (8) consecutive samples, whose
// input is one contiguous run of global memory, and stages it in shared
// memory as fp32 with coalesced 16-byte loads (bf16 is converted on load).
// The triangle is cut into 4 x 4 tiles of (i, j) (28 of them at F = 27,
// diagonal tiles included); a thread owns one tile of one sample and keeps
// its 16 sums in registers, reading 8 float4 values for every 64 FMAs.
// The 8 threads of each quarter-warp own the same tile of 8 different
// samples, and a sample's pitch in shared memory is an odd number of
// 16-byte units, so every float4 read of a quarter-warp hits 8 distinct
// bank groups.  Results go to a shared-memory copy of the CTA's output
// rows, which are one contiguous run of global memory, and leave in one
// coalesced pass.  Shapes whose rows are not whole 16-byte units take a
// scalar load path into the same layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSB = 8;                   // samples per CTA
constexpr int kSmemBudget = 200 * 1024;     // bytes of shared memory a CTA may take

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

struct Shape {
  int B, F, E;
  int Epad;        // E rounded up to 4 (float4 rows)
  int Fpad;        // F rounded up to 4 (whole tiles)
  int SPw;         // a sample's pitch in shared memory, in floats (odd x 4)
  int P;           // pairs per sample
  int nbi;         // 4-row blocks
  int ntiles;      // lower-triangle tiles, diagonal included
  int SB;          // samples per CTA
  int vec;         // 1: rows are whole 16-byte units
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out,
                       Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                               // SB x SPw
  float* os = smem + sh.SB * sh.SPw;              // SB x P

  const long long s0 = (long long)blockIdx.x * sh.SB;
  const int n = (int)min((long long)sh.SB, (long long)sh.B - s0);
  const int F = sh.F, E = sh.E;
  const T* xb = x + s0 * F * E;

  // stage: n samples, one contiguous run of n * F * E elements
  constexpr int kVec = 16 / sizeof(T);
  if (sh.vec) {
    const int cpr = E / kVec;                     // 16-byte chunks a row
    const int chunks = n * F * cpr;
    for (int u = threadIdx.x; u < chunks; u += kThreads) {
      const int row = u / cpr, c = u - row * cpr;
      const int s = row / F, r = row - s * F;
      const uint4 raw = reinterpret_cast<const uint4*>(xb)[u];
      const T* v = reinterpret_cast<const T*>(&raw);
      float* dst = xs + s * sh.SPw + r * sh.Epad + c * kVec;
#pragma unroll
      for (int q = 0; q < kVec; ++q) dst[q] = to_f32(v[q]);
    }
  } else {
    const int elems = n * F * E;
    for (int u = threadIdx.x; u < elems; u += kThreads) {
      const int row = u / E, e = u - row * E;
      const int s = row / F, r = row - s * F;
      xs[s * sh.SPw + r * sh.Epad + e] = to_f32(xb[u]);
    }
    // zero the pad columns [E, Epad) of every real row
    const int padc = sh.Epad - E;
    for (int u = threadIdx.x; u < n * F * padc; u += kThreads) {
      const int row = u / padc, e = E + (u - row * padc);
      const int s = row / F, r = row - s * F;
      xs[s * sh.SPw + r * sh.Epad + e] = 0.f;
    }
  }
  __syncthreads();

  // compute: thread -> (sample s, tile slot), slots stride over the tiles
  const int s = threadIdx.x % sh.SB;
  const int slots = kThreads / sh.SB;
  if (s < n && threadIdx.x < slots * sh.SB) {
    const float* xsamp = xs + s * sh.SPw;
    float* osamp = os + s * sh.P;
    for (int t = threadIdx.x / sh.SB; t < sh.ntiles; t += slots) {
      int ib = 0;
      while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
      const int jb = t - ib * (ib + 1) / 2;
      const float4* a = reinterpret_cast<const float4*>(xsamp + 4 * ib * sh.Epad);
      const float4* b = reinterpret_cast<const float4*>(xsamp + 4 * jb * sh.Epad);
      const int rs = sh.Epad / 4;                 // a row, in float4
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k][l] = 0.f;
      for (int c = 0; c < rs; ++c) {
        float4 av[4], bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          av[k] = a[k * rs + c];
          bv[k] = b[k * rs + c];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            acc[k][l] = fmaf(av[k].x, bv[l].x, acc[k][l]);
            acc[k][l] = fmaf(av[k].y, bv[l].y, acc[k][l]);
            acc[k][l] = fmaf(av[k].z, bv[l].z, acc[k][l]);
            acc[k][l] = fmaf(av[k].w, bv[l].w, acc[k][l]);
          }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * ib + k;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int j = 4 * jb + l;
          if (i < F && j < i) osamp[i * (i - 1) / 2 + j] = acc[k][l];
        }
      }
    }
  }
  __syncthreads();

  // the CTA's n output rows are one contiguous run of n * P elements
  T* ob = out + s0 * sh.P;
  for (int u = threadIdx.x; u < n * sh.P; u += kThreads) from_f32(os[u], ob + u);
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int E, void* stream) {
  Shape sh;
  sh.B = B;
  sh.F = F;
  sh.E = E;
  sh.Epad = (E + 3) / 4 * 4;
  sh.nbi = (F + 3) / 4;
  sh.Fpad = 4 * sh.nbi;
  sh.P = F * (F - 1) / 2;
  sh.ntiles = sh.nbi * (sh.nbi + 1) / 2;
  sh.SPw = sh.Fpad * sh.Epad;
  if ((sh.SPw / 4) % 2 == 0) sh.SPw += 4;       // odd pitch in 16-byte units
  sh.vec = (E * (int)sizeof(T)) % 16 == 0 &&
           (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int per_sample = (sh.SPw + sh.P) * (int)sizeof(float);
  sh.SB = kMaxSB;
  while (sh.SB > 1 && sh.SB * per_sample > kSmemBudget) --sh.SB;
  const int smem = sh.SB * per_sample;
  cudaError_t err = cudaFuncSetAttribute(
      dot_interaction_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)B + sh.SB - 1) / sh.SB;
  dot_interaction_kernel<T><<<(unsigned)blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  The wrapper checks F <= 64, E <= 256, F >= 2,
// contiguity and the dtype; B may be anything >= 1.
extern "C" int dot_interaction_launch(const void* x, void* out, int B, int F,
                                      int E, int dtype, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (dtype == 0) return launch<float>(x, out, B, F, E, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, B, F, E, stream);
  return (int)cudaErrorInvalidValue;
}
