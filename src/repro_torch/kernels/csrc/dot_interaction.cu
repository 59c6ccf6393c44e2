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
// Design.  The launch plan (groups, samples a group at most, consumer
// warps, ring stages, grid) comes from the launcher
// (kernels/dot_interaction.py::launch_plan).  B is cut into `groups` runs
// of consecutive samples, as even as can be (the first B mod groups take
// one sample more).  At small B there is one
// group a SM and one CTA a group, so the batch goes in one wave with at
// most one sample a warp scheduler; at large B a persistent grid of a few
// CTAs an SM walks the groups.
//
//   Load.  A sample is F rows of E values, one contiguous run of global
//   memory.  It lands in shared memory in 4-row blocks, rows at their own
//   pitch, with 16 bytes of skew after each block.  On the bulk path (x
//   16-byte aligned, rows whole 16-byte units) a producer warp fetches each
//   block with one cp.async.bulk copy that completes on the stage's "full"
//   mbarrier, into a ring of up to 3 stages; the consumer warps release a
//   stage on its "empty" mbarrier, so group g + 1 arrives while group g is
//   computed.  Other shapes take the plain path: each consumer warp loads
//   its own samples with ordinary loads into the same layout, zero-filling
//   the columns past E.  bf16 lands raw and is converted as it is read.
//
//   Compute.  A warp takes one sample (several where the triangle has
//   fewer than 17 tiles); its lanes own 4 x 4 tiles of (i, j) (28 at
//   F = 27, diagonal tiles included) and keep 16 fp32 sums in registers,
//   reading 8 16-byte words for every 64 FMAs (128 for bf16).  At each
//   read the lanes that share a row block read the same word (a
//   broadcast), and the skew puts the blocks' words in distinct bank
//   groups, so a warp's read costs one shared-memory wavefront.
//
//   Store.  Each warp stages its samples' triangles in its own slice of
//   shared memory and writes them out in one coalesced pass: a sample's
//   output row is one contiguous run of global memory.
//
// The host sets the function's shared-memory limit once per device, not per
// launch, and returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxConsumers = 8;            // consumer warps a CTA
constexpr int kMaxStages = 3;               // ring depth of the bulk path
constexpr int kSmemMax = 232448;            // dynamic shared memory a CTA may take
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// a 16-byte word of shared memory as fp32 values: 4 fp32 or 8 bf16
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* v) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 4) {
      v[q] = __uint_as_float(u[q]);
    } else {
      v[2 * q] = __uint_as_float(u[q] << 16);
      v[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct Shape {
  int B, F, E, P;
  int nb;          // 4-row blocks a sample
  int ntiles;      // 4 x 4 tiles of the triangle, diagonal included
  int lanes;       // lanes a sample (a power of 2, at most 32)
  int ec;          // 16-byte words a row in shared memory
  int rp;          // row pitch in shared memory, bytes (16 ec)
  int bp;          // block pitch: 4 rows and 16 bytes of skew
  int sp;          // sample pitch: an odd number of 16-byte words
  int sb;          // samples a group at most
  int warps;       // consumer warps
  int stages;      // stages of the ring (1 on the plain path)
  int ngroups;     // groups g < rem take quot + 1 samples, the rest quot
  int quot, rem;
  int stage_bytes, os_off, bar_off, smem;
};

Shape make_shape(int B, int F, int E, int elem, int sb, int warps,
                 int stages, int ngroups) {
  Shape s;
  s.B = B;
  s.F = F;
  s.E = E;
  s.P = F * (F - 1) / 2;
  s.nb = (F + 3) / 4;
  s.ntiles = s.nb * (s.nb + 1) / 2;
  s.lanes = 1;
  while (s.lanes < s.ntiles && s.lanes < 32) s.lanes *= 2;
  s.ec = (E * elem + 15) / 16;
  s.rp = 16 * s.ec;
  s.bp = 4 * s.rp + 16;
  s.sp = s.nb * s.bp;
  if ((s.sp / 16) % 2 == 0) s.sp += 16;
  s.sb = sb;
  s.warps = warps;
  s.stages = stages;
  s.ngroups = ngroups;
  s.quot = B / ngroups;
  s.rem = B % ngroups;
  s.stage_bytes = sb * s.sp;
  s.os_off = stages * s.stage_bytes;
  s.bar_off = (s.os_off + sb * s.P * 4 + 15) / 16 * 16;
  s.smem = s.bar_off + 2 * stages * 8;
  return s;
}

// the first sample of group g
__device__ __forceinline__ long long group_start(int g, const Shape& sh) {
  return (long long)g * sh.quot + min(g, sh.rem);
}

// The rows of `n` samples starting at sample `s0`, loaded by one warp into
// the slots from `first` on, pad columns zeroed (the plain path).
template <typename T>
__device__ void plain_load(const T* __restrict__ x, unsigned char* stage,
                           long long s0, int n, int first, const Shape& sh,
                           int lane) {
  const int fe = sh.F * sh.E;
  const T* src = x + s0 * fe;
  for (int u = lane; u < n * fe; u += 32) {
    const int s = u / fe, rem = u - s * fe;
    const int r = rem / sh.E, e = rem - r * sh.E;
    T* dst = reinterpret_cast<T*>(stage + (first + s) * sh.sp +
                                  (r >> 2) * sh.bp + (r & 3) * sh.rp);
    dst[e] = src[u];
  }
  const int padc = sh.rp / (int)sizeof(T) - sh.E;
  for (int u = lane; u < n * sh.F * padc; u += 32) {
    const int row = u / padc, e = sh.E + (u - row * padc);
    const int s = row / sh.F, r = row - s * sh.F;
    T* dst = reinterpret_cast<T*>(stage + (first + s) * sh.sp +
                                  (r >> 2) * sh.bp + (r & 3) * sh.rp);
    dst[e] = T(0.f);
  }
}

// One lane's tile t of the sample at `sbase`: its 16 sums, the valid ones
// written to the sample's triangle `os`.
template <typename T>
__device__ __forceinline__ void tile(const unsigned char* sbase, int t,
                                     const Shape& sh, float* os) {
  constexpr int kV = 16 / sizeof(T);          // values a 16-byte word
  int ib = 0;
  while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
  const int jb = t - ib * (ib + 1) / 2;
  const unsigned char* pa = sbase + ib * sh.bp;
  const unsigned char* pb = sbase + jb * sh.bp;
  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[k][l] = 0.f;
#pragma unroll 2
  for (int c = 0; c < sh.ec; ++c) {
    float a[4][kV], b[4][kV];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unpack<T>(*reinterpret_cast<const uint4*>(pa + k * sh.rp + 16 * c),
                a[k]);
      unpack<T>(*reinterpret_cast<const uint4*>(pb + k * sh.rp + 16 * c),
                b[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int q = 0; q < kV; ++q)
          acc[k][l] = fmaf(a[k][q], b[l][q], acc[k][l]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * ib + k;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int j = 4 * jb + l;
      if (i < sh.F && j < i) os[i * (i - 1) / 2 + j] = acc[k][l];
    }
  }
}

template <typename T, bool kBulk>
__global__ void __launch_bounds__(32 * (kMaxConsumers + 1))
dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out,
                       Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* os_all = reinterpret_cast<float*>(smem + sh.os_off);
  const uint32_t bars = smem_u32(smem + sh.bar_off);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (sh.stages + st); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (kBulk) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < sh.stages; ++st) {
        mbar_init(full(st), 1);
        mbar_init(empty(st), sh.warps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == sh.warps) {                       // the producer warp
      int it = 0;
      for (int g = blockIdx.x; g < sh.ngroups; g += gridDim.x, ++it) {
        const int st = it % sh.stages;
        if (it >= sh.stages) mbar_wait(empty(st), (it / sh.stages - 1) & 1);
        const long long s0 = group_start(g, sh);
        const int n = (int)(group_start(g + 1, sh) - s0);
        if (lane == 0) mbar_expect_tx(full(st), n * sh.F * sh.rp);
        __syncwarp();
        unsigned char* stage = smem + st * sh.stage_bytes;
        for (int q = lane; q < n * sh.nb; q += 32) {
          const int s = q / sh.nb, k = q - s * sh.nb;
          const int rows = min(4, sh.F - 4 * k);
          bulk_copy(smem_u32(stage + s * sh.sp + k * sh.bp),
                    x + ((s0 + s) * sh.F + 4 * k) * sh.E, rows * sh.rp,
                    full(st));
        }
      }
      return;
    }
  }

  const int spw = 32 / sh.lanes;                  // samples a warp
  const int first = warp * spw;                   // the warp's first slot
  const int sl = lane / sh.lanes, slot = lane % sh.lanes;
  float* os = os_all + first * sh.P;
  int it = 0;
  for (int g = blockIdx.x; g < sh.ngroups; g += gridDim.x, ++it) {
    const int st = kBulk ? it % sh.stages : 0;
    const long long s0 = group_start(g, sh);
    const int n = (int)(group_start(g + 1, sh) - s0);
    const int mine = max(0, min(spw, n - first));
    unsigned char* stage = smem + st * sh.stage_bytes;
    if (kBulk) {
      mbar_wait(full(st), (it / sh.stages) & 1);
    } else {
      plain_load(x, stage, s0 + first, mine, first, sh, lane);
      __syncwarp();
    }
    if (sl < mine) {
      const unsigned char* sbase = stage + (first + sl) * sh.sp;
      for (int t = slot; t < sh.ntiles; t += sh.lanes)
        tile<T>(sbase, t, sh, os + sl * sh.P);
    }
    __syncwarp();
    if (kBulk && lane == 0) mbar_arrive(empty(st));
    T* ob = out + (s0 + first) * sh.P;
    for (int u = lane; u < mine * sh.P; u += 32) from_f32(os[u], ob + u);
    __syncwarp();
  }
}

template <typename T, bool kBulk>
int launch(const void* x, void* out, const Shape& sh, int grid, int dev,
           cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(dot_interaction_kernel<T, kBulk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int threads = 32 * (sh.warps + (kBulk ? 1 : 0));
  dot_interaction_kernel<T, kBulk><<<grid, threads, sh.smem, stream>>>(
      (const T*)x, (T*)out, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// The launcher's plan (kernels/dot_interaction.py::launch_plan).
struct Plan {
  int B, F, E;
  int dtype;       // 0 = fp32, 1 = bf16
  int samples, warps, stages, grid, groups;
  int bulk;        // 1: bulk copies, 0: the plain load path
};

// Launches on `stream` of device `device` (made current for the launch if
// it is not).  The wrapper checks F <= 64, E <= 256, F >= 2, contiguity
// and the dtype, and chooses the bulk path only where x is 16-byte aligned
// and a row is whole 16-byte words.  Returns cudaErrorInvalidValue for a
// plan the kernel cannot run, else cudaGetLastError() after the launch.
extern "C" int dot_interaction_launch(const void* x, void* out,
                                      const Plan* p, int device,
                                      void* stream) {
  if (p->B <= 0) return (int)cudaGetLastError();
  if (p->dtype != 0 && p->dtype != 1) return (int)cudaErrorInvalidValue;
  const int elem = p->dtype == 0 ? 4 : 2;
  const int stages = p->bulk ? p->stages : 1;
  Shape sh = make_shape(p->B, p->F, p->E, elem, p->samples, p->warps, stages,
                        p->groups);
  if (p->warps < 1 || p->warps > kMaxConsumers || stages < 1 ||
      stages > kMaxStages || p->samples < 1 ||
      p->samples > p->warps * (32 / sh.lanes) || p->grid < 1 ||
      p->groups < 1 || p->groups > p->B || p->grid > p->groups ||
      ((long long)p->B + p->groups - 1) / p->groups > p->samples ||
      sh.smem > kSmemMax || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (p->bulk && (p->E * elem % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (p->dtype == 0)
    rc = p->bulk ? launch<float, true>(x, out, sh, p->grid, device, s)
                 : launch<float, false>(x, out, sh, p->grid, device, s);
  else
    rc = p->bulk ? launch<__nv_bfloat16, true>(x, out, sh, p->grid, device, s)
                 : launch<__nv_bfloat16, false>(x, out, sh, p->grid, device,
                                                s);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
