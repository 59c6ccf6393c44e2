// GQA flash-decode attention ("flash-decoding": S split across CTAs),
// hand-written for sm_90a.
//
//   out[b, h G + g] = softmax_s(q[b, h G + g] . k[b, s, h] / sqrt(d)) v[b, s, h]
//   q (B, Hq, d); k, v (B, S, Hkv, d), all contiguous, fp32 or bf16;
//   length (B,) int32 in [0, S]; out (B, Hq, d) in q's type; G = Hq / Hkv.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:69
// (flash_decode_pallas, body _flash_decode_kernel), reached through the
// public wrapper ops.flash_decode.  It keeps that kernel's arithmetic:
// masked scores are -1e30, the running max starts at -1e30, the sum is
// divided by max(l, 1e-30), and S counts as padded with zeros to
// s_pad (the wrapper's chunk).  So a row of length 0 weighs every padded
// position 1 and gives sum(v[:S]) / s_pad, as the Pallas kernel does.
//
// What bounds it on an H100: bytes.  Every K and V element is read once
// and feeds G query heads: 4 G FLOPs for 2 d elements, far below the
// card's ridge.  At llama3-8b's decode_32k one layer's cache is 17.2 GB
// (5.1 ms at 3.35 TB/s).
//
// Design.  The TPU grid walked S in order inside one (b, h); on Hopper S
// is split so that B x Hkv x n_split CTAs fill the 132 SMs several times
// over (at B = 1, Hkv = 8 the unsplit grid would be 8 CTAs).
//   Launch 1, grid (n_split, Hkv, B), 256 threads: a CTA owns the G query
//   heads of one KV head and one range of S, walks it in tiles of 32 rows
//   through a two-stage cp.async ring of K and V tiles in shared memory,
//   and keeps the running max, the sum and the (G, d) accumulator in
//   fp32.  Scores: warp w takes 16-byte chunks w, w + 8, ... of every row,
//   lane t row t, so the q reads are broadcasts and the K reads hit 8
//   distinct bank groups (rows 16 bytes longer than d); the 8 warps' part
//   sums meet in shared memory.  Softmax: one warp per head, one lane per
//   row.  P V: each thread owns 2 adjacent columns of a few heads, reads
//   V as one 4- or 8-byte word a row and p as broadcasts.  Tiles that lie
//   wholly at or past a row's length are skipped, which is exact for
//   length >= 1 (their weights are exp(-1e30 - m) = 0); at length 0 every
//   tile is walked.  Rows past S are zero-filled and weigh 0.  The CTA
//   writes its partial (m, l, acc) to fp32 scratch.
//   Launch 2, grid (Hq, B), d threads: merges a head's partials, adds the
//   s_pad - S zero positions (weight exp(-1e30 - M)), divides, and casts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;          // KV rows per tile
constexpr int kMaxG = 16;       // query heads per KV head
constexpr int kMaxOwn = 8;      // heads per thread in P V (d <= 256)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// two adjacent elements as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  int B, S, Hkv, G, d;
  int split_len;   // rows of S per CTA, a multiple of kT
  int n_split;
};

// shared memory: K and V rings, q (fp32), part sums, p, and m / l / alpha
__host__ __device__ inline int row_pitch(int d, int esize) { return d * esize + 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ length,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, G = a.G;
  const int rp = row_pitch(d, sizeof(T));
  const int tile_bytes = kT * rp;
  unsigned char* ring = smem;                               // [2][K, V][kT][rp]
  float* qs = reinterpret_cast<float*>(smem + 4 * tile_bytes);  // G x d
  float* red = qs + G * d;                                  // kWarps x G x kT
  float* ps = red + kWarps * G * kT;                        // G x kT
  float* ms = ps + G * kT;                                  // G
  float* ls = ms + kMaxG;
  float* al = ls + kMaxG;

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(length[b], 0), a.S);
  const int s_begin = sp * a.split_len;
  const int s_end = min(a.S, s_begin + a.split_len);
  // tiles wholly at or past the length weigh 0 (length >= 1)
  const int s_stop = len > 0 ? min(s_end, len) : s_end;
  const int ntiles = s_stop > s_begin ? (s_stop - s_begin + kT - 1) / kT : 0;

  const long long row_stride = (long long)a.Hkv * d;       // elements
  const T* kb = k + ((long long)b * a.S * a.Hkv + h) * d;
  const T* vb = v + ((long long)b * a.S * a.Hkv + h) * d;
  constexpr int kVec = 16 / sizeof(T);
  const int nchunks = d / kVec;                             // 16-byte chunks a row

  auto load_tile = [&](int it, int stage) {
    const int s0 = s_begin + it * kT;
    unsigned char* kd = ring + (2 * stage) * tile_bytes;
    unsigned char* vd = kd + tile_bytes;
    for (int u = tid; u < kT * nchunks; u += kThreads) {
      const int r = u / nchunks, c = u - r * nchunks;
      const int pos = s0 + r;
      const bool in = pos < a.S;
      const long long off = in ? (long long)pos * row_stride + c * kVec : 0;
      cp_async16(kd + r * rp + c * 16, kb + off, in ? 16 : 0);
      cp_async16(vd + r * rp + c * 16, vb + off, in ? 16 : 0);
    }
  };

  if (ntiles > 0) {
    load_tile(0, 0);
    cp_async_commit();
  }
  const T* qb = q + ((long long)b * a.Hkv * G + (long long)h * G) * d;
  for (int u = tid; u < G * d; u += kThreads) qs[u] = to_f32(qb[u]);
  if (tid < G) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }

  // P V ownership: 2 adjacent columns of heads hg, hg + ngroups, ...
  const int half = d / 2;
  const int ngroups = kThreads / half;
  const int cpi = tid % half, hg = tid / half;
  const bool pv_on = hg < ngroups;
  float acc[kMaxOwn][2];
#pragma unroll
  for (int o = 0; o < kMaxOwn; ++o) acc[o][0] = acc[o][1] = 0.f;
  const float sqrt_d = sqrtf((float)d);

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      load_tile(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = ring + (2 * stage) * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;

    // scores: warp = chunk slice, lane = row
    {
      float sc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
      for (int c = warp; c < nchunks; c += kWarps) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kt + lane * rp + c * 16);
        const T* kv = reinterpret_cast<const T*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = to_f32(kv[i]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4* q4 = reinterpret_cast<const float4*>(qs + g * d + c * kVec);
#pragma unroll
            for (int i = 0; i < kVec / 4; ++i) {
              const float4 qv = q4[i];
              sc[g] = fmaf(qv.x, kf[4 * i + 0], sc[g]);
              sc[g] = fmaf(qv.y, kf[4 * i + 1], sc[g]);
              sc[g] = fmaf(qv.z, kf[4 * i + 2], sc[g]);
              sc[g] = fmaf(qv.w, kf[4 * i + 3], sc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) red[(warp * G + g) * kT + lane] = sc[g];
    }
    __syncthreads();

    // online softmax: warp per head, lane per row
    const int pos = s_begin + it * kT + lane;
    for (int g = warp; g < G; g += kWarps) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += red[(w * G + g) * kT + lane];
      const float s = pos < a.S ? (pos < len ? dot / sqrt_d : kNeg) : -INFINITY;
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      ps[g * kT + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[g] = alpha;
        ls[g] = alpha * ls[g] + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + p V
    if (pv_on) {
#pragma unroll
      for (int o = 0; o < kMaxOwn; ++o) {
        const int g = hg + o * ngroups;
        if (g < G) {
          const float alpha = al[g];
          float a0 = acc[o][0] * alpha, a1 = acc[o][1] * alpha;
          const float* pg = ps + g * kT;
          for (int t = 0; t < kT; t += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pg + t);
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {
              const float2 vv = load2(reinterpret_cast<const T*>(
                  vt + (t + tt) * rp) + 2 * cpi);
              a0 = fmaf(pv[tt], vv.x, a0);
              a1 = fmaf(pv[tt], vv.y, a1);
            }
          }
          acc[o][0] = a0;
          acc[o][1] = a1;
        }
      }
    }
    __syncthreads();   // the stage and ps are free for the next tile
  }

  const long long base = ((long long)(b * a.Hkv + h) * a.n_split + sp) * G;
  if (tid < G) {
    part_m[base + tid] = ms[tid];
    part_l[base + tid] = ls[tid];
  }
  if (pv_on) {
#pragma unroll
    for (int o = 0; o < kMaxOwn; ++o) {
      const int g = hg + o * ngroups;
      if (g < G) {
        float* dst = part_acc + (base + g) * d + 2 * cpi;
        dst[0] = acc[o][0];
        dst[1] = acc[o][1];
      }
    }
  }
}

template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ out, Args a,
                                          int pad) {
  const int hq = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  const int h = hq / a.G, g = hq % a.G;
  const long long base = (long long)(b * a.Hkv + h) * a.n_split * a.G + g;
  float m = kNeg;
  for (int sp = 0; sp < a.n_split; ++sp) m = fmaxf(m, part_m[base + (long long)sp * a.G]);
  // the s_pad - S zero positions score -1e30 and weigh exp(-1e30 - m)
  float l = (float)pad * expf(kNeg - m);
  float o = 0.f;
  for (int sp = 0; sp < a.n_split; ++sp) {
    const long long i = base + (long long)sp * a.G;
    const float w = expf(part_m[i] - m);
    l = fmaf(part_l[i], w, l);
    o = fmaf(part_acc[i * a.d + col], w, o);
  }
  from_f32(o / fmaxf(l, 1e-30f), out + ((long long)b * a.Hkv * a.G + hq) * a.d + col);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* part_m, void* part_l, void* part_acc, void* out, Args a,
           int pad, void* stream) {
  const int tile_bytes = kT * row_pitch(a.d, sizeof(T));
  const int smem = 4 * tile_bytes +
                   (a.G * a.d + kWarps * a.G * kT + a.G * kT + 3 * kMaxG) *
                       (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1(a.n_split, a.Hkv, a.B);
  flash_decode_split_kernel<T><<<grid1, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length,
      (float*)part_m, (float*)part_l, (float*)part_acc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(a.Hkv * a.G, a.B);
  flash_decode_merge_kernel<T><<<grid2, a.d, 0, (cudaStream_t)stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, a, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  The wrapper checks G <= 16, d % 8 == 0,
// d <= 256, contiguity, 16-byte alignment, and sizes the scratch:
// part_m, part_l (B, Hkv, n_split, G) and part_acc (B, Hkv, n_split, G, d),
// fp32.  pad = s_pad - S.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* length,
                                   void* part_m, void* part_l, void* part_acc,
                                   void* out, int B, int S, int Hkv, int G,
                                   int d, int split_len, int n_split, int pad,
                                   int dtype, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Args a{B, S, Hkv, G, d, split_len, n_split};
  if (dtype == 0)
    return launch<float>(q, k, v, length, part_m, part_l, part_acc, out, a,
                         pad, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, part_m, part_l, part_acc,
                                 out, a, pad, stream);
  return (int)cudaErrorInvalidValue;
}
