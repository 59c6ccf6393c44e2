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
// position 1 and gives sum(v[:S]) / s_pad, as the Pallas kernel does.  A
// length above S is clamped to S.
//
// What bounds it on an H100: bytes.  Every K and V element is read once
// and feeds G query heads: 4 G FLOPs for 2 d elements, far below the
// card's ridge.  At llama3-8b's decode_32k one layer's cache is 17.2 GB
// (5.1 ms at 3.35 TB/s).  So the design keeps loads in flight at all times
// and keeps the arithmetic off the loads' way.
//
// Design.  The TPU grid walked S in order inside one (b, h); on Hopper S
// is split so that B x Hkv x n_split CTAs fill the 132 SMs several times
// over (at B = 1, Hkv = 8 the unsplit grid would be 8 CTAs).
//   Launch 1, grid (n_split, Hkv, B), 8 warps (4 for fp32 at d > 128): a
//   CTA owns the G query heads of one KV head and one range of S, and walks
//   it in tiles of 64 rows (32 for fp32 at d > 128) through a 3-stage
//   cp.async ring of K and V tiles in dynamic shared memory, so two tiles
//   are in flight while one is consumed.  The one __syncthreads a tile
//   releases a ring stage; nothing else is block-wide.  Warp w owns rows
//   8 w .. 8 w + 7 of every tile and keeps its own running max, sum and
//   (G, d) accumulator in registers:
//     scores   bf16: mma.sync.m16n8k16 with q as M (G padded to 16 heads,
//              ldmatrix) and the warp's 8 K rows as N (ldmatrix from the
//              ring), fp32 accumulate in two chains; the products of two
//              bf16 values are exact in fp32.  fp32: CUDA-core FMAs into
//              the same register layout.  A lane holds 2 rows of 1 head
//              (2 heads for G > 8).
//     softmax  per head, across the 4 lanes that share a head (2 shuffles);
//              p and the rescale factor go to warp-private shared memory.
//     P V      fp32 FMAs: a lane owns 4 adjacent columns of every head and
//              reads a V row as one 8- or 16-byte word, p as broadcasts.
//   8 warps of 8 rows, not 4 of 16, because shared memory admits 2 CTAs
//   per SM and the warps' serial chains (mma, shuffles, FMAs) need the
//   warps to hide their latency behind each other.  (A ring filled by one
//   TMA bulk copy per 256-byte row measured slower than cp.async: the
//   copies stall the warp that issues them.)
//   Tiles that lie wholly at or past a row's length are skipped, which is
//   exact for length >= 1 (their weights are exp(-1e30 - m) = 0); at length
//   0 every tile is walked.  Rows past S are zero-filled and weigh 0.  At
//   the end the warps' partial (m, l, acc) merge once through shared
//   memory, and the CTA writes its partial to fp32 scratch.
//   Launch 2, grid (Hq, B), d x min(8, n_split) threads: merges a head's
//   partials (up to 8 groups of splits in parallel, then the groups), adds
//   the s_pad - S zero positions (weight exp(-1e30 - M)), divides, casts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;        // K/V ring depth
constexpr int kWarpRows = 8;      // rows of a tile each warp owns
constexpr int kQRows = 16;        // q rows in shared memory: the mma's M
constexpr float kNeg = -1e30f;

// fp32 at d > 128 takes 32-row tiles so that 3 stages fit
template <typename T, int NC>
struct Cfg {
  static constexpr int kTile = (sizeof(T) == 4 && NC == 2) ? 32 : 64;
  static constexpr int kWarps = kTile / kWarpRows;
  static constexpr int kThreads = 32 * kWarps;
};

struct Args {
  int B, S, Hkv, G, d;
  int split_len;   // rows of S per CTA, a multiple of the tile
  int n_split;
};

// a K, V or q row in shared memory: 16 bytes longer than the data, so that
// eight rows at one column fall in distinct bank groups
__host__ __device__ inline int row_pitch(int d, int esize) { return d * esize + 16; }

template <typename T, int GT, int NC>
__host__ __device__ inline int smem_bytes(int d) {
  using C = Cfg<T, NC>;
  const int rp = row_pitch(d, sizeof(T));
  return kStages * 2 * C::kTile * rp + kQRows * rp +
         C::kWarps * (kWarpRows * GT + GT) * (int)sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
// four adjacent elements of a shared-memory row as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 8 rows (from row0 of the tile kt) against the 16 head rows of
// q in shared memory qs.  sc = (h0, r0), (h0, r1), (h1, r0), (h1, r1) with
// h0 = lane / 4, h1 = h0 + 8, r0 = 2 (lane % 4), r1 = r0 + 1: the
// accumulator layout of mma.m16n8.  Rows of K and q hold zeros from d to
// the next multiple of 16; q's rows past G are zero.
template <int GT>
__device__ __forceinline__ void warp_scores(const __nv_bfloat16*,
                                            const unsigned char* kt, int rp,
                                            int row0, const unsigned char* qs,
                                            int d, int lane, float (&sc)[4]) {
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  // A (q, 16 x 16): lane l addresses row l % 8 of matrix l / 8 = (heads
  // 0-7 | 8-15) x (k 0-7 | 8-15).  B (K^T, 16 x 8): lanes 0-15 address
  // row l % 8 of matrix l / 8 = rows x (k 0-7 | 8-15).
  const unsigned char* arow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * rp +
                              (lane >> 4) * 16;
  const unsigned char* brow = kt + (row0 + (lane & 7)) * rp + ((lane >> 3) & 1) * 16;
  int k0 = 0;
  for (; k0 + 16 < d; k0 += 32) {        // two independent chains
    unsigned a[4], b0, b1;
    ldmatrix_x4(a, arow + k0 * 2);
    ldmatrix_x2(b0, b1, brow + k0 * 2);
    mma_bf16(c0, a, b0, b1);
    ldmatrix_x4(a, arow + k0 * 2 + 32);
    ldmatrix_x2(b0, b1, brow + k0 * 2 + 32);
    mma_bf16(c1, a, b0, b1);
  }
  if (k0 < d) {
    unsigned a[4], b0, b1;
    ldmatrix_x4(a, arow + k0 * 2);
    ldmatrix_x2(b0, b1, brow + k0 * 2);
    mma_bf16(c0, a, b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i] = c0[i] + c1[i];
}

template <int GT>
__device__ __forceinline__ void warp_scores(const float*,
                                            const unsigned char* kt, int rp,
                                            int row0, const unsigned char* qs,
                                            int d, int lane, float (&sc)[4]) {
  const float* k0 = reinterpret_cast<const float*>(kt + (row0 + 2 * (lane & 3)) * rp);
  const float* k1 = reinterpret_cast<const float*>(kt + (row0 + 2 * (lane & 3) + 1) * rp);
#pragma unroll
  for (int hs = 0; hs < (GT > 8 ? 2 : 1); ++hs) {
    const float* qh = reinterpret_cast<const float*>(qs + ((lane >> 2) + 8 * hs) * rp);
    float s0 = 0.f, s1 = 0.f;
    for (int c = 0; c < d; c += 4) {
      const float4 qa = load4(qh + c), ka = load4(k0 + c), kb = load4(k1 + c);
      s0 = fmaf(qa.x, ka.x, fmaf(qa.y, ka.y, fmaf(qa.z, ka.z, fmaf(qa.w, ka.w, s0))));
      s1 = fmaf(qa.x, kb.x, fmaf(qa.y, kb.y, fmaf(qa.z, kb.z, fmaf(qa.w, kb.w, s1))));
    }
    sc[2 * hs] = s0;
    sc[2 * hs + 1] = s1;
  }
}

// over the 4 lanes of a quad: the lanes that hold one head
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// GT: G rounded up to 4, 8 or 16; NC: d <= 128 (1) or d <= 256 (2)
template <typename T, int GT, int NC>
__global__ void __launch_bounds__(Cfg<T, NC>::kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ length,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, Args a) {
  using C = Cfg<T, NC>;
  constexpr int NW = C::kWarps, TR = C::kTile, NTH = C::kThreads;
  constexpr int HS = GT > 8 ? 2 : 1;        // heads a lane holds
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, G = a.G;
  const int rp = row_pitch(d, sizeof(T));
  const int stage_bytes = 2 * TR * rp;
  unsigned char* ring = smem;                       // [kStages][K, V][TR][rp]
  unsigned char* qs = smem + kStages * stage_bytes;  // [kQRows][rp]

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ps = reinterpret_cast<float*>(qs + kQRows * rp) +
              warp * (kWarpRows * GT + GT);          // [8][GT] p, this warp's
  float* al = ps + kWarpRows * GT;                   // [GT] rescale factors
  const int len = min(max(length[b], 0), a.S);
  const int s_begin = sp * a.split_len;
  const int s_end = min(a.S, s_begin + a.split_len);
  // tiles wholly at or past the length weigh 0 (length >= 1)
  const int s_stop = len > 0 ? min(s_end, len) : s_end;
  const int ntiles = s_stop > s_begin ? (s_stop - s_begin + TR - 1) / TR : 0;

  const long long row_stride = (long long)a.Hkv * d;       // elements
  const T* kb = k + ((long long)b * a.S * a.Hkv + h) * d;
  const T* vb = v + ((long long)b * a.S * a.Hkv + h) * d;
  // bf16 rows are walked by the mma in steps of 16: zero-fill up to that
  const int dk = sizeof(T) == 2 ? (d + 15) / 16 * 16 : d;
  const int creal = d / kVec, cpr = dk / kVec;             // chunks a row

  // a row's chunks go to lpr adjacent lanes (cpr rounded up to a power of
  // two, at most 32), so a thread's rows and columns are fixed: no division
  // per chunk
  const int lpr = cpr <= 1 ? 1 : cpr <= 2 ? 2 : cpr <= 4 ? 4
                : cpr <= 8 ? 8 : cpr <= 16 ? 16 : 32;
  const int lc = lane % lpr, lrow = warp * (32 / lpr) + lane / lpr;
  const int rstep = NW * (32 / lpr);
  auto load_tile = [&](int it, int stage) {
    const int s0 = s_begin + it * TR;
    unsigned char* kd = ring + stage * stage_bytes + lrow * rp + lc * 16;
    long long off = (long long)(s0 + lrow) * row_stride + lc * kVec;
    for (int r = lrow; r < TR; r += rstep) {
      const bool row_in = s0 + r < a.S;
      for (int c = lc; c < cpr; c += lpr) {
        const bool in = row_in && c < creal;
        const long long o = in ? off + (c - lc) * kVec : 0;
        cp_async16(kd + (c - lc) * 16, kb + o, in ? 16 : 0);
        cp_async16(kd + TR * rp + (c - lc) * 16, vb + o, in ? 16 : 0);
      }
      kd += rstep * rp;
      off += rstep * row_stride;
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    cp_async_commit();
  }
  const T* qb = q + ((long long)b * a.Hkv * G + (long long)h * G) * d;
  for (int u = tid; u < kQRows * dk; u += NTH) {
    const int g = u / dk, c = u - g * dk;
    from_f32(g < G && c < d ? to_f32(qb[g * d + c]) : 0.f,
             reinterpret_cast<T*>(qs + g * rp) + c);
  }

  float m_run[HS], l_run[HS];
#pragma unroll
  for (int hs = 0; hs < HS; ++hs) m_run[hs] = kNeg, l_run[hs] = 0.f;
  float acc[GT][NC][4];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c][0] = acc[g][c][1] = acc[g][c][2] = acc[g][c][3] = 0.f;
  const float sqrt_d = sqrtf((float)d);
  const int r0 = 2 * (lane & 3);                 // this lane's 2 rows

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose stage the next load takes
    __syncthreads();
    {
      const int nx = it + kStages - 1;
      if (nx < ntiles) load_tile(nx, nx % kStages);
      cp_async_commit();
    }
    const unsigned char* kt = ring + (it % kStages) * stage_bytes;
    const unsigned char* vt = kt + TR * rp;

    float sc[4];
    warp_scores<GT>(static_cast<const T*>(nullptr), kt, rp, warp * kWarpRows,
                    qs, d, lane, sc);

    // online softmax, per head, over the warp's 8 rows
    const int pos0 = s_begin + it * TR + warp * kWarpRows + r0;
#pragma unroll
    for (int hs = 0; hs < HS; ++hs) {
      float s0 = sc[2 * hs], s1 = sc[2 * hs + 1];
      s0 = pos0 < a.S ? (pos0 < len ? s0 / sqrt_d : kNeg) : -INFINITY;
      s1 = pos0 + 1 < a.S ? (pos0 + 1 < len ? s1 / sqrt_d : kNeg) : -INFINITY;
      const float m_old = m_run[hs];
      const float m_new = fmaxf(m_old, quad_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);
      l_run[hs] = alpha * l_run[hs] + quad_sum(p0 + p1);
      m_run[hs] = m_new;
      const int g = (lane >> 2) + 8 * hs;
      if (g < GT) {
        ps[r0 * GT + g] = p0;
        ps[(r0 + 1) * GT + g] = p1;
        if ((lane & 3) == 0) al[g] = alpha;
      }
    }
    __syncwarp();

    // acc = alpha acc + p V over the warp's 8 rows
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float alpha = al[g];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][c][e] *= alpha;
    }
    const unsigned char* vw = vt + warp * kWarpRows * rp;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      float pr[GT];
#pragma unroll
      for (int g = 0; g < GT; g += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * GT + g);
        pr[g] = p4.x; pr[g + 1] = p4.y; pr[g + 2] = p4.z; pr[g + 3] = p4.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * lane + 128 * c;
        if (col < d) {
          const float4 vv = load4(reinterpret_cast<const T*>(vw + r * rp) + col);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            acc[g][c][0] = fmaf(pr[g], vv.x, acc[g][c][0]);
            acc[g][c][1] = fmaf(pr[g], vv.y, acc[g][c][1]);
            acc[g][c][2] = fmaf(pr[g], vv.z, acc[g][c][2]);
            acc[g][c][3] = fmaf(pr[g], vv.w, acc[g][c][3]);
          }
        }
      }
    }
    __syncwarp();   // ps and al are rewritten by the next tile
  }

  // merge the warps' partials once, through the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);   // [NW][GT]
  float* wl = wm + NW * GT;                      // [NW][GT]
  float* wacc = wl + NW * GT;                    // [NW][GT][d]
#pragma unroll
  for (int hs = 0; hs < HS; ++hs) {
    const int g = (lane >> 2) + 8 * hs;
    if ((lane & 3) == 0 && g < GT) {
      wm[warp * GT + g] = m_run[hs];
      wl[warp * GT + g] = l_run[hs];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * lane + 128 * c;
      if (col < d)
        *reinterpret_cast<float4*>(wacc + (warp * GT + g) * d + col) =
            make_float4(acc[g][c][0], acc[g][c][1], acc[g][c][2], acc[g][c][3]);
    }
  __syncthreads();
  const long long base = ((long long)(b * a.Hkv + h) * a.n_split + sp) * G;
  for (int u = tid; u < G * d; u += NTH) {
    const int g = u / d, col = u - g * d;
    float m = kNeg;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, wm[w * GT + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(wm[w * GT + g] - m);
      l = fmaf(wl[w * GT + g], e, l);
      o = fmaf(wacc[(w * GT + g) * d + col], e, o);
    }
    part_acc[(base + g) * d + col] = o;
    if (col == 0) {
      part_m[base + g] = m;
      part_l[base + g] = l;
    }
  }
}

// Launch 2: block (d, ng); group y merges splits y, y + ng, ... of one
// head, then group 0 merges the ng group results
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ out, Args a,
                                          int pad) {
  extern __shared__ float red[];                 // [ng][d] acc, then m, l
  const int hq = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  const int grp = threadIdx.y, ng = blockDim.y;
  const int h = hq / a.G, g = hq % a.G;
  const long long base = (long long)(b * a.Hkv + h) * a.n_split * a.G + g;
  float m = kNeg;
  for (int sp = grp; sp < a.n_split; sp += ng)
    m = fmaxf(m, part_m[base + (long long)sp * a.G]);
  float l = 0.f, o = 0.f;
  for (int sp = grp; sp < a.n_split; sp += ng) {
    const long long i = base + (long long)sp * a.G;
    const float w = expf(part_m[i] - m);
    l = fmaf(part_l[i], w, l);
    o = fmaf(part_acc[i * a.d + col], w, o);
  }
  float* gm = red + ng * a.d;
  float* gl = gm + ng;
  red[grp * a.d + col] = o;
  if (col == 0) {
    gm[grp] = m;
    gl[grp] = l;
  }
  __syncthreads();
  if (grp != 0) return;
  float mm = kNeg;
  for (int i = 0; i < ng; ++i) mm = fmaxf(mm, gm[i]);
  // the s_pad - S zero positions score -1e30 and weigh exp(-1e30 - mm)
  float ll = (float)pad * expf(kNeg - mm), oo = 0.f;
  for (int i = 0; i < ng; ++i) {
    const float w = expf(gm[i] - mm);
    ll = fmaf(gl[i], w, ll);
    oo = fmaf(red[i * a.d + col], w, oo);
  }
  from_f32(oo / fmaxf(ll, 1e-30f), out + ((long long)b * a.Hkv * a.G + hq) * a.d + col);
}

template <typename T, int GT, int NC>
int launch_split(const void* q, const void* k, const void* v,
                 const void* length, void* part_m, void* part_l,
                 void* part_acc, Args a, cudaStream_t stream) {
  const int smem = smem_bytes<T, GT, NC>(a.d);
  auto kern = flash_decode_split_kernel<T, GT, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_split, a.Hkv, a.B);
  kern<<<grid, Cfg<T, NC>::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length,
      (float*)part_m, (float*)part_l, (float*)part_acc, a);
  return (int)cudaGetLastError();
}

template <typename T, int GT>
int launch_split_d(const void* q, const void* k, const void* v,
                   const void* length, void* part_m, void* part_l,
                   void* part_acc, Args a, cudaStream_t stream) {
  if (a.d <= 128)
    return launch_split<T, GT, 1>(q, k, v, length, part_m, part_l, part_acc, a, stream);
  return launch_split<T, GT, 2>(q, k, v, length, part_m, part_l, part_acc, a, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* part_m, void* part_l, void* part_acc, void* out, Args a,
           int pad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (a.G <= 4)
    rc = launch_split_d<T, 4>(q, k, v, length, part_m, part_l, part_acc, a, s);
  else if (a.G <= 8)
    rc = launch_split_d<T, 8>(q, k, v, length, part_m, part_l, part_acc, a, s);
  else
    rc = launch_split_d<T, 16>(q, k, v, length, part_m, part_l, part_acc, a, s);
  if (rc != 0) return rc;
  const int ng = max(1, min(min(8, a.n_split), 1024 / a.d));
  const dim3 grid2(a.Hkv * a.G, a.B), block2(a.d, ng);
  flash_decode_merge_kernel<T><<<grid2, block2, (ng * (a.d + 2)) * sizeof(float), s>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc,
      (T*)out, a, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  The wrapper checks G <= 16, d % 8 == 0,
// d <= 256, contiguity, 16-byte alignment, that split_len is a multiple of
// 64 rows, and sizes the scratch: part_m, part_l (B, Hkv, n_split, G) and
// part_acc (B, Hkv, n_split, G, d), fp32.  pad = s_pad - S.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* length,
                                   void* part_m, void* part_l, void* part_acc,
                                   void* out, int B, int S, int Hkv, int G,
                                   int d, int split_len, int n_split, int pad,
                                   int dtype, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (G < 1 || G > 16 || d % 8 || d < 8 || d > 256 || split_len % 64)
    return (int)cudaErrorInvalidValue;
  Args a{B, S, Hkv, G, d, split_len, n_split};
  if (dtype == 0)
    return launch<float>(q, k, v, length, part_m, part_l, part_acc, out, a,
                         pad, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, part_m, part_l, part_acc,
                                 out, a, pad, stream);
  return (int)cudaErrorInvalidValue;
}
