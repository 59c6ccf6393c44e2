// Co-occurrence counts over the 0/1 incidence, int8 tensor cores, sm_90a.
//
//   C[m, n] = sum_k A[m, k] * B[n, k]        (int32 accumulation)
//   A (M, K) int8, row m at A + m * lda; B (N, K) int8, row n at B + n * ldb;
//   C (M, N) int32, row-major.  K, the document axis, is contiguous in both.
//
// This is x_l^T @ x_r of the reference with x_l = A^T and x_r = B^T: A is a
// group of row blocks' 0/1 rows, B the term-major incidence.  On one device
// materialize stages both over the group's own documents only, those
// holding one of its terms, so K is the group's union (padded to 16);
// under a mesh, or beside an x_dense already built, A is the group's
// unpacked filter masks and B x_dense itself (QueryContext.x_dense's
// storage), K every document.  Counts of 0/1 operands are exact in int32
// for any K < 2^31.
//
// Replaces the TPU kernel src/repro/kernels/cooccur.py:36
// (cooccur_gemm_pallas, body _cooccur_kernel), the count source of
// materialize(method="pallas").  The TPU kernel carried its output block
// across a sequential K grid axis; here each CTA owns one output tile and
// walks all of K itself, so there is no split-K, no atomic and the result
// is deterministic.
//
// What bounds it on an H100.  At one 128-term row block (M = 128, N =
// 65,536 terms, K = 396,224 doc slots) a launch streams the 26 GB incidence
// once for 6.65e12 int8 operations: 7.8 ms of bytes at 3.35 TB/s against
// 3.4 ms of operations at 1,979 TOP/s.  materialize hands the kernel
// several row blocks at once (core/materialize.py GROUP), so one pass over
// the incidence serves them all: at M = 512 the launch moves 26.3 GB (7.9
// ms) for 2.66e13 operations (13.4 ms), and is bound by operations.
//
// Design (the main path): wgmma fed by TMA.
//   * A CTA owns a 128 x 256 tile of C: two consumer warpgroups, each
//     issuing wgmma.mma_async.m64n256k32.s32.s8.s8 on 64 rows (128 int32
//     accumulators a thread), and one producer warp whose lane 0 issues
//     the TMA loads.  Both operands are read by wgmma from shared memory,
//     K-major (the only layout 8-bit wgmma takes, and already the layout
//     of both operands).
//   * A 4-stage ring of (A 128 x 128 B, B 256 x 128 B) tiles, written by
//     TMA with the 128-byte swizzle that the wgmma descriptors name, and
//     guarded by mbarriers: "full" (the producer's expected bytes) and
//     "empty" (one arrival per consumer warpgroup of every CTA that writes
//     into the stage).  Each consumer keeps one stage of wgmmas in flight
//     and releases the stage before it.
//   * CTAs run in clusters of kClusterM (along M) x kClusterN (along N).
//     The CTAs of one N tile in a cluster share their B tile: each loads
//     1 / kClusterM of it and multicasts it to the others; the CTAs of one
//     M tile share A the same way.  So B crosses L2 into shared memory
//     ceil(M / 128) / kClusterM times in all, and A ceil(N / 256) /
//     kClusterN times.  At M = 512, N = 65,536 with the 4 x 1 cluster: B
//     (26 GB) is read from HBM once and crosses L2 once; A (203 MB)
//     crosses L2 256 times (52 GB), and is read from HBM again only where
//     its tiles have left L2 (the CTAs of a wave walk K together).  That
//     is 24 KB from L2 per CTA and stage, against 48 KB without the
//     multicast (155 GB in all at M = 512): without it the launch is
//     bound by L2, not by the tensor cores.  The host shrinks a cluster
//     dimension to the largest power of two that divides the grid.
//   * TMA zero-fills whatever lies outside (M, N, K), so ragged edges need
//     no padding and no masking until the store.  The accumulators go to C
//     straight from registers (8-byte stores along a row).
// The fallback: an operand that TMA cannot describe (a base or row stride
// that is not a multiple of 16 bytes) takes an mma.sync.m16n8k32 kernel
// with byte loads, 128 x 128 tiles and 8 warps.  No main-path operand does:
// unpack_bitmap and dense_operand give K a multiple of 32 and 16-byte
// aligned rows.  The launcher returns the path it took.
//
// What a later redesign would change.  With K cut to a group's union, a
// tail group's launch is mostly its (M, N) count write: 134 MB at M = 512,
// N = 65,536, about 40 us of bytes against tens of us of operations.  So
// first a fused per-row top-k (no (M, N) count write), then a persistent
// grid so that one tile's stores overlap the next tile's loads.
#include <cuda.h>            // CUtensorMap and its enums (header only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// wgmma + TMA path
// ---------------------------------------------------------------------------

constexpr int kTM = 128;                // rows of A per CTA
constexpr int kTN = 256;                // rows of B per CTA
constexpr int kTK = 128;                // bytes of K a stage: a swizzle row
constexpr int kStages = 4;
// the cluster asked for, along M and along N: of 1 x 1, 2 x 1, 4 x 1 and
// 2 x 2, timed at M = 512 on an H100, 4 x 1 and 2 x 2 were fastest
constexpr int kClusterM = 4, kClusterN = 1;
constexpr int kConsumers = 2;           // warpgroups of 64 rows of A each
constexpr int kThreads = kConsumers * 128 + 32;   // + the producer warp
constexpr int kABytes = kTM * kTK;      // 16 KB
constexpr int kBBytes = kTN * kTK;      // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
// the ring, 1 KB of slack to align it to the swizzle's 1 KB period, and
// the full and empty barriers
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

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

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
// Nothing is published by the arrival (the consumer only read the stage,
// and wgmma.wait_group has retired the reads), so it has the default
// CTA-scoped semantics.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(row)
      : "memory");
}

// The same tile written to the same offset of every CTA in `mask` (cluster
// ranks), each CTA's own barrier at `bar`'s offset counting the bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int k,
                                                   int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "h"(mask), "r"(k), "r"(row)
      : "memory");
}

// This CTA's place in its cluster and the cluster's shape.
__device__ __forceinline__ void cluster_shape(uint32_t& x, uint32_t& y,
                                              uint32_t& nx, uint32_t& ny) {
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;\n"
               "mov.u32 %1, %%cluster_ctaid.y;\n"
               "mov.u32 %2, %%cluster_nctaid.x;\n"
               "mov.u32 %3, %%cluster_nctaid.y;\n"
               : "=r"(x), "=r"(y), "=r"(nx), "=r"(ny));
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1 KB apart (the stride
// byte offset); the leading byte offset is unused in this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d[64 x 256] (+)= A[64 x 32 bytes] * B[256 x 32 bytes]^T, both from shared
// memory; scale == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da,
                                                 uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale));
}

__global__ void __launch_bounds__(kThreads, 1)
cooccur_wgmma(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              int32_t* __restrict__ C, int M, int N, int nk) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1 KB of shared address: tiles start
  // on that period, so the descriptors need no base offset
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  uint32_t cx, cy, ncx, ncy;
  cluster_shape(cx, cy, ncx, ncy);
  const uint32_t ncta = ncx * ncy;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * ncta);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier of the cluster is initialised before any CTA loads into
  // or arrives on another's
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  const int m0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int warp = tid / 32;
  if (warp == kConsumers * 4) {
    if (tid % 32 == 0) {
      // producer.  Cluster rank = cx + cy * ncx.  The CTAs of this M tile
      // (same cx) share A; those of this N tile (same cy) share B.
      const int a_rows = kTM / ncy, b_rows = kTN / ncx;
      uint16_t a_mask = 0;
      for (uint32_t j = 0; j < ncy; ++j) a_mask |= 1u << (cx + j * ncx);
      const uint16_t b_mask = ((1u << ncx) - 1u) << (cy * ncx);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        const uint32_t sa = base + s * kStageBytes, sb = sa + kABytes;
        if (ncy == 1)
          tma_load(sa, &map_a, full(s), kt * kTK, m0);
        else
          tma_load_multicast(sa + cy * a_rows * kTK, &map_a, full(s), kt * kTK,
                             m0 + cy * a_rows, a_mask);
        if (ncx == 1)
          tma_load(sb, &map_b, full(s), kt * kTK, n0);
        else
          tma_load_multicast(sb + cx * b_rows * kTK, &map_b, full(s), kt * kTK,
                             n0 + cx * b_rows, b_mask);
      }
    }
  } else {
    // consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64)
    const int wg = warp / 4;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      const uint32_t sa = base + s * kStageBytes + wg * 64 * kTK;
      const uint64_t da = sw128_desc(sa);
      const uint64_t db = sw128_desc(base + s * kStageBytes + kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 32; ++kk)   // 32 bytes = 2 units of 16 B
        wgmma_m64n256k32(acc, da + 2 * kk, db + 2 * kk, kt | kk);
      wgmma_commit();
      wgmma_wait<1>();            // the previous stage's products are done
      // lane c of the warpgroup's first warp releases the stage in CTA c
      if (kt > 0 && tid % 128 < ncta)
        mbar_arrive_cluster(empty((kt - 1) % kStages), tid % 128);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");

    // accumulator layout of m64nNk32: register 4j + 2h + c of lane l in
    // warp w of the warpgroup is row 16 w + l / 4 + 8 h, column
    // 8 j + 2 (l % 4) + c
    const int lane = tid % 32;
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M || col >= N) continue;
        int32_t* out = C + (long long)row * N + col;
        if (pairs) {
          *reinterpret_cast<int2*>(out) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          out[0] = acc[4 * j + 2 * h];
          if (col + 1 < N) out[1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
  // no CTA leaves while a partner may still write into its ring or arrive
  // on its barriers
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Codes above every cudaError_t: the tensor map could not be made.
constexpr int kErrNoEncode = 100000;
constexpr int kErrEncode = 100001;

// A (rows, K) int8 operand with rows `ld` bytes apart, read in boxes of
// (box_rows, 128 bytes) with the 128-byte swizzle; zeros outside.
int make_map(CUtensorMap* map, const void* ptr, int rows, int K, long long ld,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kTK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The largest power of two <= want that divides tiles.
int cluster_dim(int want, int tiles) {
  int c = want;
  while (c > 1 && tiles % c != 0) c /= 2;
  return c;
}

int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                 long long lda, long long ldb, cudaStream_t stream) {
  const int mt = (M + kTM - 1) / kTM, nt = (N + kTN - 1) / kTN;
  const int cm = cluster_dim(kClusterM, mt), cn = cluster_dim(kClusterN, nt);
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, a, M, K, lda, kTM / cn);
  if (rc == 0) rc = make_map(&map_b, b, N, K, ldb, kTN / cm);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      cooccur_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mt, nt, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cm;
  attr[0].val.clusterDim.y = cn;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int nk = (K + kTK - 1) / kTK;
  e = cudaLaunchKernelEx(&cfg, cooccur_wgmma, map_a, map_b, (int32_t*)c, M, N,
                         nk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fallback: mma.sync with byte loads, for operands TMA cannot describe
// ---------------------------------------------------------------------------

constexpr int kFBM = 128, kFBN = 128;  // output tile
constexpr int kFBK = 64;               // bytes of K per step
constexpr int kFPitch = kFBK + 16;     // smem row pitch: conflict-free reads
constexpr int kFThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16;       // m16 tiles per warp
constexpr int kNT = kWarpN / 8;        // n8 tiles per warp
constexpr int kFSmemBytes = (kFBM + kFBN) * kFPitch;   // 20,480

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
__device__ __forceinline__ void load_tile_bytes(int8_t* s, const int8_t* g,
                                                long long ld, int rows,
                                                int row0, int K, int k0) {
  for (int i = threadIdx.x; i < kFBM * kFBK; i += kFThreads) {
    const int r = i / kFBK, c = i % kFBK;
    const int gr = row0 + r, gk = k0 + c;
    s[r * kFPitch + c] =
        (gr < rows && gk < K) ? g[(long long)gr * ld + gk] : (int8_t)0;
  }
}

__global__ void __launch_bounds__(kFThreads)
cooccur_bytes(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              int32_t* __restrict__ C, int M, int N, int K, long long lda,
              long long ldb) {
  __shared__ __align__(16) int8_t smem[kFSmemBytes];
  int8_t* sA = smem;
  int8_t* sB = smem + kFBM * kFPitch;
  const int m0 = blockIdx.x * kFBM;
  const int n0 = blockIdx.y * kFBN;
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

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    __syncthreads();                // the previous step is consumed
    load_tile_bytes(sA, A, lda, M, m0, K, k0);
    load_tile_bytes(sB, B, ldb, N, n0, K, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 32) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = sA + (wm + i * 16 + g) * kFPitch + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kFPitch);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kFPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = sB + (wn + j * 8 + g) * kFPitch + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

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

}  // namespace

// Paths reported in *path: 1 = wgmma + TMA, 2 = the mma.sync byte fallback,
// 0 = nothing launched.  Returns 0 or the launch's error.
extern "C" int cooccur_counts_launch(const void* a, const void* b, void* c,
                                     int M, int N, int K, long long lda,
                                     long long ldb, int* path, void* stream) {
  *path = 0;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0) {  // an empty sum: all counts are zero
    cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), s);
    return (int)cudaGetLastError();
  }
  const bool tma = lda % 16 == 0 && ldb % 16 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  if (tma) {
    *path = 1;
    return launch_wgmma(a, b, c, M, N, K, lda, ldb, s);
  }
  *path = 2;
  const dim3 grid((M + kFBM - 1) / kFBM, (N + kFBN - 1) / kFBN);
  cooccur_bytes<<<grid, kFThreads, 0, s>>>((const int8_t*)a, (const int8_t*)b,
                                           (int32_t*)c, M, N, K, lda, ldb);
  return (int)cudaGetLastError();
}
