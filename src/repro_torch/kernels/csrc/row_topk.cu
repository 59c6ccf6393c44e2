// Exact per-row top-k of a row block's int32 co-occurrence counts,
// hand-written for sm_90a.
//
// Replaces no TPU kernel.  The reference's whole-network sweep
// (src/repro/core/materialize.py) merges each column tile into a running
// (row_tile, k) top-k with lax.top_k and has no Pallas top-k; the port
// counts a row group's (rows, V) counts whole and reduces them here, in
// place of torch.topk over int64 keys built from a copy of the counts
// (kernels/ref.py::row_top_k_ref, the plain version).
//
//   counts (R, ld) int32, columns [0, v) read, any 4-byte aligned rows; r0:
//   row r's own column min(r0 + r, v - 1) counts -1 (the self pair; a pad
//   row r0 + r >= v hides column v - 1, as the plain version does).
//   Out: weights (R, k) int32 and ids (R, k) int64 in lax.top_k order
//   (values descending, lower column first on ties), 1 <= k <= min(v, 128).
//
// What bounds it on an H100: bytes.  Each count is read once, R x v x 4
// bytes (134 MB for a CSL group of 512 x 65,536: 40 us at 3.35 TB/s); the
// outputs are R x k x 12 bytes.  The design keeps everything else on chip:
//   - one CTA a row, W warps (W from v, up to 4), which take the row's
//     16-byte aligned body in turns, 2 KB a warp a step: lanes on
//     neighbouring 16-byte words, kLoads of them in flight a lane, so a
//     CTA streams its row front to back.  The ragged head and tail (at
//     most 3 counts each) go to warp 0.  Chosen by measurement on an
//     H100 among 4, 8 and 16 warps, 2, 4 and 8 loads, and slices against
//     turns (PERF.md);
//   - each warp keeps the best keys it has seen, count * 2^32 + (2^32 - 1 -
//     col) (unique in a row, their order the lax.top_k order: the key of
//     level_step.cu) sorted in registers, E = ceil(k / 32) a lane, lane l
//     holding positions l * E .. l * E + E - 1;
//   - a step whose counts cannot beat the list's k-th key costs one max
//     a count and one ballot a warp; otherwise the step goes through
//     shared memory, and each count that beats the k-th key is inserted
//     by the whole warp (its rank by one warp sum, the shift by one
//     shuffle), and the k-th key is read again.  The self pair is masked
//     on the way;
//   - the W lists meet in shared memory; each of their keys finds its
//     rank in the row by binary searches of the other lists, and the k
//     that rank below k are written, weights and ids.
// Nothing but the outputs goes to device memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;
constexpr int kMaxK = 128;
constexpr int kColsPerWarp = 8192;      // v / W at least this, below 4 warps
constexpr int kLoads = 4;               // 16-byte loads in flight a lane
// 64 registers a thread: 512 rows in one wave of the 132 SMs
constexpr int kMinBlocks = 1024 / (kMaxWarps * 32);
constexpr long long kNone = LLONG_MIN;  // below every key

__device__ __forceinline__ long long make_key(int count, int col) {
  return (long long)count * 4294967296LL +
         (long long)(0xFFFFFFFFu - (uint32_t)col);
}

// The key at position pos of the warp's list (warp-uniform).
template <int E>
__device__ __forceinline__ long long key_at(const long long (&list)[E],
                                            int pos) {
  long long x = list[0];
#pragma unroll
  for (int s = 1; s < E; ++s)
    if (pos % E == s) x = list[s];
  return __shfl_sync(kFull, x, pos / E);
}

// Insert key (warp-uniform, unique) into the warp's descending list; the
// last position falls off.
template <int E>
__device__ __forceinline__ void insert(long long (&list)[E], long long key,
                                       int lane) {
  int above = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) above += list[s] > key;
  const int pos = __reduce_add_sync(kFull, above);
  const long long carry = __shfl_up_sync(kFull, list[E - 1], 1);
#pragma unroll
  for (int s = E - 1; s >= 0; --s) {
    const int p = lane * E + s;
    // (s - 1 clamped, so that no index falls below 0, even untaken)
    const long long before = s > 0 ? list[s > 0 ? s - 1 : 0] : carry;
    if (p > pos)
      list[s] = before;
    else if (p == pos)
      list[s] = key;
  }
}

// Every lane's key with ok set that beats the k-th key (thr) enters the
// list, in lane order; thr follows.
template <int E>
__device__ __forceinline__ void offer(long long (&list)[E], long long& thr,
                                      long long key, bool ok, int lane,
                                      int kpos) {
  unsigned ball = __ballot_sync(kFull, ok && key > thr);
  while (ball) {
    const int src = __ffs(ball) - 1;
    ball &= ball - 1;
    const long long x = __shfl_sync(kFull, key, src);
    if (x > thr) {
      insert(list, x, lane);
      thr = key_at(list, kpos);
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
row_topk_select(const int* __restrict__ counts, long long ld, int v, int r0,
                int k, int32_t* __restrict__ w_out,
                long long* __restrict__ i_out) {
  __shared__ long long lists[kMaxWarps][kMaxK];
  __shared__ int4 stage[kMaxWarps][32 * kLoads];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int* p = counts + (long long)row * ld;
  const int self = min(r0 + row, v - 1);
  const int kpos = k - 1;

  long long list[E];
#pragma unroll
  for (int s = 0; s < E; ++s) list[s] = kNone;
  long long thr = kNone;

  // columns before the first 16-byte boundary and after the last
  const int head = min((int)((16 - ((uintptr_t)p & 15)) & 15) / 4, v);
  const int n_quads = (v - head) / 4;
  const int tail = head + 4 * n_quads;
  if (warp == 0) {
    const bool in_head = lane < head;
    const bool in_tail = lane >= 3 && lane < 3 + (v - tail);
    const int col = in_head ? lane : tail + lane - 3;
    int c = in_head || in_tail ? p[col] : 0;
    if (col == self) c = -1;
    offer(list, thr, make_key(c, col), in_head || in_tail, lane, kpos);
  }

  const int4* q = reinterpret_cast<const int4*>(p + head);
  const int q1 = n_quads;
  for (int base = warp * 32 * kLoads; base < q1;
       base += n_warps * 32 * kLoads) {
    int4 x[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int qi = base + j * 32 + lane;
      x[j] = qi < q1 ? __ldcs(q + qi)
                     : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
    }
    int m = INT_MIN;
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      m = max(m, max(max(x[j].x, x[j].y), max(x[j].z, x[j].w)));
    // can any of this lane's counts beat the k-th key?  Its count must
    // pass thr's, or equal it at a lower column than thr's
    const int thr_count = (int)(thr >> 32);
    const long long thr_col = 0xFFFFFFFFLL - (thr & 0xFFFFFFFFLL);
    const long long col_lo = head + 4LL * (base + lane);
    const bool maybe = m > thr_count || (m == thr_count && col_lo < thr_col);
    if (__ballot_sync(kFull, maybe) == 0) continue;
    // the slow path reads the step from shared memory, one count of each
    // lane a round: one copy of the insertion code, not 4 * kLoads
#pragma unroll
    for (int j = 0; j < kLoads; ++j) stage[warp][j * 32 + lane] = x[j];
    __syncwarp();
    const int* staged = reinterpret_cast<const int*>(stage[warp]);
#pragma unroll 1
    for (int t = 0; t < 4 * kLoads; ++t) {
      const int j = t / 4, e = t % 4;
      const int qi = base + j * 32 + lane;
      const int col = head + 4 * qi + e;
      const int c = col == self ? -1 : staged[(j * 32 + lane) * 4 + e];
      offer(list, thr, make_key(c, col), qi < q1, lane, kpos);
    }
    __syncwarp();
  }

#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int pos = lane * E + s;
    if (pos < k) lists[warp][pos] = list[s];
  }
  __syncthreads();
  // the row's top-k from the W sorted lists: a key's place is the number
  // of keys above it, in its own list and (by binary search) in the others
  const int n = n_warps * k;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int w = t / k;
    const long long key = lists[w][t - w * k];
    int rank = t - w * k;
    for (int u = 0; u < n_warps && rank < k; ++u) {
      if (u == w) continue;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (lists[u][mid] > key)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (key != kNone && rank < k) {
      const long long at = (long long)row * k + rank;
      w_out[at] = (int32_t)(key >> 32);  // arithmetic: a count may be -1
      i_out[at] = (long long)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFLL));
    }
  }
}

}  // namespace

// One launch: rows CTAs of W warps, W = clamp(ceil(v / kColsPerWarp), 1,
// kMaxWarps).  Returns cudaErrorInvalidValue for a k it does not take.
extern "C" int row_topk_launch(const void* counts, long long ld, int rows,
                               int v, int r0, int k, void* w_out,
                               void* i_out, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || k > v || ld < v)
    return (int)cudaErrorInvalidValue;
  int warps = (v + kColsPerWarp - 1) / kColsPerWarp;
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  cudaStream_t s = (cudaStream_t)stream;
  const int* c = (const int*)counts;
  int32_t* w = (int32_t*)w_out;
  long long* i = (long long*)i_out;
  switch ((k + 31) / 32) {
    case 1:
      row_topk_select<1><<<rows, 32 * warps, 0, s>>>(c, ld, v, r0, k, w, i);
      break;
    case 2:
      row_topk_select<2><<<rows, 32 * warps, 0, s>>>(c, ld, v, r0, k, w, i);
      break;
    case 3:
      row_topk_select<3><<<rows, 32 * warps, 0, s>>>(c, ld, v, r0, k, w, i);
      break;
    default:
      row_topk_select<4><<<rows, 32 * warps, 0, s>>>(c, ld, v, r0, k, w, i);
      break;
  }
  return (int)cudaGetLastError();
}
