// K9: the chunk-gated receiver merge.  W ascending strips of a landing
// buffer (strip r at r * stride, lens[r] live keys) merge into one
// ascending column, as if each strip's data arrived chunk by chunk: chunk j
// of strip r becomes readable at the merge round arrive[r][j].  Returns the
// merged column (INT32_MAX past the live total), the chunks each strip's
// reader had to wait for, and a flag that is set if the merge would have
// read a chunk before its round.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/parallel/remote_fifo.py
// `chunk_gated_merge` -> ops/multiwaymerge.py `_mwaymerge_kernel` with
// gate="emulated" (gating at :178-234, :284-288, :480-499), which runs the
// W-leaf FIFO heap tree of K2 in one program and lets a leaf fire only
// once its delivered prefix holds a full window.  The TPU's SMEM budget
// (W * max_chunks <= 512) and its round numbers (FIFO warm-up, + log2 W +
// 2) belong to that schedule and are not carried over; the chunk size,
// and with it the wait counters, stays the caller's.
//
// Design: merge-path tiles of kTile output keys, three launches; the
// co-rank search and the tile merge are merge_tile.cuh's.
//   1. corank_kernel, one warp per tile boundary b = min(t * kTile,
//      total): a binary search over the key domain finds v, the key at
//      merged position b - 1, and each strip contributes its keys < v,
//      then keys == v in strip order up to b (ties go to the lower strip,
//      as K2's do).  c[t][r] is strip r's consumed prefix at boundary t.
//   2. gate_kernel, one CTA: tile t needs need_r(t) = ceil(c[t+1][r] /
//      chunk) chunks of strip r (the arithmetic of remote_fifo's
//      leaf_wait_chunk), is ready at ready(t) = max_r arrive[r][need_r - 1]
//      and merges at round rho(t) = max(rho(t - 1) + 1, ready(t)): the
//      emulated stall.  That recurrence is t + max(0, max_{s<=t} (ready(s)
//      - s)), a prefix max, scanned by the block.  violation is set if
//      some need_r(t) exceeds the chunks delivered by rho(t); waited[r] =
//      max_t need_r(t).
//   3. merge_kernel, one CTA per tile: the tile's W segments [c[t][r],
//      c[t+1][r]) are copied into shared memory, and each key's slot is its
//      index plus its bounds in the tile's other segments (K2's
//      rank-scatter, in shared memory).  Tiles past the live total write
//      pads.
// What bounds it on the H100: each live key is read and written once (8 B)
// and each slot of the output column written once, but the rank-scatter
// costs (W - 1) * log2(kTile / W) shared-memory steps a key, and the
// co-rank search 32 * W * log2(len) dependent loads per tile boundary.
// Offsets are 64-bit.
#include "merge_tile.cuh"

namespace {

constexpr int kTile = 4096;  // output keys per merge tile (16 KB of keys)
constexpr int kMergeThreads = 256;
constexpr int kCorankThreads = 256;
constexpr int kGateThreads = 1024;
constexpr int kMaxW = 1024;

__device__ __forceinline__ long long strip_len(const int* __restrict__ lens,
                                               int r, long long stride) {
  const long long l = __ldg(lens + r);
  return l < 0 ? 0 : (l > stride ? stride : l);
}

__device__ __forceinline__ long long warp_inclusive_max(long long v,
                                                        int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o && n > v) v = n;
  }
  return v;
}

// c[t][r] for every tile boundary t in [0, nbounds): one warp a boundary,
// the lanes covering strips lane, lane + 32, ...
__global__ void corank_kernel(const int* __restrict__ landing,
                              const int* __restrict__ lens,
                              long long* __restrict__ corank,
                              long long nbounds, long long stride, int W) {
  const long long t =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= nbounds) return;  // t is the same for the whole warp
  long long total = 0;
  for (int r = lane; r < W; r += 32) total += strip_len(lens, r, stride);
  total = smj_warp_sum(total);
  const long long b = t * kTile < total ? t * kTile : total;
  smj_corank(SmjLdgLoad(), landing,
             [&](int r) { return strip_len(lens, r, stride); },
             corank + t * W, b, total, stride, W, lane);
}

__device__ __forceinline__ long long chunks_needed(long long consumed,
                                                   long long chunk) {
  return (consumed + chunk - 1) / chunk;
}

// The emulated arrival schedule over the live tiles: waited[W] and the
// violation flag into stats[0 .. W].  One CTA of kGateThreads threads.
__global__ void gate_kernel(const int* __restrict__ lens,
                            const int* __restrict__ arrive,
                            const long long* __restrict__ corank,
                            int* __restrict__ stats, long long stride,
                            long long chunk, int W, int max_chunks) {
  __shared__ int s_waited[kMaxW];
  __shared__ long long s_warp[kGateThreads / 32];
  __shared__ long long s_total, s_carry;
  __shared__ int s_viol;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < W; r += blockDim.x) s_waited[r] = 0;
  if (tid == 0) {
    long long total = 0;
    for (int r = 0; r < W; ++r) total += strip_len(lens, r, stride);
    s_total = total;
    s_carry = 0;  // rho(t) = t + max(0, prefix max of ready(s) - s)
    s_viol = 0;
  }
  __syncthreads();
  const long long ntiles = (s_total + kTile - 1) / kTile;
  for (long long base = 0; base < ntiles; base += blockDim.x) {
    const long long t = base + tid;
    const bool live = t < ntiles;
    const long long* next = corank + (t + 1) * W;
    long long key = LLONG_MIN;
    if (live) {
      long long ready = 0;
      for (int r = 0; r < W; ++r) {
        const long long need = chunks_needed(next[r], chunk);
        if (need > 0) {
          const long long a = arrive[(long long)r * max_chunks + need - 1];
          if (a > ready) ready = a;
        }
      }
      key = ready - t;
    }
    // block-wide inclusive prefix max of key
    long long incl = warp_inclusive_max(key, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x / 32;
      long long w = lane < nw ? s_warp[lane] : LLONG_MIN;
      w = warp_inclusive_max(w, lane);
      if (lane < nw) s_warp[lane] = w;
    }
    __syncthreads();
    if (warp > 0 && s_warp[warp - 1] > incl) incl = s_warp[warp - 1];
    const long long carry = s_carry;
    const long long pm = incl > carry ? incl : carry;
    if (live) {
      const long long rho = t + (pm > 0 ? pm : 0);
      for (int r = 0; r < W; ++r) {
        const long long need = chunks_needed(next[r], chunk);
        // chunks of strip r delivered by round rho (rows non-decreasing)
        const int* row = arrive + (long long)r * max_chunks;
        int lo = 0, hi = max_chunks;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((long long)row[mid] <= rho) lo = mid + 1; else hi = mid;
        }
        if (need > lo) s_viol = 1;
        atomicMax(&s_waited[r], (int)need);
      }
    }
    __syncthreads();
    if (tid == 0) {
      const long long blockmax = s_warp[blockDim.x / 32 - 1];
      if (blockmax > s_carry) s_carry = blockmax;
    }
    __syncthreads();
  }
  for (int r = tid; r < W; r += blockDim.x) stats[r] = s_waited[r];
  if (tid == 0) stats[W] = s_viol;
}

__global__ void merge_kernel(const int* __restrict__ landing,
                             const int* __restrict__ lens,
                             const long long* __restrict__ corank,
                             int* __restrict__ out, long long cap,
                             long long stride, int W) {
  __shared__ int buf[kTile];
  __shared__ long long offs[kMaxW + 1];
  __shared__ long long s_total;
  const long long t = blockIdx.x;
  const long long t0 = t * kTile;
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int r = 0; r < W; ++r) total += strip_len(lens, r, stride);
    s_total = total;
  }
  __syncthreads();
  long long n = 0;
  if (t0 < s_total) {
    const long long* cur = corank + t * W;
    const long long* next = cur + W;
    if (threadIdx.x == 0) {
      offs[0] = 0;
      for (int r = 0; r < W; ++r) offs[r + 1] = offs[r] + next[r] - cur[r];
    }
    __syncthreads();
    n = offs[W];
    smj_merge_tile(SmjLdgLoad(), landing, cur, offs, buf, out + t0, stride,
                   W);
  }
  const long long end = t0 + kTile < cap ? t0 + kTile : cap;
  for (long long s = t0 + n + threadIdx.x; s < end; s += blockDim.x)
    out[s] = SMJ_KEY_POS_INF;
}

}  // namespace

// The output tile of the merge: the wrapper sizes the co-rank scratch with
// it, and the plain version gates with the same tiles.
SMJ_API int smj_chunk_gated_merge_tile(void) { return kTile; }

// landing: W strips of `stride` slots (landing holds >= W * stride);
// lens: int32[W] on the card; arrive: int32[W][max_chunks], rows
// non-decreasing; out: int32[cap]; corank: int64 scratch of
// (cdiv(W * stride, kTile) + 1) * W; stats: int32[W + 1], waited then the
// violation flag.  2 <= W <= kMaxW; stride / chunk <= max_chunks.
SMJ_API int smj_chunk_gated_merge(const int* landing, const int* lens,
                                  const int* arrive, int* out,
                                  long long* corank, int* stats,
                                  long long cap, long long stride,
                                  long long chunk, int W, int max_chunks,
                                  void* stream) {
  if (W < 2 || W > kMaxW || chunk < 1 || cap < (long long)W * stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nbounds = ((long long)W * stride + kTile - 1) / kTile + 1;
  const long long warps_per_block = kCorankThreads / 32;
  const long long cblocks = (nbounds + warps_per_block - 1) / warps_per_block;
  const long long mblocks = (cap + kTile - 1) / kTile;
  if (cblocks > INT_MAX || mblocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  corank_kernel<<<(unsigned)cblocks, kCorankThreads, 0, s>>>(
      landing, lens, corank, nbounds, stride, W);
  gate_kernel<<<1, kGateThreads, 0, s>>>(lens, arrive, corank, stats, stride,
                                         chunk, W, max_chunks);
  if (mblocks > 0)
    merge_kernel<<<(unsigned)mblocks, kMergeThreads, 0, s>>>(
        landing, lens, corank, out, cap, stride, W);
  return (int)cudaGetLastError();
}
