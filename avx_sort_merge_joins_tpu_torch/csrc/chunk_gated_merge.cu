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
// Design: the varlen K2 (multiway_merge.cu, on merge_path.cuh) as one
// group of W runs, its merge-path tiles of smj_mp::kTile = 4,096 outputs,
// with the gate between its co-rank search and its tile merge:
//   1. K2's coarse and fine co-rank passes: c[t][r], strip r's consumed
//      prefix at every tile boundary b = min(t * kTile, total), ties to
//      the lower strip.
//   2. gate_kernel, one CTA: tile t needs need_r(t) = ceil(c[t+1][r] /
//      chunk) chunks of strip r (the arithmetic of remote_fifo's
//      leaf_wait_chunk), is ready at ready(t) = max_r arrive[r][need_r - 1]
//      and merges at round rho(t) = max(rho(t - 1) + 1, ready(t)): the
//      emulated stall.  That recurrence is t + max(0, max_{s<=t} (ready(s)
//      - s)), a prefix max, scanned by the block.  violation is set if
//      some need_r(t) exceeds the chunks delivered by rho(t), that is if
//      some arrive[r][need_r - 1], so ready(t), exceeds rho(t) (the rows
//      are non-decreasing); waited[r] = max_t need_r(t).
//   3. K2's tile merge, one CTA a tile: the tile's W segments loaded
//      coalesced into shared memory and merged in log2(W) pairwise
//      merge-path rounds; pads from the live total up to cap.
// What bounds it on the H100: each live key is read and written once (8 B)
// and each slot of the output column written once; the merge is bound by
// shared memory and issue, the co-rank search by dependent loads, and the
// gate by its one CTA's dependent loads (a few per tile and strip).
#include "merge_path.cuh"

// The varlen K2 (multiway_merge.cu).
SMJ_API int smj_multiway_merge_varlen(const int* in_k, const int* in_p,
                                      int* out_k, int* out_p,
                                      long long* scratch,
                                      long long scratch_elems, long long cap,
                                      const int* lens, long long nruns,
                                      long long stride, int fanin, int tile,
                                      int parts, void* stream);

namespace {

using smj_mp::kTile;  // outputs a merge tile
constexpr int kGateThreads = 1024;
constexpr int kMaxW = 1024;
constexpr int kBatch = 8;  // strips whose loads the gate overlaps

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

__device__ __forceinline__ long long chunks_needed(long long consumed,
                                                   long long chunk) {
  return (consumed + chunk - 1) / chunk;
}

// The emulated arrival schedule over the live tiles: waited[W] and the
// violation flag into stats[0 .. W].  One CTA of kGateThreads threads, a
// tile a thread each round.
__global__ void __launch_bounds__(kGateThreads)
gate_kernel(const int* __restrict__ lens, const int* __restrict__ arrive,
            const long long* __restrict__ corank, int* __restrict__ stats,
            long long stride, long long chunk, int W, int max_chunks) {
  __shared__ int s_waited[kMaxW];
  __shared__ long long s_warp[kGateThreads / 32];
  __shared__ long long s_total;
  __shared__ int s_viol;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kGateThreads / 32;
  for (int r = tid; r < W; r += kGateThreads) s_waited[r] = 0;
  if (warp == 0) {
    long long total = 0;
    for (int r = lane; r < W; r += 32) total += strip_len(lens, r, stride);
    total = smj_mp::group_sum(total, 32);
    if (lane == 0) {
      s_total = total;
      s_viol = 0;
    }
  }
  __syncthreads();
  const long long ntiles = (s_total + kTile - 1) / kTile;
  long long carry = 0;  // rho(t) = t + max(0, prefix max of ready(s) - s)
  for (long long base = 0; base < ntiles; base += kGateThreads) {
    const long long t = base + tid;
    const bool live = t < ntiles;
    const long long* next = corank + (t + 1) * W;
    // ready(t), kBatch strips at a time: their co-ranks loaded together,
    // then their arrival rounds, so that the loads of a batch overlap
    long long ready = 0;
    for (int r0 = 0; r0 < W; r0 += kBatch) {
      long long need[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        need[u] = live && r0 + u < W ? chunks_needed(next[r0 + u], chunk)
                                     : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (need[u] > 0) {
          const long long a =
              __ldg(arrive + (long long)(r0 + u) * max_chunks + need[u] - 1);
          if (a > ready) ready = a;
        }
        // waited: the warp's largest need, one shared atomic a warp
        const unsigned m = __reduce_max_sync(0xffffffffu, (unsigned)need[u]);
        if (lane == 0 && m > 0) atomicMax(&s_waited[r0 + u], (int)m);
      }
    }
    // block-wide inclusive prefix max of ready(t) - t
    long long incl = warp_inclusive_max(live ? ready - t : LLONG_MIN, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const long long w = warp_inclusive_max(s_warp[lane], lane);
      s_warp[lane] = w;
    }
    __syncthreads();
    if (warp > 0 && s_warp[warp - 1] > incl) incl = s_warp[warp - 1];
    const long long pm = incl > carry ? incl : carry;
    const long long rho = t + (pm > 0 ? pm : 0);
    // some strip's chunk need_r - 1 is not delivered by round rho: some
    // arrive[r][need_r - 1] > rho, that is ready(t) > rho
    if (live && ready > rho) s_viol = 1;
    if (s_warp[kWarps - 1] > carry) carry = s_warp[kWarps - 1];
    __syncthreads();  // before the next round overwrites s_warp
  }
  __syncthreads();
  for (int r = tid; r < W; r += kGateThreads) stats[r] = s_waited[r];
  if (tid == 0) stats[W] = s_viol;
}

}  // namespace

// The output tile of the merge: the plain version gates with the same
// tiles.
SMJ_API int smj_chunk_gated_merge_tile(void) { return kTile; }

// landing: W strips of `stride` slots (landing holds >= W * stride);
// lens: int32[W] on the card; arrive: int32[W][max_chunks], rows
// non-decreasing; out: int32[cap]; corank: int64 scratch of corank_elems
// >= smj_multiway_merge_scratch(1, stride, W, kTile); stats: int32[W + 1],
// waited then the violation flag.  W a power of two in [2, kMaxW];
// stride / chunk <= max_chunks.  parts is 15; a mask of 1 (coarse
// co-ranks), 2 (fine co-ranks), 8 (the gate) and 4 (the tile merge) runs
// only those launches, on the co-ranks corank holds, for timing each.
SMJ_API int smj_chunk_gated_merge(const int* landing, const int* lens,
                                  const int* arrive, int* out,
                                  long long* corank, long long corank_elems,
                                  int* stats, long long cap, long long stride,
                                  long long chunk, int W, int max_chunks,
                                  int parts, void* stream) {
  if (W < 2 || W > kMaxW || (W & (W - 1)) != 0 || chunk < 1 ||
      cap < (long long)W * stride || parts < 1 || parts > 15)
    return (int)cudaErrorInvalidValue;
  if ((parts & 3) != 0) {
    const int err = smj_multiway_merge_varlen(
        landing, nullptr, out, nullptr, corank, corank_elems, cap, lens, W,
        stride, W, kTile, parts & 3, stream);
    if (err != (int)cudaSuccess) return err;
  }
  if ((parts & 8) != 0)
    gate_kernel<<<1, kGateThreads, 0, (cudaStream_t)stream>>>(
        lens, arrive, corank, stats, stride, chunk, W, max_chunks);
  if ((parts & 4) != 0)
    return smj_multiway_merge_varlen(landing, nullptr, out, nullptr, corank,
                                     corank_elems, cap, lens, W, stride, W,
                                     kTile, 4, stream);
  return (int)cudaGetLastError();
}
