// K11: the remote-pull push and chunk-gated merge, for every shard of a
// mesh on one card in one launch.  Shard me holds n buckets of `cap` slots
// (bucket d at bflat[me][d * cap], the dist_mway._cut_all layout); it pushes
// them chunk by chunk into its peers' landing strips (strip me of shard d
// at landing[d][me * cap]), and each shard merges its n strips into one
// ascending column while they arrive, each merge tile waiting for the
// (source, chunk) arrivals it reads.  Returns the landing (the all-to-all
// of the buckets), the merged columns (INT32_MAX past each live total), the
// chunks each shard's reader waited for per strip, and a flag per shard
// that is set if a tile read past the chunks it had waited for.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/parallel/remote_fifo.py
// `_remote_pull_kernel` (:272) + ops/multiwaymerge.py `_mwaymerge_kernel`
// with gate="remote", via `remote_pull_exchange_merge` (pallas_call at
// :388).  There each chip pushes with make_async_remote_copy and its merge
// waits on one receive semaphore per (source, chunk).  On one card a push
// is a device-side copy into the destination shard's landing strip and a
// receive semaphore is a flag in global memory, one per (destination,
// source, chunk).
//
// Work items come from one atomic ticket counter, not from blockIdx:
//   tickets [0, P)      pushes, P = n * n * chunks: ticket p is push
//                       i = p / n of shard me = p % n (the shards
//                       interleaved); push i sends chunk j = i / n of the
//                       bucket for (me + i % n) % n -- the JAX walk,
//                       chunk-major in NEXT order, full chunks.  Push i
//                       first waits for the flag of the same shard's push
//                       i - K (the JAX send window, K = window).
//   tickets [P, P + T)  merge groups of `span` tiles of kTile output
//                       keys (span = 7 up to 64 shards, fewer above: see
//                       group_span), group g of shard d at ticket P + g *
//                       n + d.  A group whose last boundary is b_last =
//                       min(end * kTile, total) waits for chunks [0,
//                       ceil(min(len_r, b_last) / chunk)) of every strip
//                       r: its co-rank searches probe strip r only inside
//                       [0, min(len_r, b_last)) (which leaves the co-ranks
//                       as they are: no strip gives more than b_last keys
//                       to the first b_last), and its merges read inside
//                       them.  Then the merge-path tile of K2
//                       (merge_path.cuh): span + 1 warps search the
//                       group's span + 1 boundaries at once (windows
//                       narrowed with the value of output b - 1, 32 / n + 1
//                       probes a round, ties to the lower strip, the
//                       windows in registers up to 32 shards and in shared
//                       memory above), and the CTA merges each
//                       tile's n segments in log2(n) pairwise merge-path
//                       rounds between two shared buffers, then writes it
//                       back coalesced, pads after the live total.  The
//                       searches are chains of dependent loads (latency):
//                       one warp a boundary lets a CTA cover a group with
//                       the latency of one search.
// Why it cannot deadlock, whatever order the hardware schedules CTAs in: a
// CTA takes a ticket only while it runs, and waits only on work of lower
// tickets.  A lower ticket was taken by a CTA that is running or has
// finished, so the lowest unfinished ticket never waits and the work
// always moves on.  (A plain launch with the producers "first" would not
// be safe: the order in which CTAs start is not guaranteed.)
//
// Memory order.  A push copies its chunk with the whole CTA, meets at a
// barrier, and one thread fences and release-stores the flag.  A waiting
// thread polls with relaxed loads (sleeping between polls) and, once the
// flag is set, reads it once more with an acquire load; a barrier then
// hands the ordering to the CTA.  The landing is written during the
// launch, so no read of it may take the non-coherent read-only path: this
// kernel has no `const __restrict__` pointer and no __ldg, and it reads
// the landing through merge_path.cuh with SmjPlainLoad.  Flags, ticket
// counter and status words are zeroed by the entry point before every
// launch, on the launch's stream.  Every push counts itself done in a
// progress word; a wait during which no push completes for kSpinLimitNs
// sets an error word, every CTA then stops, and the wrapper raises.  A
// long wait that sees pushes land (window 1 at a large shape: a chain of
// every push of a shard) is not an error.
//
// What bounds it on the H100: the buckets read and the landing written
// once (8 B a slot), the live keys read and every merged slot written
// once; the merge costs log2(n) shared-memory passes a key and a little
// more than one co-rank search a tile (dependent loads).  Every chunk
// moves, live or not, as the TPU kernel does.  Offsets are 64-bit.
//
// Shared memory: two tile buffers of 4,096 keys (one spare slot every 128
// B), the group's co-ranks and the strips' limits, starts and offsets,
// sized by n (dynamic: 34,468 B at n = 8, 6 CTAs an SM); the searches'
// windows lie in the second buffer, which the merge writes after them.
#include "merge_path.cuh"

namespace {

using smj_mp::kTile;  // output keys a merge tile
constexpr int kThreads = 256;
// CTAs an SM keeps resident: at most 40 registers a thread.  The merge
// tiles are latency-bound (their co-rank searches), so residency is speed:
// left free, ptxas took 57 registers (4 CTAs an SM) and the K11 of K9's
// tiles ran 23% slower on an H100 at the 128M join's shapes.
constexpr int kBlocksPerSm = 6;
constexpr int kMaxShards = 256;  // remote_fifo.PULL_MAX_SHARDS
// the longest a wait goes on while no push completes: 1 s
constexpr unsigned long long kSpinLimitNs = 1000000000ull;
// scratch: [0, 2) the ticket counter (64-bit), [2] the error word, [3]
// the oversize word, [4] the pushes done, then the flags, (destination,
// source, chunk)-major.
constexpr int kScratchHead = 5;  // remote_fifo._PULL_SCRATCH_HEAD
constexpr int kErrorWord = 2;
constexpr int kOversizeWord = 3;
constexpr int kProgressWord = 4;
constexpr int kErrSpinLimit = 1;

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Args {
  int* bflat;     // (n, n * cap): bucket d of shard me at [me][d * cap]
  int* counts;    // (n, n) int32: strip r of shard d holds counts[d][r]
  int* landing;   // (n, n * cap): strip me of shard d at [d][me * cap]
  int* merged;    // (n, n * cap)
  int* stats;     // waited (n, n), then violation (n)
  int* scratch;   // see kScratchHead
  long long cap, chunk, chunks, row, tiles, pushes, window;
  long long groups;  // tile groups a shard: ceil(tiles / span)
  int n;
  int span;  // tiles a group: as many as one search warp each (+1) allows
};

// Wait until *flag is set; acquire.  False if no push completed for
// kSpinLimitNs of the wait (the error word then says so) or another CTA
// has already failed.
__device__ bool wait_flag(const int* flag, int* scratch) {
  if (ld_relaxed(flag)) {
    (void)ld_acquire(flag);
    return true;
  }
  unsigned long long t0 = now_ns();
  int done = ld_relaxed(scratch + kProgressWord);
  unsigned ns = 32;
  for (;;) {
    if (ld_relaxed(flag)) {
      (void)ld_acquire(flag);
      return true;
    }
    if (ld_relaxed(scratch + kErrorWord)) return false;
    if (now_ns() - t0 > kSpinLimitNs) {
      const int now_done = ld_relaxed(scratch + kProgressWord);
      if (now_done == done) {
        atomicCAS(scratch + kErrorWord, 0, kErrSpinLimit);
        return false;
      }
      done = now_done;  // pushes landed meanwhile: start the limit again
      t0 = now_ns();
    }
    __nanosleep(ns);
    if (ns < 2048) ns <<= 1;
  }
}

__device__ __forceinline__ int* flag_of(const Args& a, int dst, int src,
                                        long long j) {
  return a.scratch + kScratchHead +
         ((long long)dst * a.n + src) * a.chunks + j;
}

// The CTA's scalars; the tile's buffers and per-strip arrays are dynamic
// shared memory (Tile).
struct Shared {
  long long ticket, total;
  int stop;   // the loop's: no ticket left, or some CTA failed
  int abort;  // the item's: a wait of this CTA failed
  int bad;    // a count outside [0, cap]
};

// Dynamic shared memory of a tile group over n strips: the two buffers,
// then c (int64, span + 1 boundaries of n), src and lim (int64, n each)
// and offs (int, n + 1).  The searches' windows lie in the second buffer,
// which the merge writes only after them.
struct Tile {
  int* buf0;
  int* buf1;
  long long* c;    // c[i * n + r]: strip r's co-rank at the group's bound i
  long long* src;  // the tile's segments' starts in the landing row
  long long* lim;  // strip r's readable prefix for this group
  int* offs;       // the segments' offsets in the tile

  __device__ Tile(unsigned char* smem, int n, int span) {
    buf0 = reinterpret_cast<int*>(smem);
    buf1 = buf0 + smj_mp::buf_elems<int>();
    c = reinterpret_cast<long long*>(buf1 + smj_mp::buf_elems<int>());
    src = c + (long long)(span + 1) * n;
    lim = src + n;
    offs = reinterpret_cast<int*>(lim + n);
  }
};

constexpr size_t kBufBytes = smj_mp::buf_elems<int>() * sizeof(int);

// Tiles a group over n strips: one search warp a boundary, at most the
// CTA's warps, their windows in the second buffer.
constexpr int group_span(int n) {
  const long long fit = kBufBytes / (smj_mp::corank_words(n) * 8);
  const long long warps = kThreads / 32;
  return (int)((fit < warps ? fit : warps) - 1);
}

constexpr size_t tile_smem(int n) {
  return 2 * kBufBytes + 8 * ((size_t)group_span(n) + 3) * n +
         4 * ((size_t)n + 1);
}

static_assert(group_span(kMaxShards) >= 1,
              "co-rank windows outgrow the tile buffer");

// Push i of shard me.  False if a wait failed.
__device__ bool push(const Args& a, Shared& sh, long long p) {
  const long long i = p / a.n;
  const int me = (int)(p % a.n);
  if (threadIdx.x == 0) {
    bool ok = true;
    if (i >= a.window) {  // the send window: push i - K has landed
      const long long w = i - a.window;
      ok = wait_flag(flag_of(a, (me + (int)(w % a.n)) % a.n, me, w / a.n),
                     a.scratch);
    }
    sh.abort = !ok;
  }
  __syncthreads();
  if (sh.abort) return false;
  const long long j = i / a.n;
  const int dst = (me + (int)(i % a.n)) % a.n;
  const int* src = a.bflat + (long long)me * a.row + (long long)dst * a.cap +
                   j * a.chunk;
  int* out = a.landing + (long long)dst * a.row + (long long)me * a.cap +
             j * a.chunk;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                   a.chunk % 4 == 0;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long k = threadIdx.x; k < a.chunk / 4; k += blockDim.x)
      o4[k] = s4[k];
  } else {
    for (long long k = threadIdx.x; k < a.chunk; k += blockDim.x)
      out[k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag_of(a, dst, me, j), 1);
    atomicAdd(a.scratch + kProgressWord, 1);
  }
  return true;
}

// Tile group g of shard d: tiles [g * span, (g + 1) * span).  False if a
// wait failed.
__device__ bool merge_group(const Args& a, Shared& sh, const Tile& tl,
                            long long x) {
  const int d = (int)(x % a.n);
  const long long g = x / a.n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* lens = a.counts + (long long)d * a.n;
  if (tid == 0) {
    long long total = 0;
    int bad = 0;
    for (int r = 0; r < a.n; ++r) {
      const int l = lens[r];
      if (l < 0 || l > a.cap) bad = 1;
      total += l;
    }
    if (bad) atomicOr(a.scratch + kOversizeWord, 1);
    sh.total = total;
    sh.bad = bad;
    sh.abort = 0;
  }
  __syncthreads();
  if (sh.bad) return true;  // the wrapper raises: no strip is read
  const long long total = sh.total;
  const long long t_first = g * a.span;
  const long long t_end =
      t_first + a.span < a.tiles ? t_first + a.span : a.tiles;
  // the group's boundaries: bound i at min((t_first + i) * kTile, total)
  const auto bound_of = [&](long long i) {
    const long long v = (t_first + i) * kTile;
    return v < total ? v : total;
  };
  const long long b_last = bound_of(t_end - t_first);
  int* out = a.merged + (long long)d * a.row;
  const smj_mp::Cols<SmjPlainLoad> land{a.landing + (long long)d * a.row,
                                        nullptr, SmjPlainLoad()};
  if (t_first * kTile < total) {
    for (int r = tid; r < a.n; r += blockDim.x) {
      const long long l = lens[r];
      tl.lim[r] = l < b_last ? l : b_last;
    }
    __syncthreads();
    // wait for the chunks this group reads: [0, ceil(lim[r] / chunk))
    bool ok = true;
    for (int r = 0; r < a.n && ok; ++r) {
      const long long need = (tl.lim[r] + a.chunk - 1) / a.chunk;
      for (long long j = tid; j < need && ok; j += blockDim.x)
        ok = wait_flag(flag_of(a, d, r, j), a.scratch);
    }
    if (!ok) sh.abort = 1;
    __syncthreads();
    if (sh.abort) return false;
    for (int r = tid; r < a.n; r += blockDim.x)
      atomicMax(a.stats + (long long)d * a.n + r,
                (int)((tl.lim[r] + a.chunk - 1) / a.chunk));
    // warp i searches bound i of the group, all at once, from the windows
    // [0, lim[r]): no strip gives more than b_last keys to any of them
    if (warp <= t_end - t_first) {
      long long* ws = reinterpret_cast<long long*>(tl.buf1) +
                      warp * smj_mp::corank_words(a.n);
      for (int r = lane; r < a.n; r += 32) {
        ws[r] = 0;
        ws[a.n + r] = tl.lim[r];
      }
      __syncwarp();
      long long* row = tl.c + (long long)warp * a.n;
      if (a.n <= 32)  // one strip a lane: the windows in registers
        smj_mp::corank<int, true>(land, 0, a.cap, a.n, bound_of(warp), ws,
                                  row, lane);
      else
        smj_mp::corank<int, false>(land, 0, a.cap, a.n, bound_of(warp), ws,
                                   row, lane);
    }
    __syncthreads();
  }
  for (long long t = t_first; t < t_end; ++t) {
    const long long t0 = t * kTile;
    long long n_out = 0;
    if (t0 < total) {  // the same for the whole CTA
      const long long* c0 = tl.c + (t - t_first) * a.n;
      const long long* c1 = c0 + a.n;
      if (tid == 0) {
        int viol = 0;
        tl.offs[0] = 0;
        for (int r = 0; r < a.n; ++r) {
          // a read past the waited prefix [0, lim[r]) is a violation
          if (c1[r] > tl.lim[r] || c0[r] > c1[r]) viol = 1;
          const long long o = tl.offs[r] + c1[r] - c0[r];
          tl.offs[r + 1] = (int)(o <= kTile ? o : kTile + 1);
          tl.src[r] = r * a.cap + c0[r];
        }
        const long long b1 = t0 + kTile < total ? t0 + kTile : total;
        if (viol || tl.offs[a.n] != b1 - t0) {
          atomicOr(a.stats + (long long)a.n * a.n + d, 1);
          for (int r = 1; r <= a.n; ++r) tl.offs[r] = 0;  // merge nothing
        }
      }
      __syncthreads();
      n_out = tl.offs[a.n];
      if (n_out > 0) {  // the same branch for the whole CTA
        const int* m = smj_mp::merge_tile<int, kThreads>(
            land, tl.src, tl.offs, a.n, tl.buf0, tl.buf1);
        for (int p = tid; p < n_out; p += kThreads)
          out[t0 + p] = m[smj_mp::sw<int>(p)];
      }
    }
    const long long end = t0 + kTile < a.row ? t0 + kTile : a.row;
    for (long long s = t0 + n_out + tid; s < end; s += blockDim.x)
      out[s] = SMJ_KEY_POS_INF;
    __syncthreads();  // the tile's buffers and offsets are free again
  }
  return true;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    remote_pull_kernel(Args a) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tl(smem, a.n, a.span);
  const long long tickets = a.pushes + (long long)a.n * a.groups;
  for (;;) {
    __syncthreads();  // the last item is done with the shared state
    if (threadIdx.x == 0) {
      sh.ticket = (long long)atomicAdd(
          reinterpret_cast<unsigned long long*>(a.scratch), 1ull);
      sh.stop = sh.ticket >= tickets ||
                ld_relaxed(a.scratch + kErrorWord) != 0;
    }
    __syncthreads();
    if (sh.stop) return;
    const long long x = sh.ticket;
    const bool ok = x < a.pushes ? push(a, sh, x)
                                 : merge_group(a, sh, tl, x - a.pushes);
    if (!ok) return;
  }
}

}  // namespace

// bflat, landing, merged: int32[n][n * cap]; counts: int32[n][n], the
// received counts; stats: int32[n * n + n], waited then violation;
// scratch: int32[kScratchHead + n * n * (cap / chunk)], zeroed here, its
// words 2 and 3 the error and oversize words the wrapper reads after the
// launch.  n a power of two in [2, kMaxShards], cap a multiple of chunk,
// window >= 1.  merge_only (for timing the merge alone): no push runs,
// every flag is set before the launch, and the merge reads the landing
// as the caller gives it (a full launch's).
SMJ_API int smj_remote_pull(int* bflat, int* counts, int* landing,
                            int* merged, int* stats, int* scratch,
                            long long cap, long long chunk, int n,
                            long long window, int merge_only, void* stream) {
  if (n < 2 || n > kMaxShards || (n & (n - 1)) || chunk < 1 || cap < 1 ||
      cap % chunk || window < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.bflat = bflat;
  a.counts = counts;
  a.landing = landing;
  a.merged = merged;
  a.stats = stats;
  a.scratch = scratch;
  a.cap = cap;
  a.chunk = chunk;
  a.chunks = cap / chunk;
  a.row = (long long)n * cap;
  a.tiles = (a.row + kTile - 1) / kTile;
  a.pushes = merge_only ? 0 : (long long)n * n * a.chunks;
  a.n = n;
  a.window = window;
  a.span = group_span(n);
  a.groups = (a.tiles + a.span - 1) / a.span;
  const size_t flags = (size_t)n * n * a.chunks * sizeof(int);
  cudaError_t e = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (e == cudaSuccess)  // a flag is set when it is not 0
    e = cudaMemsetAsync(scratch + kScratchHead, merge_only ? 1 : 0, flags,
                        s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(stats, 0, ((size_t)n * n + n) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = tile_smem(n);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(remote_pull_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, remote_pull_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tickets = a.pushes + (long long)n * a.groups;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tickets) grid = tickets;
  remote_pull_kernel<<<(unsigned)grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The CTAs an SM holds of remote_pull_kernel over n shards, into *ctas (a
// host int).
SMJ_API int smj_remote_pull_occupancy(int n, int* ctas) {
  if (n < 2 || n > kMaxShards) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      remote_pull_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, remote_pull_kernel, kThreads, tile_smem(n));
  return (int)e;
}
