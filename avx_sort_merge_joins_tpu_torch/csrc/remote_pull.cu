// K11: the remote-pull push and chunk-gated merge, for every shard of a
// mesh on one card in one launch.  Shard me holds n buckets of `cap` slots
// (bucket d at bflat[me][d * cap], the _slice_buckets layout); it pushes
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
//   tickets [P, P + T)  merge tiles of kTile output keys, tile t of shard
//                       d at ticket P + t * n + d.  Tile t with output
//                       boundary b1 = min((t + 1) * kTile, total) waits
//                       for chunks [0, ceil(min(len_r, b1) / chunk)) of
//                       every strip r: its co-rank searches probe strip r
//                       only inside [0, min(len_r, b1)) (the counts are
//                       clamped there, which leaves the co-ranks as they
//                       are: no strip gives more than b1 keys to the first
//                       b1), and its merge reads inside them.  Then K9's
//                       tile (merge_tile.cuh): co-ranks by a binary
//                       search over the key domain (ties to the lower
//                       strip), the tile's segments merged in shared
//                       memory by rank-scatter.
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
// the landing through merge_tile.cuh with SmjPlainLoad.  Flags, ticket
// counter and status words are zeroed by the entry point before every
// launch, on the launch's stream.  Every push counts itself done in a
// progress word; a wait during which no push completes for kSpinLimitNs
// sets an error word, every CTA then stops, and the wrapper raises.  A
// long wait that sees pushes land (window 1 at a large shape: a chain of
// every push of a shard) is not an error.
//
// What bounds it on the H100: the buckets read and the landing written
// once (8 B a slot), the live keys read and every merged slot written
// once; the merge costs K9's (n - 1) * log2(kTile / n) shared-memory steps
// a key and two co-rank searches a tile.  This first version moves every
// chunk, live or not, as the TPU kernel does.  Offsets are 64-bit.
#include "merge_tile.cuh"

namespace {

constexpr int kTile = 4096;  // output keys per merge tile, K9's
constexpr int kThreads = 256;
// CTAs an SM keeps resident: at most 40 registers a thread.  The merge
// tiles are latency-bound (their co-rank searches), so residency is speed:
// left free, ptxas took 57 registers (4 CTAs an SM) and K11 ran 23% slower
// on an H100 at the 128M join's shapes.
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
  int n;
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

struct Shared {
  int buf[kTile];
  long long lim[kMaxShards];  // strip r's readable prefix for this tile
  long long c0[kMaxShards], c1[kMaxShards];
  long long offs[kMaxShards + 1];
  long long ticket, total;
  int stop;   // the loop's: no ticket left, or some CTA failed
  int abort;  // the item's: a wait of this CTA failed
  int bad;    // a count outside [0, cap]
};

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

// Merge tile t of shard d.  False if a wait failed.
__device__ bool merge_tile(const Args& a, Shared& sh, long long x) {
  const int d = (int)(x % a.n);
  const long long t = x / a.n;
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
  const long long t0 = t * kTile;
  const long long b1 = t0 + kTile < total ? t0 + kTile : total;
  int* out = a.merged + (long long)d * a.row;
  long long n_out = 0;
  if (t0 < total) {
    for (int r = tid; r < a.n; r += blockDim.x) {
      const long long l = lens[r];
      sh.lim[r] = l < b1 ? l : b1;
    }
    __syncthreads();
    // wait for the chunks this tile reads: [0, ceil(lim[r] / chunk))
    bool ok = true;
    for (int r = 0; r < a.n && ok; ++r) {
      const long long need = (sh.lim[r] + a.chunk - 1) / a.chunk;
      for (long long j = tid; j < need && ok; j += blockDim.x)
        ok = wait_flag(flag_of(a, d, r, j), a.scratch);
    }
    if (!ok) sh.abort = 1;
    __syncthreads();
    if (sh.abort) return false;
    for (int r = tid; r < a.n; r += blockDim.x)
      atomicMax(a.stats + (long long)d * a.n + r,
                (int)((sh.lim[r] + a.chunk - 1) / a.chunk));
    const int* land = a.landing + (long long)d * a.row;
    const auto lim = [&](int r) { return sh.lim[r]; };
    if (warp == 0)
      smj_corank(SmjPlainLoad(), land, lim, sh.c0, t0, total, a.cap, a.n,
                 lane);
    else if (warp == 1)
      smj_corank(SmjPlainLoad(), land, lim, sh.c1, b1, total, a.cap, a.n,
                 lane);
    __syncthreads();
    if (tid == 0) {
      int viol = 0;
      sh.offs[0] = 0;
      for (int r = 0; r < a.n; ++r) {
        // a read past the waited prefix [0, lim[r]) is a violation
        if (sh.c1[r] > sh.lim[r] || sh.c0[r] > sh.c1[r]) viol = 1;
        sh.offs[r + 1] = sh.offs[r] + sh.c1[r] - sh.c0[r];
      }
      if (viol || sh.offs[a.n] != b1 - t0) {
        atomicOr(a.stats + (long long)a.n * a.n + d, 1);
        sh.offs[a.n] = 0;  // merge nothing: the wrapper's caller raises
        for (int r = 1; r < a.n; ++r) sh.offs[r] = 0;
      }
    }
    __syncthreads();
    n_out = sh.offs[a.n];
    smj_merge_tile(SmjPlainLoad(), land, sh.c0, sh.offs, sh.buf, out + t0,
                   a.cap, a.n);
  }
  const long long end = t0 + kTile < a.row ? t0 + kTile : a.row;
  for (long long s = t0 + n_out + tid; s < end; s += blockDim.x)
    out[s] = SMJ_KEY_POS_INF;
  return true;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    remote_pull_kernel(Args a) {
  __shared__ Shared sh;
  const long long tickets = a.pushes + (long long)a.n * a.tiles;
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
                                 : merge_tile(a, sh, x - a.pushes);
    if (!ok) return;
  }
}

}  // namespace

// bflat, landing, merged: int32[n][n * cap]; counts: int32[n][n], the
// received counts; stats: int32[n * n + n], waited then violation;
// scratch: int32[kScratchHead + n * n * (cap / chunk)], zeroed here, its
// words 2 and 3 the error and oversize words the wrapper reads after the
// launch.  n a
// power of two in [2, kMaxShards], cap a multiple of chunk, window >= 1.
SMJ_API int smj_remote_pull(int* bflat, int* counts, int* landing,
                            int* merged, int* stats, int* scratch,
                            long long cap, long long chunk, int n,
                            long long window, void* stream) {
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
  a.pushes = (long long)n * n * a.chunks;
  a.n = n;
  a.window = window;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (kScratchHead + (size_t)n * n * a.chunks) * sizeof(int), s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(stats, 0, ((size_t)n * n + n) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, remote_pull_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long long tickets = a.pushes + (long long)n * a.tiles;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tickets) grid = tickets;
  remote_pull_kernel<<<(unsigned)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
