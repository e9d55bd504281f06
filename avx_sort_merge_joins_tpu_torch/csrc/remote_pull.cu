// K11: the remote-pull push and chunk-gated merge of a mesh of n shards,
// one launch a card for the shards that card holds (all n on a mesh of one
// card).  Shard me holds n buckets of `cap` slots (bucket d at bflat_me[d *
// cap], the dist_mway._cut_all layout); it pushes them chunk by chunk into
// its peers' landing strips (strip me of shard d at landing_d[me * cap]),
// and each shard merges its n strips into one ascending column while they
// arrive, each merge tile waiting for the (source, chunk) arrivals it
// reads.  Returns the landing (the all-to-all of the buckets), the merged
// columns (INT32_MAX past each live total), the chunks each shard's reader
// waited for per strip, and a flag per shard that is set if a tile read
// past the chunks it had waited for.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/parallel/remote_fifo.py
// `_remote_pull_kernel` (:272) + ops/multiwaymerge.py `_mwaymerge_kernel`
// with gate="remote", via `remote_pull_exchange_merge` (pallas_call at
// :388).  There each chip pushes with make_async_remote_copy and its merge
// waits on one receive semaphore per (source, chunk).  Here a push is a
// copy into the destination shard's landing strip -- a peer write over
// NVLink when the destination lies on another card (every pointer is a
// unified virtual address, peer access enabled by the wrapper for every
// ordered pair of cards) -- and a receive semaphore is a flag in the
// receiver's memory, one per (destination, source, chunk).  Every shard's
// pointers come in a table (kTableWords a shard), so each launch reaches
// every shard on every card.
//
// Work items come from one atomic ticket counter a card, not from
// blockIdx; the card holds m of the n shards, local[0..m):
//   tickets [0, P)      pushes, P = m * n * chunks: ticket p is push
//                       i = p / m of shard me = local[p % m] (the shards
//                       interleaved); push i sends chunk j = i / n of the
//                       bucket for (me + i % n) % n -- the JAX walk,
//                       chunk-major in NEXT order, full chunks.  Push i
//                       first waits for the flag of the same shard's push
//                       i - K (the JAX send window, K = window).
//   tickets [P, P + T)  merge groups of `span` tiles of kTile output
//                       keys (span = 7 up to 64 shards, fewer above: see
//                       group_span), group g of shard local[l] at ticket P
//                       + g * m + l.  A group whose last boundary is b_last =
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
// CTA takes a ticket only while it runs, and waits only on pushes: a push
// on its own card's earlier pushes, a merge on any card's.  On one card a
// lower ticket was taken by a CTA that is running or has finished, so the
// lowest unfinished ticket never waits on its card and the card's pushes
// always move on; every card's pushes come before its merges, so every
// merge's pushes finish.  (A plain launch with the producers "first" would
// not be safe: the order in which CTAs start is not guaranteed.)  Across
// cards the wrapper starts every card's launch before it waits on any, and
// orders each launch after the work already queued on every card, so the
// launches run together and no card's pushes wait behind another's.
//
// Memory order, at system scope so that it holds across cards.  A push
// copies its chunk with the whole CTA, meets at a barrier, and one thread
// fences (__threadfence_system) and release-stores the flag in the
// receiver's memory.  A waiting thread polls with relaxed loads (sleeping
// between polls) and, once the flag is set, reads it once more with an
// acquire load; a barrier then hands the ordering to the CTA.  The landing
// is written during the launch, so no read of it may take the non-coherent
// read-only path: this kernel has no `const __restrict__` pointer and no
// __ldg, and it reads the landing through merge_path.cuh with
// SmjPlainLoad.  Flags, ticket counter and status words are zeroed (the
// flags set, for a merge-only launch) by the wrapper before every launch,
// on the launch's stream.  Every push counts itself done in its card's
// progress word; a wait during which no push of the awaited shard's card
// completes for kSpinLimitNs sets the card's error word, every CTA of the
// card then stops, and the wrapper raises.  A long wait that sees pushes
// land (window 1 at a large shape: a chain of every push of a shard) is
// not an error.
//
// What bounds it on the H100: the buckets read and the landing written
// once (8 B a slot), the live keys read and every merged slot written
// once; the merge costs log2(n) shared-memory passes a key and a little
// more than one co-rank search a tile (dependent loads).  Across cards the
// pushes to other cards cross NVLink (450 GB/s each way a card, against
// 3.35 TB/s of device memory).  Every chunk moves, live or not, as the TPU
// kernel does.  Offsets are 64-bit.
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
// A card's control words: [0, 2) the ticket counter (64-bit), [2] the
// error word, [3] the oversize word, [4] the pushes done.  Its flags follow
// them in the same buffer (the wrapper's scratch), flags of shard d at
// (source, chunk).
constexpr int kScratchHead = 5;  // remote_fifo._PULL_SCRATCH_HEAD
constexpr int kErrorWord = 2;
constexpr int kOversizeWord = 3;
constexpr int kProgressWord = 4;
constexpr int kErrSpinLimit = 1;
// A shard's row of the pointer table (remote_fifo._PULL_TABLE_WORDS): its
// buckets, received counts (int32[n]), landing, merged column, waits
// (int32[n]), violation flag, arrival flags (int32[n][chunks], source-
// major) and its card's control words.
constexpr int kTableWords = 8;
enum Slot { kBflat, kCounts, kLanding, kMerged, kWaited, kViolation,
            kFlags, kCtl };

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Args {
  // n rows of kTableWords pointers (Slot), then the m shards of this card
  const long long* table;
  int* ctl;  // this card's control words
  long long cap, chunk, chunks, row, tiles, pushes, window;
  long long groups;  // tile groups a shard: ceil(tiles / span)
  int n;
  int m;     // the shards of this card
  int span;  // tiles a group: as many as one search warp each (+1) allows
};

// Shard s's pointer in `slot`.
__device__ __forceinline__ int* ptr(const Args& a, int s, Slot slot) {
  return reinterpret_cast<int*>(a.table[(long long)s * kTableWords + slot]);
}

// The l-th shard of this card.
__device__ __forceinline__ int local_shard(const Args& a, long long l) {
  return (int)a.table[(long long)a.n * kTableWords + l];
}

// Wait until *flag is set; acquire.  False if no push of the awaited
// shard's card (its progress word) completed for kSpinLimitNs of the wait
// (this card's error word then says so) or another CTA of this card has
// already failed.
__device__ bool wait_flag(const int* flag, const int* progress, int* ctl) {
  if (ld_relaxed(flag)) {
    (void)ld_acquire(flag);
    return true;
  }
  unsigned long long t0 = now_ns();
  int done = ld_relaxed(progress);
  unsigned ns = 32;
  for (;;) {
    if (ld_relaxed(flag)) {
      (void)ld_acquire(flag);
      return true;
    }
    if (ld_relaxed(ctl + kErrorWord)) return false;
    if (now_ns() - t0 > kSpinLimitNs) {
      const int now_done = ld_relaxed(progress);
      if (now_done == done) {
        atomicCAS(ctl + kErrorWord, 0, kErrSpinLimit);
        return false;
      }
      done = now_done;  // pushes landed meanwhile: start the limit again
      t0 = now_ns();
    }
    __nanosleep(ns);
    if (ns < 2048) ns <<= 1;
  }
}

// The arrival flag of chunk j from shard src, in receiver dst's memory.
__device__ __forceinline__ int* flag_of(const Args& a, int dst, int src,
                                        long long j) {
  return ptr(a, dst, kFlags) + (long long)src * a.chunks + j;
}

// Wait for the arrival flag of chunk j from src at dst.
__device__ __forceinline__ bool wait_arrival(const Args& a, int dst, int src,
                                             long long j) {
  return wait_flag(flag_of(a, dst, src, j),
                   ptr(a, src, kCtl) + kProgressWord, a.ctl);
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
  const long long i = p / a.m;
  const int me = local_shard(a, p % a.m);
  if (threadIdx.x == 0) {
    bool ok = true;
    if (i >= a.window) {  // the send window: push i - K has landed
      const long long w = i - a.window;
      ok = wait_arrival(a, (me + (int)(w % a.n)) % a.n, me, w / a.n);
    }
    sh.abort = !ok;
  }
  __syncthreads();
  if (sh.abort) return false;
  const long long j = i / a.n;
  const int dst = (me + (int)(i % a.n)) % a.n;
  const int* src = ptr(a, me, kBflat) + (long long)dst * a.cap + j * a.chunk;
  int* out = ptr(a, dst, kLanding) + (long long)me * a.cap + j * a.chunk;
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
    __threadfence_system();
    st_release(flag_of(a, dst, me, j), 1);
    atomicAdd(a.ctl + kProgressWord, 1);
  }
  return true;
}

// Tile group g of shard d: tiles [g * span, (g + 1) * span).  False if a
// wait failed.
__device__ bool merge_group(const Args& a, Shared& sh, const Tile& tl,
                            long long x) {
  const int d = local_shard(a, x % a.m);
  const long long g = x / a.m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* lens = ptr(a, d, kCounts);
  if (tid == 0) {
    long long total = 0;
    int bad = 0;
    for (int r = 0; r < a.n; ++r) {
      const int l = lens[r];
      if (l < 0 || l > a.cap) bad = 1;
      total += l;
    }
    if (bad) atomicOr(a.ctl + kOversizeWord, 1);
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
  int* out = ptr(a, d, kMerged);
  const smj_mp::Cols<SmjPlainLoad> land{ptr(a, d, kLanding), nullptr,
                                        SmjPlainLoad()};
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
        ok = wait_arrival(a, d, r, j);
    }
    if (!ok) sh.abort = 1;
    __syncthreads();
    if (sh.abort) return false;
    for (int r = tid; r < a.n; r += blockDim.x)
      atomicMax(ptr(a, d, kWaited) + r,
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
          atomicOr(ptr(a, d, kViolation), 1);
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
  const long long tickets = a.pushes + (long long)a.m * a.groups;
  for (;;) {
    __syncthreads();  // the last item is done with the shared state
    if (threadIdx.x == 0) {
      sh.ticket = (long long)atomicAdd(
          reinterpret_cast<unsigned long long*>(a.ctl), 1ull);
      sh.stop = sh.ticket >= tickets ||
                ld_relaxed(a.ctl + kErrorWord) != 0;
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

// One card's launch, on its stream.  table: int64[n * kTableWords + m] on
// this card (Slot pointers of every shard -- bflat, landing, merged
// int32[n * cap], counts and waits int32[n] -- then the m shards this card
// holds); ctl: this card's scratch, the control words (kScratchHead) then
// the flags of its m shards (int32[n][cap / chunk] each), zeroed by the
// caller (the flags set, with merge_only), as are the waits and violation
// flags; words 2 and 3 of ctl are the error and oversize words the wrapper
// reads after every card's launch.  n a power of two in [2, kMaxShards],
// 1 <= m <= n, cap a multiple of chunk, window >= 1.  merge_only (for
// timing the merge alone): no push runs, and the merge reads the landing
// as the caller gives it (a full launch's).
SMJ_API int smj_remote_pull(long long* table, int* ctl, int m,
                            long long cap, long long chunk, int n,
                            long long window, int merge_only, void* stream) {
  if (n < 2 || n > kMaxShards || (n & (n - 1)) || m < 1 || m > n ||
      chunk < 1 || cap < 1 || cap % chunk || window < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.table = table;
  a.ctl = ctl;
  a.cap = cap;
  a.chunk = chunk;
  a.chunks = cap / chunk;
  a.row = (long long)n * cap;
  a.tiles = (a.row + kTile - 1) / kTile;
  a.pushes = merge_only ? 0 : (long long)m * n * a.chunks;
  a.n = n;
  a.m = m;
  a.window = window;
  a.span = group_span(n);
  a.groups = (a.tiles + a.span - 1) / a.span;
  const size_t smem = tile_smem(n);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
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
  const long long tickets = a.pushes + (long long)m * a.groups;
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

// Let card `dev` read and write card `peer`'s memory (K11's peer writes
// and flag polls); access already enabled is not an error.  The current
// device is restored.
SMJ_API int smj_enable_peer_access(int dev, int peer) {
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();  // clear it
      e = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(old);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}
