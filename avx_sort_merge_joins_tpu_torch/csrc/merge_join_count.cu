// K3, K7 and K10: exact match count of two key columns, sum over keys k of
// cntR(k) * cntS(k), in int64.  K3 takes int32 keys, each side one
// ascending run; K7 takes 64-bit keys, each side given as two int32 planes
// (hi, lo with its sign bit flipped) whose lexicographic order is the int64
// order; K10 takes int32 keys, each side two ascending runs (the layout of
// a multiway sort stopped one merge level early).
//
// Replaces the TPU kernels avx_sort_merge_joins_tpu/ops/mergejoin.py
// `_count_kernel` with `_segmented_counts` (reached through
// `merge_join_count_fused`), `_count_kernel64` (reached through
// `merge_join_count_fused64`) and `_count_kernel2` (reached through
// `merge_join_count_fused2`).  Those run as grid=(1,): one serial
// read-only pass over R and S (S negated, or as bitwise-NOT planes, and
// read back to front), with the count in base-2^30 int32 limbs and an
// overflow flag; `_count_kernel2` first merges the two runs of each side
// and then the two sides, through three tagged bitonic selects per tile.
//
// What bounds them on the H100: each key has to be read once, 4 B (K7: 8
// B), so 128M x 128M keys take 0.306 ms at 3.35 TB/s; nothing is written
// but one int64.
//
// K3's design: a read-once merge-path count.  The merged order of R and S
// (ties to R, so key k's merged range is its R run, then its S run) is cut
// into tiles of kCountTile elements, kCountGroup consecutive tiles a CTA:
// balanced by elements, so a hot key spreads over as many tiles as it
// fills.  A CTA finds where its range starts with one two-run merge-path
// search over R and S, in which a warp's 32 lanes test 32 points a round
// (about 6 rounds at 128M), and where the run of equal R keys that ends
// just before it starts (a galloping 32-lane search back).  Those are the
// only searches in device memory: two a CTA, not one a key (a search a
// tile boundary measured slower: its scattered sectors cost about as many
// bytes as the keys).  R and S then stream through two circular windows
// in shared memory: for each tile the CTA copies only the keys the tile
// may take that are not in the windows yet, with cp.async (16 bytes a copy
// where a vector of the column is whole), so each key is read once.  The
// tile's split between R and S, and each thread's share of kCountPer
// merged elements, come from merge-path searches in the windows; each
// thread then walks its elements in order without branches.  An S element
// s adds cntR(s) = (R elements before it in the merged order) - (first
// index of its R run): the walk knows the run's first index once it has
// taken that element, the thread gallops back through the window for the
// run it starts in, and a run that began before the tile counts from a
// negative start, the run's length before the tile, which each thread
// carries in registers from tile to tile.  So no key is owned across
// tiles and nothing is counted twice.  The per-thread int64 sums go
// through the warp (shuffles) and the block (shared memory) to one
// atomicAdd a CTA.  No limbs and no overflow flag (nR * nS < 2^62).
//
// K10 is K3's CTA body over the four (R run, S run) pairs, in one launch:
// the count does not depend on either side's order beyond each run being
// ascending, so it is the sum of K3's count of each pair.  Each pair gets
// its own CTAs, as many as K3 would give it; a CTA finds its pair from
// the four pairs' first CTAs and counts its tiles of that pair's merged
// order.  So each key is read twice (once in each pair it belongs to):
// 0.612 ms at 128M x 128M, twice the function's bound.
//
// K7 keeps a grid-stride loop in which each thread adds, for its R keys,
// upper_bound - lower_bound over S (two binary searches over global
// memory a key, bound by load latency; K3 and K10 ran so until their
// rebuilds).  It forms each 64-bit key in registers from its two planes
// (smj_pack of (hi, lo_biased) is the original int64 key) and probes both
// S planes on every search step (smj_pair_bound), so equal hi planes with
// different lo never match.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr unsigned kFullWarp = 0xffffffffu;

// K3: kCountPer merged elements a thread (odd, so that the threads'
// walks start on spread banks), tiles of kCountTile, kCountGroup tiles a
// CTA; R and S each sit in a circular window of kCountWindow slots of
// shared memory, which holds the tile being walked and the kCountAhead
// tiles after it, being copied.
constexpr int kCountThreads = 128;
constexpr int kCountPer = 15;
constexpr int kCountTile = kCountThreads * kCountPer;
constexpr int kCountGroup = 8;
constexpr int kCountAhead = 0;
constexpr int kCountWindow = 2048;
constexpr int kCountMask = kCountWindow - 1;
static_assert((kCountWindow & kCountMask) == 0 &&
                  kCountWindow >= (1 + kCountAhead) * kCountTile,
              "the window is a power of two that holds the tiles in it");

// Adds the block's sum of `acc` to *out: shuffles within the warp, shared
// memory across warps, one atomicAdd per block.  Every thread calls it.
template <int kT = kThreads>
__device__ __forceinline__ void block_add(unsigned long long acc,
                                          unsigned long long* out) {
  __shared__ unsigned long long warp_sums[kT / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFullWarp, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kT / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(kFullWarp, acc, off);
    if (lane == 0 && acc != 0) atomicAdd(out, acc);
  }
}

// Lane `src`'s v.
__device__ __forceinline__ long long lane_of(long long v, int src) {
  return __shfl_sync(kFullWarp, v, src);
}

// One warp: how many of the first d elements of the merged order of
// r[0, nR) and s[0, nS) (ties to R) come from R, that is the largest i in
// [max(0, d - nS), min(d, nR)] with r[i - 1] <= s[d - i] (the low end
// holds by definition; the test holds up to the answer and fails after
// it).  Each round the lanes test 32 points spread over the open range
// and keep the gap between the last that holds and the first that fails.
__device__ long long corank2(const int* __restrict__ r, long long nR,
                             const int* __restrict__ s, long long nS,
                             long long d, int lane) {
  long long lo = d > nS ? d - nS : 0;
  long long hi = d < nR ? d : nR;
  while (lo < hi) {
    const long long len = hi - lo;
    const long long m = lo + 1 + (len >= 32 ? lane * len / 32 : lane);
    const bool holds = m <= hi && __ldg(r + m - 1) <= __ldg(s + d - m);
    const int c = __popc(__ballot_sync(kFullWarp, holds));
    const long long below = lane_of(m, c > 0 ? c - 1 : 0);
    const long long above = lane_of(m, c < 32 ? c : 31);
    hi = c < 32 && above - 1 < hi ? above - 1 : hi;
    lo = c > 0 ? below : lo;
  }
  return lo;
}

// One warp: the first index of the run of equal keys that ends at r[e].
// The lanes first test e - 2^l (lane 31: "before index 0"), then narrow
// the gap they find 32 points a round.
__device__ long long run_start(const int* __restrict__ r, long long e,
                               int lane) {
  const int key = __ldg(r + e);
  long long p = lane == 31 ? -1 : e - (1LL << lane);
  bool other = p < 0 || __ldg(r + p) != key;
  int f = __ffs(__ballot_sync(kFullWarp, other)) - 1;  // lane 31 differs
  long long lo = lane_of(p, f) < 0 ? -1 : lane_of(p, f);  // r[lo] != key
  long long hi = f == 0 ? e : lane_of(p, f > 0 ? f - 1 : 0);  // == key
  while (hi - lo > 1) {
    const long long len = hi - lo - 1;  // unknown slots (lo, hi)
    const long long m = lo + 1 + (len >= 32 ? lane * len / 32 : lane);
    other = m < hi && __ldg(r + m) != key;
    const int c = __popc(__ballot_sync(kFullWarp, other));
    const long long below = lane_of(m, c > 0 ? c - 1 : 0);
    const long long above = lane_of(m, c < 32 ? c : 31);
    const bool above_valid = c < 32 && above < hi;
    lo = c > 0 ? below : lo;
    hi = above_valid ? above : hi;
  }
  return hi;
}

// First index q in [0, i) with at(q), ..., at(i - 1) all equal to key =
// at(i - 1) (0 when i == 0): a gallop back, then a binary search.
template <class At>
__device__ __forceinline__ int local_run_start(const At& at, int i,
                                               int key) {
  if (i == 0) return 0;
  int hi = i - 1, step = 1, lo = hi - 1;
  while (lo >= 0 && at(lo) == key) {
    hi = lo;
    step <<= 1;
    lo = hi - step;
  }
  if (lo < -1) lo = -1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (at(mid) == key) hi = mid; else lo = mid;
  }
  return hi;
}

// cp.async: 16 bytes (the first `bytes` of them read, the rest zeroed) or
// 4 bytes from device memory into shared memory, without registers.
__device__ __forceinline__ void cp_async16(int* dst, const int* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's cp.async groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts copying col[from, to) into the circular window win (element k
// at slot (base + k) & kCountMask, where base + k is the element's index
// in its column modulo the window; to - from <= kCountWindow), without
// waiting: the whole 16-byte vectors of the column inside the range 16
// bytes at a time when the column is aligned, the rest 4 bytes at a time.
// Slots outside the range are not written: they may hold live elements.
__device__ __forceinline__ void load_window(const int* __restrict__ col,
                                            int from, int to, int* win,
                                            int base, bool aligned) {
  int h = from + ((4 - ((base + from) & 3)) & 3);  // whole vectors [h, e)
  int e = to - ((base + to) & 3);
  if (!aligned || h >= e) h = e = to;
  for (int k = from + threadIdx.x; k < h; k += kCountThreads)
    cp_async4(win + ((base + k) & kCountMask), col + k);
  for (int k = h + 4 * threadIdx.x; k < e; k += 4 * kCountThreads)
    cp_async16(win + ((base + k) & kCountMask), col + k, 16);
  for (int k = e + threadIdx.x; k < to; k += kCountThreads)
    cp_async4(win + ((base + k) & kCountMask), col + k);
}

// Merged elements a CTA counts.
constexpr long long kCountCta = (long long)kCountGroup * kCountTile;

// CTAs that count r[0, nR) against s[0, nS): none when a side is empty.
__host__ __device__ __forceinline__ long long count_ctas(long long nR,
                                                         long long nS) {
  return nR == 0 || nS == 0 ? 0 : (nR + nS + kCountCta - 1) / kCountCta;
}

// The whole CTA (every thread calls it): CTA `cta` of the count of
// r[0, nR) against s[0, nS) counts kCountGroup tiles of their merged
// order (the last CTA fewer) and adds them to *out.  Its first boundary
// and the R run that ends just before it come from global searches; after
// that every boundary, run start and carry follows from the windows, each
// thread keeping its own copy of these uniform values in registers, as
// offsets from the CTA's first boundary.
__device__ __forceinline__ void count_cta(const int* __restrict__ r,
                                          long long nR,
                                          const int* __restrict__ s,
                                          long long nS, long long cta,
                                          unsigned long long* out) {
  __shared__ __align__(16) int rw[kCountWindow];
  __shared__ __align__(16) int sw[kCountWindow];
  __shared__ long long first_i, first_len;
  __shared__ int first_key;
  const long long d_first = cta * kCountCta;
  const long long left = nR + nS - d_first;
  const int span = (int)(left < kCountCta ? left : kCountCta);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long i = corank2(r, nR, s, nS, d_first, lane);
    const long long c = i > 0 ? run_start(r, i - 1, lane) : 0;
    if (lane == 0) {
      first_i = i;
      first_len = i - c;
      first_key = i > 0 ? __ldg(r + i - 1) : 0;
    }
  }
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0;
  __syncthreads();
  // this CTA's columns: R from i_first, S from j_first, at most nr and ns
  // of each
  const long long i_first = first_i, j_first = d_first - first_i;
  const int* const rc = r + i_first;
  const int* const sc = s + j_first;
  const int nr = (int)(nR - i_first < span ? nR - i_first : span);
  const int ns = (int)(nS - j_first < span ? nS - j_first : span);
  const int rbase = (int)(i_first & kCountMask);
  const int sbase = (int)(j_first & kCountMask);
  const bool r_before = i_first > 0;
  // the tile: R from i0, S from j0; the R run that ends just before it:
  // key carry_key, carry_len elements; copies started: R to r_lo, S to
  // s_lo
  int i0 = 0, j0 = 0, r_lo = 0, s_lo = 0;
  long long carry_len = first_len;
  int carry_key = first_key;
  // starts copying whatever the next `reach` merged elements may take
  auto copy_ahead = [&](int reach) {
    const int r_to = i0 + reach < nr ? i0 + reach : nr;
    const int s_to = j0 + reach < ns ? j0 + reach : ns;
    if (r_to > r_lo) load_window(rc, r_lo, r_to, rw, rbase, aligned);
    if (s_to > s_lo) load_window(sc, s_lo, s_to, sw, sbase, aligned);
    r_lo = r_to > r_lo ? r_to : r_lo;
    s_lo = s_to > s_lo ? s_to : s_lo;
    cp_async_commit();
  };
  if (kCountAhead > 0) copy_ahead(span < kCountTile ? span : kCountTile);
  unsigned long long acc = 0;
  for (int d = 0; d < span; d += kCountTile) {
    const int D = span - d < kCountTile ? span - d : kCountTile;
    // this tile and the kCountAhead after it take at most D + kCountAhead
    // * kCountTile elements of each side: copy those during this walk
    copy_ahead(D + kCountAhead * kCountTile);
    cp_async_wait<kCountAhead>();  // this thread's copies for this tile
    __syncthreads();               // everyone's
    const int rb = (rbase + i0) & kCountMask, sb = (sbase + j0) & kCountMask;
    auto R = [&](int k) { return rw[(rb + k) & kCountMask]; };
    auto S = [&](int k) { return sw[(sb + k) & kCountMask]; };
    // the tile's split: a of its D elements from R, b from S
    const int va = nr - i0 < D ? nr - i0 : D, vb = ns - j0 < D ? ns - j0 : D;
    int lo = D - vb, hi = va;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (R(mid - 1) <= S(D - mid)) lo = mid; else hi = mid - 1;
    }
    const int a = lo, b = D - lo;
    const bool before = r_before || i0 > 0;  // an R element before the tile
    const int dl = threadIdx.x * kCountPer;
    if (dl < D) {
      const int dend = dl + kCountPer < D ? dl + kCountPer : D;
      lo = dl > b ? dl - b : 0;
      hi = dl < a ? dl : a;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (R(mid - 1) <= S(dl - mid)) lo = mid; else hi = mid - 1;
      }
      int ri = lo, sj = dl - lo;
      // the R run the walk is in: key `last`, from local index `start`
      // (negative: the run began before the tile).  With no R element
      // before the thread's first, last = R(0): every S key taken before
      // R(0) is smaller.
      int last;
      long long start;
      if (ri > 0) {
        last = R(ri - 1);
        start = local_run_start(R, ri, last);
        if (start == 0 && before && carry_key == last) start = -carry_len;
      } else if (before) {
        last = carry_key;
        start = -carry_len;
      } else {
        last = R(0);
        start = 0;
      }
      unsigned long long sum = 0;
      int ra = R(ri), sh = S(sj);
      // one merged element a step, without branches: R's head if it is
      // <= S's (a new run when its key changes), else S's (a match when
      // its key is the run's); then one load refills the head taken
      for (int k = dl; k < dend; ++k) {
        const bool take_r = ri < a && (sj >= b || ra <= sh);
        start = take_r && ra != last ? ri : start;
        last = take_r ? ra : last;
        sum += !take_r && sh == last ? (unsigned long long)(ri - start) : 0;
        ri += take_r;
        sj += !take_r;
        const int next = take_r ? R(ri) : S(sj);
        ra = take_r ? next : ra;
        sh = take_r ? sh : next;
      }
      acc += sum;
    }
    // the R run that ends with the tile's last R element, for the next
    if (a > 0) {
      const int key = R(a - 1);
      const int q = local_run_start(R, a, key);
      carry_len = q == 0 && before && carry_key == key ? carry_len + a
                                                       : a - q;
      carry_key = key;
    }
    __syncthreads();  // the walks are done with the windows
    i0 += a;
    j0 += b;
  }
  cp_async_wait<0>();  // copies ahead past the last tile, unused
  block_add<kCountThreads>(acc, out);
}

// K3: one CTA a kCountCta merged elements.
__global__ void __launch_bounds__(kCountThreads)
merge_join_count_kernel(const int* __restrict__ r, long long nR,
                        const int* __restrict__ s, long long nS,
                        unsigned long long* out) {
  count_cta(r, nR, s, nS, blockIdx.x, out);
}

// K10's four pairs: pair q counts r[q] against s[q] with its CTAs from
// first[q] on, up to the next pair's first.
struct CountPairs {
  const int* r[4];
  const int* s[4];
  long long nr[4], ns[4], first[4];
};

// a[q] with constant indices only, so that the parameter stays out of
// local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[4], int q) {
  return q == 0 ? a[0] : q == 1 ? a[1] : q == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(kCountThreads)
merge_join_count2_kernel(const CountPairs p, unsigned long long* out) {
  const long long b = blockIdx.x;
  // the last pair that starts at or before b (an empty pair starts where
  // the next one does)
  const int q = (b >= p.first[1]) + (b >= p.first[2]) + (b >= p.first[3]);
  count_cta(pick(p.r, q), pick(p.nr, q), pick(p.s, q), pick(p.ns, q),
            b - pick(p.first, q), out);
}

__global__ void merge_join_count64_kernel(const int* __restrict__ rh,
                                          const int* __restrict__ rl,
                                          long long nR,
                                          const int* __restrict__ sh,
                                          const int* __restrict__ sl,
                                          long long nS,
                                          unsigned long long* out) {
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nR;
       i += stride) {
    const long long key = smj_pack(rh[i], rl[i]);
    const long long lo = smj_pair_bound<false>(sh, sl, 0, nS, key);
    if (lo < nS && smj_pack(__ldg(sh + lo), __ldg(sl + lo)) == key)
      acc += smj_pair_bound<true>(sh, sl, lo + 1, nS, key) - lo;
  }
  block_add(acc, out);
}

}  // namespace

// Adds the match count of r[0, nR) and s[0, nS) to *out (int64, zeroed by
// the caller, who also makes the tensors' card current).
SMJ_API int smj_merge_join_count(const int* r, long long nR, const int* s,
                                 long long nS, unsigned long long* out,
                                 void* stream) {
  const long long blocks = count_ctas(nR, nS);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  merge_join_count_kernel<<<(unsigned)blocks, kCountThreads, 0,
                            (cudaStream_t)stream>>>(r, nR, s, nS, out);
  return (int)cudaGetLastError();
}

// The same over 64-bit keys: R as planes (rh, rl)[0, nR), S as planes
// (sh, sl)[0, nS), both ascending in lexicographic order.
SMJ_API int smj_merge_join_count64(const int* rh, const int* rl, long long nR,
                                   const int* sh, const int* sl, long long nS,
                                   unsigned long long* out, void* stream) {
  if (nR == 0) return (int)cudaSuccess;
  long long blocks = (nR + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  merge_join_count64_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(rh, rl, nR, sh, sl, nS,
                                                      out);
  return (int)cudaGetLastError();
}

// The same where each side holds two ascending runs: R's r[0, min(nR,
// span_r)) and r[span_r, nR), S's s[0, min(nS, span_s)) and s[span_s,
// nS) (a run 1 is empty when n <= span).
SMJ_API int smj_merge_join_count2(const int* r, long long nR, const int* s,
                                  long long nS, long long span_r,
                                  long long span_s, unsigned long long* out,
                                  void* stream) {
  if (span_r < 1 || span_s < 1) return (int)cudaErrorInvalidValue;
  const long long r0 = nR < span_r ? nR : span_r;
  const long long s0 = nS < span_s ? nS : span_s;
  const int* const rs[2] = {r, r + r0};
  const int* const ss[2] = {s, s + s0};
  const long long nrs[2] = {r0, nR - r0}, nss[2] = {s0, nS - s0};
  CountPairs p;
  long long ctas = 0;
  for (int q = 0; q < 4; ++q) {  // (R0, S0), (R0, S1), (R1, S0), (R1, S1)
    p.r[q] = rs[q >> 1];
    p.nr[q] = nrs[q >> 1];
    p.s[q] = ss[q & 1];
    p.ns[q] = nss[q & 1];
    p.first[q] = ctas;
    ctas += count_ctas(p.nr[q], p.ns[q]);
  }
  if (ctas == 0) return (int)cudaSuccess;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  merge_join_count2_kernel<<<(unsigned)ctas, kCountThreads, 0,
                             (cudaStream_t)stream>>>(p, out);
  return (int)cudaGetLastError();
}
