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
// B), so 128M x 128M keys take 0.306 ms at 3.35 TB/s (K7: 0.611); nothing
// is written but one int64.
//
// K3's design: a read-once merge-path count.  The merged order of R and S
// (ties to R, so key k's merged range is its R run, then its S run) is cut
// into tiles of kTile elements, kGroup consecutive tiles a CTA: balanced
// by elements, so a hot key spreads over as many tiles as it fills.  A
// CTA finds where its range starts with one two-run merge-path search over
// R and S, in which a warp's 32 lanes test 32 points a round (about 6
// rounds at 128M), and where the run of equal R keys that ends just before
// it starts (a galloping 32-lane search back).  Those are the only
// searches in device memory: two a CTA, not one a key (a search a tile
// boundary measured slower: its scattered sectors cost about as many bytes
// as the keys).  R and S then stream through circular windows in shared
// memory, one a plane: for each tile the CTA copies only the keys the tile
// may take that are not in the windows yet, with cp.async (16 bytes a copy
// where a vector of the plane is whole), so each key is read once.  The
// tile's split between R and S, and each thread's share of kPer merged
// elements, come from merge-path searches in the windows; each thread then
// walks its elements in order without branches.  An S element s adds
// cntR(s) = (R elements before it in the merged order) - (first index of
// its R run): the walk knows the run's first index once it has taken that
// element, the thread gallops back through the window for the run it
// starts in, and a run that began before the tile counts from a negative
// start, the run's length before the tile, which each thread carries in
// registers from tile to tile.  So no key is owned across tiles and
// nothing is counted twice.  The per-thread int64 sums go through the warp
// (shuffles) and the block (shared memory) to one atomicAdd a CTA.  No
// limbs and no overflow flag (nR * nS < 2^62).
//
// That CTA body, `count_cta`, is a template over the column type: Col32,
// one int32 plane a side (K3, K10), or Col64, the (hi, lo) planes of K7,
// each with its own window, whose keys are formed in registers as
// smj_pack(hi, lo) and compared as int64, so equal hi planes with
// different lo never match.  K7 is that body at blockIdx.x over two
// planes a side, in its own shape (Count64Shape): each key of each plane
// is read once, apart from the two global searches of a CTA.
//
// K10 is K3's CTA body over the four (R run, S run) pairs, in one launch:
// the count does not depend on either side's order beyond each run being
// ascending, so it is the sum of K3's count of each pair.  Each pair gets
// its own CTAs, as many as K3 would give it; a CTA finds its pair from
// the four pairs' first CTAs and counts its tiles of that pair's merged
// order.  So each key is read twice (once in each pair it belongs to):
// 0.612 ms at 128M x 128M, twice the function's bound.
#include "smj_common.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// A count's shape: kPerN merged elements a thread (odd, so that the
// threads' walks start on spread banks), tiles of kThreadsN * kPerN,
// kGroupN tiles a CTA; each plane of R and S sits in a circular window of
// kWindowN slots of shared memory, which holds the tile being walked and
// the kAheadN tiles after it, being copied.
template <int kThreadsN, int kPerN, int kGroupN, int kWindowN, int kAheadN>
struct CountShape {
  static constexpr int kThreads = kThreadsN;
  static constexpr int kPer = kPerN;
  static constexpr int kTile = kThreadsN * kPerN;
  static constexpr int kGroup = kGroupN;
  static constexpr int kWindow = kWindowN;
  static constexpr int kMask = kWindowN - 1;
  static constexpr int kAhead = kAheadN;
  // merged elements a CTA counts
  static constexpr long long kCta = (long long)kGroupN * kTile;
  static_assert((kWindow & kMask) == 0 && kWindow >= (1 + kAhead) * kTile,
                "the window is a power of two that holds the tiles in it");
};

// K3 and K10: one int32 plane a side, 16 KB of windows a CTA.
constexpr int kCountThreads = 128;
constexpr int kCountPer = 15;
constexpr int kCountGroup = 8;
constexpr int kCountAhead = 0;
constexpr int kCountWindow = 2048;
using Count32Shape = CountShape<kCountThreads, kCountPer, kCountGroup,
                                kCountWindow, kCountAhead>;
// K7: two planes a side, 32 KB of windows a CTA; 16 tiles a CTA, which
// halves the CTAs' global searches (8 and 4 measured slower).
struct Count64Shape : CountShape<128, 15, 16, 2048, 0> {};

// A sorted key column in device memory.  Col32: one int32 plane.  Col64:
// the planes hi and lo (its sign bit flipped), whose smj_pack is the int64
// key.  at(i) reads key i from the planes; in(w, k) forms the key in slot
// k of the planes' windows w.
struct Col32 {
  using Key = int;
  static constexpr int kPlanes = 1;
  const int* plane[kPlanes];
  __device__ __forceinline__ Key at(long long i) const {
    return __ldg(plane[0] + i);
  }
  template <int W>
  __device__ __forceinline__ static Key in(const int (&w)[kPlanes][W],
                                           int k) {
    return w[0][k];
  }
};

struct Col64 {
  using Key = long long;
  static constexpr int kPlanes = 2;
  const int* plane[kPlanes];
  __device__ __forceinline__ Key at(long long i) const {
    return smj_pack(__ldg(plane[0] + i), __ldg(plane[1] + i));
  }
  template <int W>
  __device__ __forceinline__ static Key in(const int (&w)[kPlanes][W],
                                           int k) {
    return smj_pack(w[0][k], w[1][k]);
  }
};

// Adds the block's sum of `acc` to *out: shuffles within the warp, shared
// memory across warps, one atomicAdd per block.  Every thread calls it.
template <int kT>
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
template <class C>
__device__ long long corank2(const C& r, long long nR, const C& s,
                             long long nS, long long d, int lane) {
  long long lo = d > nS ? d - nS : 0;
  long long hi = d < nR ? d : nR;
  while (lo < hi) {
    const long long len = hi - lo;
    const long long m = lo + 1 + (len >= 32 ? lane * len / 32 : lane);
    const bool holds = m <= hi && r.at(m - 1) <= s.at(d - m);
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
template <class C>
__device__ long long run_start(const C& r, long long e, int lane) {
  const typename C::Key key = r.at(e);
  long long p = lane == 31 ? -1 : e - (1LL << lane);
  bool other = p < 0 || r.at(p) != key;
  int f = __ffs(__ballot_sync(kFullWarp, other)) - 1;  // lane 31 differs
  long long lo = lane_of(p, f) < 0 ? -1 : lane_of(p, f);  // r[lo] != key
  long long hi = f == 0 ? e : lane_of(p, f > 0 ? f - 1 : 0);  // == key
  while (hi - lo > 1) {
    const long long len = hi - lo - 1;  // unknown slots (lo, hi)
    const long long m = lo + 1 + (len >= 32 ? lane * len / 32 : lane);
    other = m < hi && r.at(m) != key;
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
template <class At, typename Key>
__device__ __forceinline__ int local_run_start(const At& at, int i,
                                               Key key) {
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

// Starts copying plane[from, to) into the circular window win (element k
// at slot (base + k) & Shape::kMask, where base + k is the element's index
// in its plane modulo the window; to - from <= Shape::kWindow), without
// waiting: the whole 16-byte vectors of the plane inside the range 16
// bytes at a time when the planes are aligned, the rest 4 bytes at a
// time.  Slots outside the range are not written: they may hold live
// elements.
template <class Shape>
__device__ __forceinline__ void load_window(const int* __restrict__ plane,
                                            int from, int to, int* win,
                                            int base, bool aligned) {
  int h = from + ((4 - ((base + from) & 3)) & 3);  // whole vectors [h, e)
  int e = to - ((base + to) & 3);
  if (!aligned || h >= e) h = e = to;
  for (int k = from + threadIdx.x; k < h; k += Shape::kThreads)
    cp_async4(win + ((base + k) & Shape::kMask), plane + k);
  for (int k = h + 4 * threadIdx.x; k < e; k += 4 * Shape::kThreads)
    cp_async16(win + ((base + k) & Shape::kMask), plane + k, 16);
  for (int k = e + threadIdx.x; k < to; k += Shape::kThreads)
    cp_async4(win + ((base + k) & Shape::kMask), plane + k);
}

// CTAs that count r[0, nR) against s[0, nS): none when a side is empty.
template <class Shape>
__host__ __device__ __forceinline__ long long count_ctas(long long nR,
                                                         long long nS) {
  return nR == 0 || nS == 0 ? 0 : (nR + nS + Shape::kCta - 1) / Shape::kCta;
}

// The whole CTA (every thread calls it): CTA `cta` of the count of
// r[0, nR) against s[0, nS) counts Shape::kGroup tiles of their merged
// order (the last CTA fewer) and adds them to *out.  Its first boundary
// and the R run that ends just before it come from global searches; after
// that every boundary, run start and carry follows from the windows, each
// thread keeping its own copy of these uniform values in registers, as
// offsets from the CTA's first boundary.
template <class Shape, class C>
__device__ __forceinline__ void count_cta(const C& r, long long nR,
                                          const C& s, long long nS,
                                          long long cta,
                                          unsigned long long* out) {
  using Key = typename C::Key;
  constexpr int kPlanes = C::kPlanes, kMask = Shape::kMask;
  constexpr int kTile = Shape::kTile, kAhead = Shape::kAhead;
  __shared__ __align__(16) int rw[kPlanes][Shape::kWindow];
  __shared__ __align__(16) int sw[kPlanes][Shape::kWindow];
  __shared__ long long first_i, first_len;
  __shared__ Key first_key;
  const long long d_first = cta * Shape::kCta;
  const long long left = nR + nS - d_first;
  const int span = (int)(left < Shape::kCta ? left : Shape::kCta);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long i = corank2(r, nR, s, nS, d_first, lane);
    const long long c = i > 0 ? run_start(r, i - 1, lane) : 0;
    if (lane == 0) {
      first_i = i;
      first_len = i - c;
      first_key = i > 0 ? r.at(i - 1) : Key(0);
    }
  }
  uintptr_t addresses = 0;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q)
    addresses |= reinterpret_cast<uintptr_t>(r.plane[q]) |
                 reinterpret_cast<uintptr_t>(s.plane[q]);
  const bool aligned = (addresses & 15) == 0;
  __syncthreads();
  // this CTA's columns: R from i_first, S from j_first, at most nr and ns
  // of each
  const long long i_first = first_i, j_first = d_first - first_i;
  C rc = r, sc = s;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    rc.plane[q] += i_first;
    sc.plane[q] += j_first;
  }
  const int nr = (int)(nR - i_first < span ? nR - i_first : span);
  const int ns = (int)(nS - j_first < span ? nS - j_first : span);
  const int rbase = (int)(i_first & kMask);
  const int sbase = (int)(j_first & kMask);
  const bool r_before = i_first > 0;
  // the tile: R from i0, S from j0; the R run that ends just before it:
  // key carry_key, carry_len elements; copies started: R to r_lo, S to
  // s_lo
  int i0 = 0, j0 = 0, r_lo = 0, s_lo = 0;
  long long carry_len = first_len;
  Key carry_key = first_key;
  // starts copying whatever the next `reach` merged elements may take
  auto copy_ahead = [&](int reach) {
    const int r_to = i0 + reach < nr ? i0 + reach : nr;
    const int s_to = j0 + reach < ns ? j0 + reach : ns;
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) {
      if (r_to > r_lo)
        load_window<Shape>(rc.plane[q], r_lo, r_to, rw[q], rbase, aligned);
      if (s_to > s_lo)
        load_window<Shape>(sc.plane[q], s_lo, s_to, sw[q], sbase, aligned);
    }
    r_lo = r_to > r_lo ? r_to : r_lo;
    s_lo = s_to > s_lo ? s_to : s_lo;
    cp_async_commit();
  };
  if (kAhead > 0) copy_ahead(span < kTile ? span : kTile);
  unsigned long long acc = 0;
  for (int d = 0; d < span; d += kTile) {
    const int D = span - d < kTile ? span - d : kTile;
    // this tile and the kAhead after it take at most D + kAhead * kTile
    // elements of each side: copy those during this walk
    copy_ahead(D + kAhead * kTile);
    cp_async_wait<kAhead>();  // this thread's copies for this tile
    __syncthreads();          // everyone's
    const int rb = (rbase + i0) & kMask, sb = (sbase + j0) & kMask;
    auto R = [&](int k) { return C::in(rw, (rb + k) & kMask); };
    auto S = [&](int k) { return C::in(sw, (sb + k) & kMask); };
    // the tile's split: a of its D elements from R, b from S
    const int va = nr - i0 < D ? nr - i0 : D, vb = ns - j0 < D ? ns - j0 : D;
    int lo = D - vb, hi = va;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (R(mid - 1) <= S(D - mid)) lo = mid; else hi = mid - 1;
    }
    const int a = lo, b = D - lo;
    const bool before = r_before || i0 > 0;  // an R element before the tile
    const int dl = threadIdx.x * Shape::kPer;
    if (dl < D) {
      const int dend = dl + Shape::kPer < D ? dl + Shape::kPer : D;
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
      Key last;
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
      Key ra = R(ri), sh = S(sj);
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
        const Key next = take_r ? R(ri) : S(sj);
        ra = take_r ? next : ra;
        sh = take_r ? sh : next;
      }
      acc += sum;
    }
    // the R run that ends with the tile's last R element, for the next
    if (a > 0) {
      const Key key = R(a - 1);
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
  block_add<Shape::kThreads>(acc, out);
}

// K3: one CTA a Count32Shape::kCta merged elements.
__global__ void __launch_bounds__(kCountThreads)
merge_join_count_kernel(const int* __restrict__ r, long long nR,
                        const int* __restrict__ s, long long nS,
                        unsigned long long* out) {
  count_cta<Count32Shape>(Col32{{r}}, nR, Col32{{s}}, nS, blockIdx.x, out);
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
  count_cta<Count32Shape>(Col32{{pick(p.r, q)}}, pick(p.nr, q),
                          Col32{{pick(p.s, q)}}, pick(p.ns, q),
                          b - pick(p.first, q), out);
}

// K7: K3's CTA body over the (hi, lo) planes, one CTA a
// Count64Shape::kCta merged elements.
__global__ void __launch_bounds__(Count64Shape::kThreads)
merge_join_count64_kernel(const int* __restrict__ rh,
                          const int* __restrict__ rl, long long nR,
                          const int* __restrict__ sh,
                          const int* __restrict__ sl, long long nS,
                          unsigned long long* out) {
  count_cta<Count64Shape>(Col64{{rh, rl}}, nR, Col64{{sh, sl}}, nS,
                          blockIdx.x, out);
}

}  // namespace

// Adds the match count of r[0, nR) and s[0, nS) to *out (int64, zeroed by
// the caller, who also makes the tensors' card current).
SMJ_API int smj_merge_join_count(const int* r, long long nR, const int* s,
                                 long long nS, unsigned long long* out,
                                 void* stream) {
  const long long blocks = count_ctas<Count32Shape>(nR, nS);
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
  const long long blocks = count_ctas<Count64Shape>(nR, nS);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  merge_join_count64_kernel<<<(unsigned)blocks, Count64Shape::kThreads, 0,
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
    ctas += count_ctas<Count32Shape>(p.nr[q], p.ns[q]);
  }
  if (ctas == 0) return (int)cudaSuccess;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  merge_join_count2_kernel<<<(unsigned)ctas, kCountThreads, 0,
                             (cudaStream_t)stream>>>(p, out);
  return (int)cudaGetLastError();
}
