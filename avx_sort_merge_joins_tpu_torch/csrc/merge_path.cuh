// The merge-path tile of K2/K6 (multiway_merge.cu, whose varlen mode K9,
// chunk_gated_merge.cu, runs) and K11 (remote_pull.cu): the W-way co-rank
// search of one tile boundary, run by one warp, and the merge of one tile
// in shared memory, run by the whole CTA, which K4 (merge_pass.cu) takes
// at W = 2.  W ascending runs (strips) lie `stride`
// slots apart in int32 columns; an element is a key (E = int) or a (key,
// payload) pair packed into one int64 whose signed order is the pairs'
// lexicographic order (E = long long, smj_pack).
//
// Both are templated on the element type and on the load of the columns
// (SmjLdgLoad, an __ldg, for K2/K6, whose input is fixed during the
// launch; SmjPlainLoad, a plain coherent load, for K11, whose landing
// other CTAs write during the launch and which may not take the
// non-coherent read-only path).
//
// K2/K6's coarse co-ranks, their fine ones above fan-in 32, and a sampled
// fine bracket that overflows its stage (multiway_merge.cu) run the
// search; the sampled fine co-ranks at fan-in 32 or less narrow their
// brackets in shared memory by their own rounds instead.
//
// The co-rank of boundary b is every run's consumed prefix c[r]: how many
// of the first b merged outputs come from run r, ties to the lower run.
// The search narrows the value of output b - 1 between the smallest and
// largest element of the runs' windows [lo_r, hi_r) and narrows the
// windows with it: a run's elements <= a probe below output b - 1 go
// before the boundary, its elements > a probe above it after.  The warp
// splits into 32 / G groups of G = min(W, 32) lanes (lane rl of a group
// covers runs rl, rl + 32, ...), each group tries its own probe, so a
// round cuts the value range into 32 / G + 1 parts.  The range is re-read
// from the windows' ends each round, and the search stops once the
// windows' starts or ends sum to b.  The windows come in shared memory;
// at W <= 32 (one run a lane) the search keeps them in registers, above
// it in shared memory, so that registers do not grow with W.
//
// The tile merge (merge_tile: load_tile, stage_tile, merge_rounds; K4,
// merge_pass.cu, calls the three itself to load the next tile during a
// merge) loads the tile's W segments into shared memory with coalesced
// loads and merges them in log2(W) rounds of pairwise merge path between
// two buffers (each thread finds its co-rank by binary search,
// then merges kTile / threads outputs serially, the two heads in
// registers; the lower runs win ties, so the rounds keep run order among
// equal elements).  K2/K6 take merge_rounds_select instead: the same
// rounds, each output taken by selects, with no divergent branch and, in a
// warp whose threads stay inside one pair, no check an output.  The merge
// is bound by instruction issue (a 128M-key W = 16 level on an H100: 1.08
// ms in merge_rounds, 0.90 in merge_rounds_select).
#pragma once

#include "smj_common.cuh"

struct SmjLdgLoad {
  __device__ __forceinline__ int operator()(const int* p) const {
    return __ldg(p);
  }
};

struct SmjPlainLoad {
  __device__ __forceinline__ int operator()(const int* p) const {
    return *p;
  }
};

namespace smj_mp {

constexpr int kTile = 4096;  // outputs a merge tile
constexpr unsigned kFullWarp = 0xffffffffu;

// The columns: element i is k[i] (keys) or the pair (k[i], p[i]), each
// int32 read by `ld`.
template <class Load>
struct Cols {
  const int* k;
  const int* p;
  Load ld;

  template <typename E>
  __device__ __forceinline__ E at(long long i) const {
    if constexpr (sizeof(E) == 8) {
      return smj_pack(ld(k + i), ld(p + i));
    } else {
      return ld(k + i);
    }
  }
};

// First index in [lo, hi) of the run at `base` whose value is > v (kUpper)
// or >= v.
template <typename E, bool kUpper, class C>
__device__ __forceinline__ long long bound(const C& cols, long long base,
                                           long long lo, long long hi,
                                           long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long m = cols.template at<E>(base + mid);
    if (kUpper ? m <= v : m < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Reductions over each aligned group of G lanes (G a power of two <= 32):
// every lane gets its group's result.
__device__ __forceinline__ long long group_sum(long long v, int G) {
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(kFullWarp, v, o);
  return v;
}

__device__ __forceinline__ long long group_min(long long v, int G) {
  for (int o = 1; o < G; o <<= 1) {
    const long long n = __shfl_xor_sync(kFullWarp, v, o);
    v = n < v ? n : v;
  }
  return v;
}

__device__ __forceinline__ long long group_max(long long v, int G) {
  for (int o = 1; o < G; o <<= 1) {
    const long long n = __shfl_xor_sync(kFullWarp, v, o);
    v = n > v ? n : v;
  }
  return v;
}

// Inclusive prefix sum over the lanes of each group, in lane order.
__device__ __forceinline__ long long group_inclusive_sum(long long v,
                                                         int G, int rl) {
  for (int o = 1; o < G; o <<= 1) {
    const long long n = __shfl_up_sync(kFullWarp, v, o);
    if (rl >= o) v += n;
  }
  return v;
}

// Shared memory (int64 words) of one warp's search over W runs: the
// windows' starts and ends, W each, and two lane-private words a run a
// lane.
__host__ __device__ constexpr long long corank_words(int W) {
  return 2LL * W + 64LL * ((W + 31) / 32);
}

// One warp: row[r] = run r's share of the first b merged outputs, run r at
// base + r * stride, W a power of two.  ws: corank_words(W) int64 words of
// shared memory whose first 2W hold each run's window, starts then ends,
// set by the caller (and __syncwarp'ed) such that sum(starts) <= b <=
// sum(ends), every element before a start is among the first b outputs
// and every one of them lies before its run's end.  Only the windows are
// read.  row may lie in shared or global memory.
//
// kRegs (W <= 32, one run a lane): the search keeps the windows and the
// probes' counts in registers, every lane group its own copy, and reads
// ws only for the starting windows.  Otherwise they stay in ws, (W + 31)
// / 32 runs a lane, so that registers do not grow with W.
template <typename E, bool kRegs, class C>
__device__ void corank(const C& cols, long long base, long long stride,
                       int W, long long b, long long* ws, long long* row,
                       int lane) {
  const int G = W < 32 ? W : 32;
  const int P = 32 / G;
  const int probe = lane / G;
  const int rl = lane % G;
  const int nj = kRegs ? 1 : (W + 31) / 32;
  long long* const swlo = ws;
  long long* const swhi = ws + W;
  long long* const su = ws + 2 * W;  // su[j * 32 + lane]: lane-private
  long long* const seq = su + 32 * nj;
  long long rlo = 0, rhi = 0, ru = 0, req = 0;  // kRegs: run rl's
  if constexpr (kRegs) {
    rlo = swlo[rl];
    rhi = swhi[rl];
  }
  const auto wlo = [&](int j) -> long long& {
    if constexpr (kRegs) return rlo; else return swlo[j * 32 + rl];
  };
  const auto whi = [&](int j) -> long long& {
    if constexpr (kRegs) return rhi; else return swhi[j * 32 + rl];
  };
  const auto u = [&](int j) -> long long& {
    if constexpr (kRegs) return ru; else return su[j * 32 + lane];
  };
  const auto eqs = [&](int j) -> long long& {
    if constexpr (kRegs) return req; else return seq[j * 32 + lane];
  };
  // the value of output b - 1 lies in [vlo, vhi]
  long long vlo = LLONG_MIN, vhi = LLONG_MAX;
  for (;;) {
    long long slo = 0, shi = 0, mn = LLONG_MAX, mx = LLONG_MIN;
    for (int j = 0; j < nj; ++j) {
      const long long lo = wlo(j), hi = whi(j);
      slo += lo;
      shi += hi;
      if (hi > lo) {
        const long long s = base + (j * 32 + rl) * stride;
        const long long lo_v = cols.template at<E>(s + lo);
        const long long hi_v = cols.template at<E>(s + hi - 1);
        mn = lo_v < mn ? lo_v : mn;
        mx = hi_v > mx ? hi_v : mx;
      }
    }
    slo = group_sum(slo, G);
    shi = group_sum(shi, G);
    if (slo == b || shi == b) {
      if (probe == 0)
        for (int j = 0; j < nj; ++j)
          row[j * 32 + rl] = slo == b ? wlo(j) : whi(j);
      return;
    }
    // some window holds output b - 1 and some an element after it
    mn = group_min(mn, G);
    mx = group_max(mx, G);
    vlo = mn > vlo ? mn : vlo;
    vhi = mx < vhi ? mx : vhi;
    if (vlo >= vhi) break;
    // this group's probe: vlo + floor((vhi - vlo) * (probe + 1) / (P + 1))
    const unsigned long long diff =
        (unsigned long long)vhi - (unsigned long long)vlo;
    const unsigned long long q = diff / (P + 1), rm = diff % (P + 1);
    const long long mid = vlo + (long long)(q * (probe + 1) +
                                            rm * (probe + 1) / (P + 1));
    long long cnt = 0;
    for (int j = 0; j < nj; ++j) {
      u(j) = bound<E, true>(cols, base + (j * 32 + rl) * stride, wlo(j),
                            whi(j), mid);
      cnt += u(j);
    }
    cnt = group_sum(cnt, G);
    // every lane is past its reads of the windows
    const unsigned exact = __ballot_sync(kFullWarp, cnt == b);
    if (exact != 0) {  // the elements <= that probe are the first b
      const int src = (__ffs(exact) - 1) / G * G + rl;
      for (int j = 0; j < nj; ++j) {
        const long long v = __shfl_sync(kFullWarp, u(j), src);
        if (probe == 0) row[j * 32 + rl] = v;
      }
      return;
    }
    // the probes below output b - 1 raise the windows' starts, the first
    // one above it lowers their ends (in shared memory: group 0 writes)
    const int below = __popc(__ballot_sync(kFullWarp, cnt < b)) / G;
    if (below > 0) {
      const int src = (below - 1) * G + rl;
      for (int j = 0; j < nj; ++j) {
        const long long v = __shfl_sync(kFullWarp, u(j), src);
        if (kRegs || probe == 0) wlo(j) = v;
      }
      vlo = __shfl_sync(kFullWarp, mid, src) + 1;
    }
    if (below < P) {
      const int src = below * G + rl;
      for (int j = 0; j < nj; ++j) {
        const long long v = __shfl_sync(kFullWarp, u(j), src);
        if (kRegs || probe == 0) whi(j) = v;
      }
      vhi = __shfl_sync(kFullWarp, mid, src);
    }
    if constexpr (!kRegs) __syncwarp();
  }
  // output b - 1 has the value v = vlo: every run gives its elements < v,
  // then the elements == v fill the rest of the prefix in run order
  long long less = 0;
  for (int j = 0; j < nj; ++j) {
    const long long s = base + (j * 32 + rl) * stride;
    u(j) = bound<E, false>(cols, s, wlo(j), whi(j), vlo);
    eqs(j) = bound<E, true>(cols, s, u(j), whi(j), vlo) - u(j);
    less += u(j);
  }
  long long left = b - group_sum(less, G);
  for (int j = 0; j < nj; ++j) {
    const long long eq = eqs(j);
    const long long incl = group_inclusive_sum(eq, G, rl);
    long long take = left - (incl - eq);
    take = take < 0 ? 0 : (take > eq ? eq : take);
    if (probe == 0) row[j * 32 + rl] = u(j) + take;
    left -= __shfl_sync(kFullWarp, incl, probe * G + G - 1);
    if (left < 0) left = 0;
  }
}

// Slot of tile position p in a shared buffer: one spare element after
// every 128 bytes, so that a warp's threads, each writing its own run of
// kTile / threads outputs, hit distinct banks.
template <typename E>
__device__ __forceinline__ int sw(int p) {
  return p + (p >> (sizeof(E) == 8 ? 4 : 5));
}

// Elements of one buffer of a tile of kTileN outputs.
template <typename E, int kTileN = kTile>
__host__ __device__ constexpr int buf_elems() {
  return kTileN + kTileN / (sizeof(E) == 8 ? 16 : 32);
}

// Co-rank of diagonal d of merge(buf[a0, a0 + na), buf[b0, b0 + nb)) in
// shared memory: how many of its first d outputs come from a (a wins
// ties).
template <typename E>
__device__ __forceinline__ int merge_co_rank(const E* buf, int a0, int na,
                                             int b0, int nb, int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (buf[sw<E>(a0 + mid)] <= buf[sw<E>(b0 + d - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Loads the tile whose segment r is [src[r], src[r] + offs[r + 1] -
// offs[r]) of the columns into registers: v[q] is slot tid + q * kThreads
// of the tile (coalesced), offs[W] <= kTileN slots, W a power of two.  src
// and offs lie in shared memory.
template <typename E, int kThreads, int kTileN = kTile, class C>
__device__ __forceinline__ void load_tile(const C& cols, const long long* src,
                                          const int* offs, int W,
                                          E (&v)[kTileN / kThreads]) {
  constexpr int kPerThread = kTileN / kThreads;
  const int tid = threadIdx.x;
  const int n = offs[W];
  // slot p of the tile comes from the segment s with offs[s] <= p <
  // offs[s + 1]
  int lo = 0, hi = W;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= tid) lo = mid; else hi = mid;
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = tid + q * kThreads;
    if (p < n) {
      while (offs[lo + 1] <= p) ++lo;
      v[q] = cols.template at<E>(src[lo] + (p - offs[lo]));
    }
  }
}

// Writes load_tile's registers into the padded buffer: slot p at sw<E>(p).
template <typename E, int kThreads, int kTileN = kTile>
__device__ __forceinline__ void stage_tile(const E (&v)[kTileN / kThreads],
                                           int n, E* buf) {
#pragma unroll
  for (int q = 0; q < kTileN / kThreads; ++q) {
    const int p = threadIdx.x + q * kThreads;
    if (p < n) buf[sw<E>(p)] = v[q];
  }
}

// The whole CTA of kThreads threads (all of them call it): merges the
// staged tile in buf0, segment r at [offs[r], offs[r + 1]), in log2(W)
// pairwise rounds between buf0 and buf1 (buffers of buf_elems<E, kTileN>()
// elements).  Returns the buffer that holds the merged tile, position p at
// sw<E>(p), after a __syncthreads; the caller writes it out.
template <typename E, int kThreads, int kTileN = kTile>
__device__ const E* merge_rounds(const int* offs, int W, E* buf0, E* buf1) {
  constexpr int kPerThread = kTileN / kThreads;
  const int n = offs[W];
  // log2(W) rounds: merge pairs of s-segment runs from `from` into `to`
  E* from = buf0;
  E* to = buf1;
  const int p0 = threadIdx.x * kPerThread;
  for (int s = 1; s < W; s <<= 1) {
    if (p0 < n) {
      // the pair j holding output p0: the first whose end is past it
      int j = 0, jhi = W / (2 * s) - 1;
      while (j < jhi) {
        const int mid = (j + jhi) >> 1;
        if (offs[(mid + 1) * 2 * s] > p0) jhi = mid; else j = mid + 1;
      }
      int a0 = offs[j * 2 * s], b0 = offs[j * 2 * s + s];
      int e = offs[(j + 1) * 2 * s];
      int na = b0 - a0, nb = e - b0;
      int ia = merge_co_rank(from, a0, na, b0, nb, p0 - a0);
      int ib = p0 - a0 - ia;
      // the heads of a and b stay in registers: one load an output
      E va = ia < na ? from[sw<E>(a0 + ia)] : E();
      E vb = ib < nb ? from[sw<E>(b0 + ib)] : E();
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int p = p0 + q;
        if (p < n) {
          while (p >= e) {  // into the next pair
            ++j;
            a0 = e;
            b0 = offs[j * 2 * s + s];
            e = offs[(j + 1) * 2 * s];
            na = b0 - a0;
            nb = e - b0;
            ia = ib = 0;
            va = na > 0 ? from[sw<E>(a0)] : E();
            vb = nb > 0 ? from[sw<E>(b0)] : E();
          }
          if (ib >= nb || (ia < na && va <= vb)) {
            to[sw<E>(p)] = va;
            if (++ia < na) va = from[sw<E>(a0 + ia)];
          } else {
            to[sw<E>(p)] = vb;
            if (++ib < nb) vb = from[sw<E>(b0 + ib)];
          }
        }
      }
    }
    __syncthreads();
    E* x = from;
    from = to;
    to = x;
  }
  return from;
}

// An element above every live one: a spent run's head in
// merge_pairs_select (a live key is below INT32_MAX, and a live pair below
// the pad pair, which packs to LLONG_MAX).
template <typename E>
__device__ __forceinline__ E elem_inf() {
  if constexpr (sizeof(E) == 8) {
    return LLONG_MAX;
  } else {
    return INT_MAX;
  }
}

// One round of merge_rounds (merge the pairs of s-segment runs of `from`
// into `to`; the caller syncs), every output taken by selects, not
// branches: each run's head slot and end and its head value (elem_inf
// once the run is spent) stay in registers, and an output picks the
// smaller head (the lower run on ties), stores it, and reloads that run's
// head, one load and no divergence an output.  A thread's outputs p0 ..
// p0 + kPerThread - 1 lie in one padded row (sw(p0 + q) = sw(p0) + q).  A
// warp whose threads all stay inside one pair and the tile's live outputs
// merges without a check an output; a warp with a thread that runs into
// the next pair or past the tile checks each output.
template <typename E, int kThreads, int kTileN>
__device__ __forceinline__ void merge_pairs_select(const int* offs, int W,
                                                   int s, const E* from,
                                                   E* to) {
  constexpr int kPerThread = kTileN / kThreads;
  static_assert((sizeof(E) == 8 ? 16 : 32) % kPerThread == 0,
                "a thread's outputs must share a padded row");
  const E inf = elem_inf<E>();
  const int n = offs[W];
  const int p0 = threadIdx.x * kPerThread;
  const bool live = p0 < n;
  int j = 0, pa = 0, ea = 0, pb = 0, eb = 0;
  E va = inf, vb = inf;
  if (live) {
    // the pair j holding output p0: the first whose end is past it
    int jhi = W / (2 * s) - 1;
    while (j < jhi) {
      const int mid = (j + jhi) >> 1;
      if (offs[(mid + 1) * 2 * s] > p0) jhi = mid; else j = mid + 1;
    }
    pa = offs[j * 2 * s];
    ea = offs[j * 2 * s + s];
    eb = offs[(j + 1) * 2 * s];
    const int ia = merge_co_rank(from, pa, ea - pa, ea, eb - ea, p0 - pa);
    pb = ea + (p0 - pa - ia);
    pa += ia;
    va = pa < ea ? from[sw<E>(pa)] : inf;
    vb = pb < eb ? from[sw<E>(pb)] : inf;
  }
  E* const out = to + sw<E>(p0);
  const auto step = [&](int q) {
    const bool tb = vb < va;
    out[q] = tb ? vb : va;
    const int np = (tb ? pb : pa) + 1;
    const E nv = np < (tb ? eb : ea) ? from[sw<E>(np)] : inf;
    pa = tb ? pa : np;
    pb = tb ? np : pb;
    va = tb ? va : nv;
    vb = tb ? nv : vb;
  };
  const int stop = n < eb ? n : eb;
  if (__all_sync(kFullWarp, !live || p0 + kPerThread <= stop)) {
    if (live) {
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) step(q);
    }
    return;
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int p = p0 + q;
    if (p < n) {
      while (p >= eb) {  // into the next pair
        ++j;
        pa = eb;
        ea = offs[j * 2 * s + s];
        pb = ea;
        eb = offs[(j + 1) * 2 * s];
        va = pa < ea ? from[sw<E>(pa)] : inf;
        vb = pb < eb ? from[sw<E>(pb)] : inf;
      }
      step(q);
    }
  }
}

// merge_rounds in merge_pairs_select's rounds.
template <typename E, int kThreads, int kTileN = kTile>
__device__ const E* merge_rounds_select(const int* offs, int W, E* buf0,
                                        E* buf1) {
  E* from = buf0;
  E* to = buf1;
  for (int s = 1; s < W; s <<= 1) {
    merge_pairs_select<E, kThreads, kTileN>(offs, W, s, from, to);
    __syncthreads();
    E* x = from;
    from = to;
    to = x;
  }
  return from;
}

// The whole CTA of kThreads threads (all of them call it): merges the tile
// whose segment r is [src[r], src[r] + offs[r + 1] - offs[r]) of the
// columns, offs[W] <= kTileN outputs (kTile unless the caller names
// another), W a power of two: load_tile, stage_tile into buf0, then
// merge_rounds_select (kSelect) or merge_rounds.  src and offs lie in
// shared memory; buf0 and buf1 are buffers of buf_elems<E, kTileN>()
// elements.  Returns the buffer that holds the merged tile, position p at
// sw<E>(p); the caller writes it out.
template <typename E, int kThreads, int kTileN = kTile, bool kSelect = false,
          class C>
__device__ const E* merge_tile(const C& cols, const long long* src,
                               const int* offs, int W, E* buf0, E* buf1) {
  E v[kTileN / kThreads];
  load_tile<E, kThreads, kTileN>(cols, src, offs, W, v);
  stage_tile<E, kThreads, kTileN>(v, offs[W], buf0);
  __syncthreads();
  if constexpr (kSelect) {
    return merge_rounds_select<E, kThreads, kTileN>(offs, W, buf0, buf1);
  } else {
    return merge_rounds<E, kThreads, kTileN>(offs, W, buf0, buf1);
  }
}

}  // namespace smj_mp
