// K2 and K6: merge each group of `fanin` consecutive ascending runs into
// one ascending run.  K2 merges int32 keys; K6 merges (key, payload) int32
// pairs, given as two columns, in lexicographic order.  Both take the
// uniform-lens layout (smj_multiway_merge: run r starts at r * span and
// holds clip(total - r * span, 0, span) elements) or run lengths from an
// int32 device vector (smj_multiway_merge_varlen: run r starts at
// r * stride and holds lens[r] elements, clamped to [0, stride]).  Group g
// merges into [g * fanin * stride, ...): its live elements first, then
// INT32_MAX on both planes up to the end of its region; slots past the
// last group's region are pads too.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/multiwaymerge.py
// `_mwaymerge_kernel` (reached through `multiway_merge`: keys-only with
// leaf prefetch for K2, `keys_only=False` with two FIFO trees and four
// head windows for K6, uniform lens or a dynamic `lens` vector), which
// streams each group through a FIFO heap tree in VMEM, one program per
// group.  Here a group spreads over the whole card: the last level of a
// 128M sort is one group.
//
// What bounds it on the H100: each element is read and written once in
// device memory (8 B a key, 16 B a pair), plus the co-rank scratch (one
// int64 a run a tile boundary).  The merge is bound by instruction issue,
// log2(W) merge steps an element, each taken by selects
// (merge_path.cuh's merge_rounds_select).  The coarse co-rank
// search is a chain of dependent loads over whole runs (one wave of
// warps, so its latency); the sampled fine co-ranks read about a quarter
// of the keys' sectors (a sample every 32 keys, 32-byte sectors) and
// their brackets (fewer than 2 W s elements a boundary), each in one
// round trip, and narrow in shared memory.
//
// Design: merge-path tiles of kTile outputs, three launches; the co-rank
// search and the tile merge are merge_path.cuh's, shared with K11.  K9
// (chunk_gated_merge.cu) runs the varlen mode's launches, its gate
// between the co-ranks and the tile merge.  The keys-only launches also
// come at tiles of 2,048 and 8,192 outputs (the entries' `tile`: the -m
// merge-buffer size picks one); pairs and every other caller take kTile
// = 4,096.
//   1. corank_kernel, coarse: one warp per coarse boundary b = min(t *
//      kTile, live) of a group, t a multiple of kCoarse, finds each run's
//      consumed prefix c[t][r] (ties go to the lower run), its windows
//      starting as the whole runs.
//   2. corank_kernel, fine, every other boundary, inside the windows the
//      two coarse boundaries around it leave (at most kCoarse tiles of
//      outputs): up to fan-in kSampledMaxFanin (32), one CTA a coarse
//      interval brackets every boundary from a regular sample of the
//      windows ranked in shared memory and finishes each in shared
//      memory (the design at kSampledMaxFanin below); above it (fan-in
//      64 to 2,048, keys, or 1,024, pairs) one warp a boundary runs the
//      coarse pass's search in the windows, whose sample would not fit
//      shared memory beside a stage of 2 W s elements a warp.
//   3. merge_kernel, one CTA per tile: it merges the tile's W segments
//      [c[t][r], c[t+1][r]) in shared memory, writes the tile back
//      coalesced, and writes the pads after the group's live elements.
// Pairs travel as one int64 whose signed order is the lexicographic order
// (smj_pack); the pad pair packs to LLONG_MAX, so a real payload equal to
// INT32_MAX or INT32_MIN still sorts before it.  Offsets are 64-bit.
#include "merge_path.cuh"

namespace {

using smj_mp::kTile;  // outputs a merge tile
// Threads of a merge tile of kTileN outputs: kTileN / 16 for keys (256 at
// kTile), 6 * kTile / kTileN CTAs an SM at least, so that the registers
// and the shared buffers an SM holds are the same at every tile; 512 for
// pairs (only at kTile), whose two 34 KB buffers allow 3 CTAs an SM
// (registers capped to fit: 44 allowed only 2).  Each thread merges
// kTileN / threads outputs a round.
template <typename E, int kTileN>
constexpr int kMergeThreads = sizeof(E) == 8 ? 512 : kTileN / 16;
template <typename E, int kTileN>
constexpr int kMergeMinBlocks = sizeof(E) == 8 ? 3 : 6 * kTile / kTileN;
constexpr int kCorankThreads = 256;
constexpr int kCoarse = 32;  // tiles between two coarse boundaries
constexpr int kMaxFanin = 2048;      // keys
constexpr int kMaxPairFanin = 1024;  // pairs
// shared memory of a co-rank CTA, at most: its warps' windows
constexpr long long kCorankSmem = 48 * 1024;

// The runs of one call.  Run r starts at r * stride; it holds lens[r]
// elements, or (lens null, the uniform layout) clip(total - r * stride, 0,
// stride).  p is null for keys only.
struct Runs {
  const int* k;
  const int* p;
  const int* lens;
  long long total;
  long long stride;

  __device__ __forceinline__ long long len(long long r) const {
    const long long l = lens != nullptr ? (long long)__ldg(lens + r)
                                        : total - r * stride;
    return l < 0 ? 0 : (l > stride ? stride : l);
  }

  __device__ __forceinline__ smj_mp::Cols<SmjLdgLoad> cols() const {
    return {k, p, SmjLdgLoad()};
  }
};

template <typename E>
__device__ __forceinline__ void store_elem(int* __restrict__ k,
                                           int* __restrict__ p, long long i,
                                           E v) {
  if constexpr (sizeof(E) == 8) {
    k[i] = smj_key(v);
    p[i] = smj_payload(v);
  } else {
    k[i] = v;
  }
}

// Warps of a co-rank CTA at fan-in W: as many as kCorankSmem holds
// windows for, at most kCorankThreads / 32.
int corank_warps(int W) {
  const long long per = smj_mp::corank_words(W) * 8;
  const long long w = kCorankSmem / per;
  return (int)(w < 1 ? 1 : (w > kCorankThreads / 32 ? kCorankThreads / 32
                                                     : w));
}

// c[g][t][r] for the boundaries t of every group (tpg + 1 of them a group:
// t = 0 .. tpg, tiles of kTileN outputs); coarse: t a multiple of
// kCoarse, and tpg; fine: every other t.  One warp a boundary, its
// starting windows in dynamic shared memory (kRegs, fan-in <= 32: the
// search then keeps them in registers).
template <typename E, bool kRegs, int kTileN>
__global__ void __launch_bounds__(kCorankThreads)
corank_kernel(Runs runs, long long* __restrict__ c, long long ngroups,
              long long tpg, int W, bool coarse) {
  extern __shared__ long long ws_all[];
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per = coarse ? (tpg + kCoarse - 1) / kCoarse + 1 : tpg + 1;
  if (warp >= ngroups * per) return;  // the same for the whole warp
  const long long g = warp / per;
  long long t = warp - g * per;
  if (coarse) {
    t = t * kCoarse < tpg ? t * kCoarse : tpg;
  } else if (t % kCoarse == 0 || t == tpg) {
    return;
  }
  long long* ws = ws_all + (threadIdx.x >> 5) * smj_mp::corank_words(W);
  long long* wlo = ws;
  long long* whi = ws + W;
  const long long run0 = g * W;
  long long live = 0;
  for (int r = lane; r < W; r += 32) live += runs.len(run0 + r);
  live = smj_mp::group_sum(live, 32);
  const long long b = t * kTileN < live ? t * kTileN : live;
  long long* row = c + (g * (tpg + 1) + t) * W;
  if (coarse) {
    for (int r = lane; r < W; r += 32) {
      wlo[r] = 0;
      whi[r] = runs.len(run0 + r);
    }
  } else {
    const long long t0 = t / kCoarse * kCoarse;
    const long long t1 = t0 + kCoarse < tpg ? t0 + kCoarse : tpg;
    const long long* lo_row = c + (g * (tpg + 1) + t0) * W;
    const long long* hi_row = c + (g * (tpg + 1) + t1) * W;
    for (int r = lane; r < W; r += 32) {
      wlo[r] = lo_row[r];
      whi[r] = hi_row[r];
    }
  }
  __syncwarp();
  smj_mp::corank<E, kRegs>(runs.cols(), run0 * runs.stride, runs.stride, W,
                           b, ws, row, lane);
}

// ---- The sampled fine co-ranks (fan-in <= kSampledMaxFanin) ----
//
// One CTA a coarse interval [t0, t1) of a group: the coarse rows c[t0]
// and c[t1] leave each run r a window [A_r, A_r + n_r), the interval's
// N = sum(n_r) outputs.  Window offset o of run r is "(r, o)".
//   a. Samples: the last element of every whole block of s elements (s =
//      sample_stride(W): 32 at fan-in 16 and 32, 512 / W below), offsets
//      (j + 1) s - 1 for j < m_r = n_r / s: M <= N / s independent copies
//      into shared memory (cp.async, one round trip).
//   b. Their order: the W sample lists merged in log2(W) pairwise rounds
//      of their indices, lower list first among equal values (the
//      merge's total order: value, then run, then offset), and each
//      sample's rank pos among the M.
//   c. Brackets: the first p samples in that order hold k_r(p) of run r
//      (a binary search of run r's pos).  With X = the p-th sample, the
//      k_r(p) s elements before each run's k_r(p)-th sample are <= X and
//      at most p s + W (s - 1) elements are < X; the (p + 1)-th sample Y
//      has at least p s + s - 1 elements below it.  So for boundary b'
//      (outputs from the interval's start) every run's share c_r lies in
//      [k_r(pa) s, k_r(pb) < m_r ? (k_r(pb) + 1) s - 1 : n_r] with pa =
//      max(0, ceil((b' - W (s - 1)) / s) - 1) and pb = floor(b' / s):
//      pb - pa <= W, so the brackets of one boundary hold fewer than 2 W
//      s elements together.
//   d. Exact finish: a warp a boundary copies its brackets into a stage
//      in shared memory (cp.async, one round trip) and narrows them there
//      (finish_candidates: each round ranks the middle elements of up to
//      kFinishCandidates windows in every window).  A bracket sum above
//      the stage (the bound above says never) runs smj_mp::corank's search
//      on the device columns instead and counts itself in
//      g_corank_fallbacks.
// Keys and payloads stay apart in shared memory (a pair is packed where
// it is compared).  The samples and tags share their shared memory with
// the stages, which are written once every bracket is known.
constexpr int kSampledMaxFanin = 32;  // one run a lane in the finish
constexpr int kSampleStride = 32;     // s at fan-in 16 and 32
// s at fan-in W, a power of two: fewer runs take a sparser sample, so
// that every fan-in up to 16 stages 2 W s = 32 kSampleStride elements a
// boundary at most
__host__ __device__ constexpr int sample_stride(int W) {
  return W >= 16 ? kSampleStride : kSampleStride * 16 / W;
}
constexpr int kFineThreads = 256;
constexpr int kFineWarps = kFineThreads / 32;
constexpr int kFinishCandidates = 8;  // finish_candidates' most a round
// 3 CTAs an SM: up to 85 registers a thread, so that the finish spills
// nothing (at 4, 64 registers, it kept 24 bytes of stack)
constexpr int kFineMinBlocks = 3;

__device__ unsigned long long g_corank_fallbacks;

struct SampledPass {};  // tags the sampled fine co-rank's launch

// Element i of int32 columns k (and p, for pairs) in shared memory.
template <typename E>
__device__ __forceinline__ E smem_at(const int* k, const int* p, int i) {
  if constexpr (sizeof(E) == 8) {
    return smj_pack(k[i], p[i]);
  } else {
    return k[i];
  }
}

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Samples of one interval at tiles of kTileN outputs, at most, and the
// tag slots of their merge: two spare slots after every kTagRun, one
// thread's outputs of a round, so that a warp's stores hit distinct
// banks.
template <int kTileN>
constexpr int kMaxSamples = kCoarse * kTileN / kSampleStride;
template <int kTileN>
constexpr int kTagRun = kMaxSamples<kTileN> / kFineThreads;
template <int kTileN>
constexpr int kTagSlots = kMaxSamples<kTileN> + 2 * kFineThreads;

template <int kTileN>
__device__ __forceinline__ int tag_slot(int p) {
  return p + 2 * (p / kTagRun<kTileN>);
}

// Shared memory of a sampled co-rank CTA at fan-in W: the pool (the
// samples' columns and two tag lists, or the warps' stages), then each
// warp's search words and bracket starts, the windows' starts A, the live
// total, the brackets [L, U) of every interior boundary and run, the
// windows' lengths, the sample offsets and each warp's stage offsets.
template <typename E, int kTileN>
__host__ __device__ constexpr size_t fine_pool_bytes(int W) {
  const size_t samples = (size_t)kMaxSamples<kTileN> * sizeof(E) +
                         2 * (size_t)kTagSlots<kTileN> * sizeof(short);
  const size_t stages = (size_t)kFineWarps * 2 * W * sample_stride(W) *
                        sizeof(E);
  return align16(samples > stages ? samples : stages);
}

// Scratch ints of one warp's finish_candidates at fan-in W.
__host__ __device__ constexpr int fin_words(int W) {
  return 2 * W + (W < kFinishCandidates ? W : kFinishCandidates) * (W + 1);
}

template <typename E, int kTileN>
__host__ __device__ constexpr size_t fine_smem(int W) {
  return fine_pool_bytes<E, kTileN>(W) +
         8 * ((size_t)kFineWarps * (smj_mp::corank_words(W) + W) + W + 1) +
         4 * ((size_t)2 * kCoarse * W + W + (W + 1) +
              (size_t)kFineWarps * (W + 1 + fin_words(W)));
}

// Entries of the ascending p[0, n) below v.
__device__ __forceinline__ int count_below(const unsigned short* p, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The whole CTA: merges the W sample lists (list r at [soff[r], soff[r +
// 1]) of the columns sk, sp, ascending) in log2(W) pairwise rounds of
// their indices between `from` (the identity) and `to`, output p at
// tag_slot(p), the lower list first among equal values; kTagRun outputs
// a thread a round.  Returns the buffer that holds the merged indices,
// after a __syncthreads.
template <typename E, int kTileN>
__device__ unsigned short* merge_sample_tags(const int* sk, const int* sp,
                                             const int* soff, int W,
                                             unsigned short* from,
                                             unsigned short* to) {
  constexpr int kPer = kTagRun<kTileN>;
  const auto at = [&](int t) { return smem_at<E>(sk, sp, t); };
  const auto tag = [&](const unsigned short* b, int p) -> int {
    return b[tag_slot<kTileN>(p)];
  };
  const int n = soff[W];
  const int p0 = threadIdx.x * kPer;
  for (int s = 1; s < W; s <<= 1) {
    if (p0 < n) {
      // the pair j holding output p0: the first whose end is past it
      int j = 0, jhi = W / (2 * s) - 1;
      while (j < jhi) {
        const int mid = (j + jhi) >> 1;
        if (soff[(mid + 1) * 2 * s] > p0) jhi = mid; else j = mid + 1;
      }
      int a0 = soff[j * 2 * s], b0 = soff[j * 2 * s + s];
      int e = soff[(j + 1) * 2 * s];
      int na = b0 - a0, nb = e - b0;
      const int d = p0 - a0;
      int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
      while (lo < hi) {  // co-rank of d in the pair, a winning ties
        const int mid = (lo + hi) >> 1;
        if (at(tag(from, a0 + mid)) <= at(tag(from, b0 + d - 1 - mid))) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int ia = lo, ib = d - lo;
      int ta = ia < na ? tag(from, a0 + ia) : 0;
      int tb = ib < nb ? tag(from, b0 + ib) : 0;
      E va = ia < na ? at(ta) : E(), vb = ib < nb ? at(tb) : E();
      for (int q = 0; q < kPer; ++q) {
        const int p = p0 + q;
        if (p >= n) break;
        while (p >= e) {  // into the next pair
          ++j;
          a0 = e;
          b0 = soff[j * 2 * s + s];
          e = soff[(j + 1) * 2 * s];
          na = b0 - a0;
          nb = e - b0;
          ia = ib = 0;
          ta = na > 0 ? tag(from, a0) : 0;
          tb = nb > 0 ? tag(from, b0) : 0;
          va = na > 0 ? at(ta) : E();
          vb = nb > 0 ? at(tb) : E();
        }
        if (ib >= nb || (ia < na && va <= vb)) {
          to[tag_slot<kTileN>(p)] = (unsigned short)ta;
          if (++ia < na) {
            ta = tag(from, a0 + ia);
            va = at(ta);
          }
        } else {
          to[tag_slot<kTileN>(p)] = (unsigned short)tb;
          if (++ib < nb) {
            tb = tag(from, b0 + ib);
            vb = at(tb);
          }
        }
      }
    }
    __syncthreads();
    unsigned short* x = from;
    from = to;
    to = x;
  }
  return from;
}

// One warp, fan-in W <= 32: row[r] = run r's share of the first b
// outputs, from the brackets staged in shared memory (the columns k, p):
// run r's positions [lo_r, lo_r + w_r) at stage slots [offs[r], offs[r +
// 1]), lo_r held by lane r, the brackets such that every element before
// one is among the first b outputs and none after one is.  Each round
// takes the middle element of C = min(W, kFinishCandidates) windows as
// candidates (the runs taking turns when W > C), and counts, in every
// window, the elements before each (ties to the lower run: the merge's
// order), 32 / C lanes a candidate.  A candidate whose counts sum to b
// gives the row; one below sums to less, and the windows' starts move
// past it, one above to more, and their ends move to it: every window at
// least halves in W / C rounds.  scratch: 2 W + C + C W ints of the
// warp's shared memory.
template <typename E>
__device__ void finish_candidates(const int* k, const int* p,
                                  const int* offs, int W, long long lo,
                                  long long b, int* scratch, long long* row,
                                  int lane) {
  const int C = W < kFinishCandidates ? W : kFinishCandidates;
  const int turns = W / C;  // rounds for every run to take a turn
  int* wl = scratch;  // the windows, stage slots
  int* wh = wl + W;
  int* fc = wh + W;   // each candidate's count, -1 for none
  int* cnt = fc + C;  // cnt[i * W + r]: run r's elements before candidate i
  const int LP = 32 / C;  // lanes a candidate
  const int ci = lane / LP, sub = lane - ci * LP;
  const int target = (int)(b - smj_mp::group_sum(lane < W ? lo : 0, 32));
  if (lane < W) {
    wl[lane] = offs[lane];
    wh[lane] = offs[lane + 1];
  }
  __syncwarp();
  for (int round = 0;; ++round) {
    int sl = 0, sh = 0;
    if (lane < W) {
      sl = wl[lane] - offs[lane];
      sh = wh[lane] - offs[lane];
    }
    sl = __reduce_add_sync(smj_mp::kFullWarp, sl);
    sh = __reduce_add_sync(smj_mp::kFullWarp, sh);
    if (sl == target || sh == target) {
      if (lane < W)
        row[lane] = lo + (sl == target ? wl[lane] : wh[lane]) - offs[lane];
      return;
    }
    const int turn = round % turns;
    const int c = ci * turns + turn;  // this lane's candidate's run
    const int lo_c = wl[c], hi_c = wh[c];
    const bool valid = lo_c < hi_c;
    const int mid = (lo_c + hi_c) >> 1;
    int part = 0;
    if (valid) {
      const E v = smem_at<E>(k, p, mid);
      for (int r = sub; r < W; r += LP) {
        int a = mid;
        if (r != c) {
          a = wl[r];
          int z = wh[r];
          while (a < z) {
            const int m = (a + z) >> 1;
            const E u = smem_at<E>(k, p, m);
            if (r < c ? u <= v : u < v) a = m + 1; else z = m;
          }
        }
        cnt[ci * W + r] = a;
        part += a - offs[r];
      }
    }
    for (int o = 1; o < LP; o <<= 1)
      part += __shfl_xor_sync(smj_mp::kFullWarp, part, o);
    if (sub == 0) fc[ci] = valid ? part : -1;
    __syncwarp();
    const unsigned hit =
        __ballot_sync(smj_mp::kFullWarp, valid && sub == 0 && part == target);
    if (hit != 0) {
      const int ce = (__ffs(hit) - 1) / LP;
      if (lane < W) row[lane] = lo + cnt[ce * W + lane] - offs[lane];
      return;
    }
    if (lane < W) {
      int nl = wl[lane], nh = wh[lane];
      for (int q = 0; q < C; ++q) {
        const int f = fc[q];
        if (f < 0) continue;
        const int x = cnt[q * W + lane];
        if (f < target) {  // candidate q is before the boundary
          const int y = x + (q * turns + turn == lane ? 1 : 0);
          nl = y > nl ? y : nl;
        } else {
          nh = x < nh ? x : nh;
        }
      }
      wl[lane] = nl;
      wh[lane] = nh;
    }
    __syncwarp();
  }
}

// c[g][t][r] for the interior boundaries t of each coarse interval [t0,
// t1) (t0 a multiple of kCoarse, t1 = min(t0 + kCoarse, tpg)), on the
// coarse rows c[t0] and c[t1]: one CTA an interval, fan-in W <=
// kSampledMaxFanin (the design above).
template <typename E, int kTileN>
__global__ void __launch_bounds__(kFineThreads, kFineMinBlocks)
corank_kernel(SampledPass, Runs runs, long long* __restrict__ c,
              long long ngroups, long long tpg, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = sample_stride(W), ls = __ffs(s) - 1;  // s = 2^ls
  constexpr int kM = kMaxSamples<kTileN>;
  constexpr bool kPairs = sizeof(E) == 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = (tpg + kCoarse - 1) / kCoarse;
  const long long g = blockIdx.x / per;
  const long long t0 = (blockIdx.x - g * per) * kCoarse;
  const long long t1 = t0 + kCoarse < tpg ? t0 + kCoarse : tpg;
  const int F = (int)(t1 - t0 - 1);  // interior boundaries
  if (g >= ngroups || F < 1) return;  // the same for the whole CTA
  unsigned char* pool = smem;
  long long* ws = reinterpret_cast<long long*>(
      smem + fine_pool_bytes<E, kTileN>(W));
  long long* wsrc = ws + kFineWarps * smj_mp::corank_words(W);
  long long* A = wsrc + kFineWarps * W;
  long long* live_s = A + W;
  int* brk = reinterpret_cast<int*>(live_s + 1);
  int* nlen = brk + 2 * kCoarse * W;
  int* soff = nlen + W;
  int* woff = soff + W + 1;
  int* wfin = woff + kFineWarps * (W + 1);  // finish_candidates' scratch
  int* sk = reinterpret_cast<int*>(pool);  // the samples' keys
  int* sp = sk + kM;                       // and payloads (pairs)
  unsigned short* tags0 = reinterpret_cast<unsigned short*>(
      sk + (kPairs ? 2 : 1) * kM);
  unsigned short* tags1 = tags0 + kTagSlots<kTileN>;
  const long long run0 = g * W;
  const long long* lo_row = c + (g * (tpg + 1) + t0) * W;
  const long long* hi_row = c + (g * (tpg + 1) + t1) * W;

  // the windows, the live total and the sample offsets (warp 0, W <= 32)
  if (warp == 0) {
    long long len = 0, a = 0;
    int n = 0;
    if (lane < W) {
      len = runs.len(run0 + lane);
      a = lo_row[lane];
      n = (int)(hi_row[lane] - a);
      A[lane] = a;
      nlen[lane] = n;
    }
    const long long live = smj_mp::group_sum(len, 32);
    int incl = n >> ls;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(smj_mp::kFullWarp, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane < W) soff[lane + 1] = incl;
    if (lane == 0) {
      soff[0] = 0;
      *live_s = live;
    }
  }
  __syncthreads();
  const int M = soff[W];
  const long long live = *live_s;
  const long long b0 = t0 * kTileN < live ? t0 * kTileN : live;

  // a. the samples, every copy in flight at once
  for (int r = 0; r < W; ++r) {
    const int s0 = soff[r], m = soff[r + 1] - s0;
    const long long base = (run0 + r) * runs.stride + A[r] + s - 1;
    for (int j = tid; j < m; j += kFineThreads) {
      const long long at = base + ((long long)j << ls);
      cp_async4(sk + s0 + j, runs.k + at);
      if constexpr (kPairs) cp_async4(sp + s0 + j, runs.p + at);
      tags0[tag_slot<kTileN>(s0 + j)] = (unsigned short)(s0 + j);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // b. their order, then each sample's rank
  const unsigned short* order = merge_sample_tags<E, kTileN>(
      sk, sp, soff, W, tags0, tags1);
  unsigned short* pos = order == tags0 ? tags1 : tags0;
  for (int p = tid; p < M; p += kFineThreads)
    pos[order[tag_slot<kTileN>(p)]] = (unsigned short)p;
  __syncthreads();

  // c. the brackets of every interior boundary and run
  for (int i = tid; i < F * W; i += kFineThreads) {
    const int f = i / W, r = i - f * W;
    const long long t = t0 + 1 + f;
    const long long b = t * kTileN < live ? t * kTileN : live;
    const long long bp = b - b0;  // <= N
    const long long x = bp - (long long)W * (s - 1);
    int pa = x <= 0 ? 0 : (int)((x - 1) >> ls);
    int pb = (int)(bp >> ls);
    pa = pa < M ? pa : M;
    pb = pb < M ? pb : M;
    const int m = soff[r + 1] - soff[r];
    const int ka = count_below(pos + soff[r], m, pa);
    const int kb = count_below(pos + soff[r], m, pb);
    brk[2 * i] = ka << ls;
    brk[2 * i + 1] = kb < m ? ((kb + 1) << ls) - 1 : nlen[r];
  }
  __syncthreads();  // the pool is the stages from here

  // d. a warp a boundary: stage its brackets, then the exact search
  int* stk = reinterpret_cast<int*>(reinterpret_cast<E*>(pool) +
                                    (size_t)warp * 2 * W * s);
  int* stp = stk + 2 * W * s;  // pairs: the payloads after the keys
  long long* wsw = ws + warp * smj_mp::corank_words(W);
  long long* src = wsrc + warp * W;
  int* offs = woff + warp * (W + 1);
  for (int f = warp; f < F; f += kFineWarps) {
    const long long t = t0 + 1 + f;
    const long long b = t * kTileN < live ? t * kTileN : live;
    long long* row = c + (g * (tpg + 1) + t) * W;
    int wid = 0;
    long long lo = 0;
    if (lane < W) {
      const int l = brk[2 * (f * W + lane)];
      wid = brk[2 * (f * W + lane) + 1] - l;
      lo = A[lane] + l;
      wsw[lane] = lo;
      wsw[W + lane] = lo + wid;
      src[lane] = (run0 + lane) * runs.stride + lo;
    }
    int incl = wid;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(smj_mp::kFullWarp, incl, o);
      if (lane >= o) incl += x;
    }
    const int total = __shfl_sync(smj_mp::kFullWarp, incl, 31);
    if (lane < W) offs[lane + 1] = incl;
    if (lane == 0) offs[0] = 0;
    __syncwarp();
    if (total <= 2 * W * s) {  // the same branch for the whole warp
      for (int r = 0; r < W; ++r) {
        const int o = offs[r], w = offs[r + 1] - o;
        for (int i = lane; i < w; i += 32) {
          cp_async4(stk + o + i, runs.k + src[r] + i);
          if constexpr (kPairs) cp_async4(stp + o + i, runs.p + src[r] + i);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      finish_candidates<E>(stk, stp, offs, W, lo, b,
                           wfin + warp * fin_words(W), row, lane);
    } else {
      if (lane == 0) atomicAdd(&g_corank_fallbacks, 1ULL);
      smj_mp::corank<E, true>(runs.cols(), run0 * runs.stride, runs.stride,
                              W, b, wsw, row, lane);
    }
    __syncwarp();
  }
}

// Dynamic shared memory of a merge tile of kTileN outputs: two buffers,
// then W segment starts (int64) and W + 1 segment offsets (int).  The
// wrapper's merge_smem_bytes is this sum for keys.
template <typename E, int kTileN>
constexpr size_t merge_smem(int W) {
  return 2 * smj_mp::buf_elems<E, kTileN>() * sizeof(E) + (size_t)W * 8 +
         (size_t)(W + 1) * 4;
}

// One CTA a tile: tiles [0, ngroups * tpg) merge tile t of group g, the
// rest write the pads past the last group's region.
template <typename E, int kTileN>
__global__ void __launch_bounds__(kMergeThreads<E, kTileN>,
                                  kMergeMinBlocks<E, kTileN>)
merge_kernel(Runs runs, const long long* __restrict__ c,
             int* __restrict__ out_k, int* __restrict__ out_p, long long cap,
             long long ngroups, long long tpg, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = kMergeThreads<E, kTileN>;
  E* buf0 = reinterpret_cast<E*>(smem);
  E* buf1 = buf0 + smj_mp::buf_elems<E, kTileN>();
  long long* src =
      reinterpret_cast<long long*>(buf1 + smj_mp::buf_elems<E, kTileN>());
  int* offs = reinterpret_cast<int*>(src + W);
  const int tid = threadIdx.x;
  const long long region = (long long)W * runs.stride;
  const long long tile = blockIdx.x;
  long long out0, end;  // the tile's first slot and the end of its slots
  int n = 0;            // live outputs of the tile
  if (tile < ngroups * tpg) {
    const long long g = tile / tpg;
    const long long t = tile - g * tpg;
    const long long d0 = t * kTileN;
    out0 = g * region + d0;
    end = out0 + (region - d0 < kTileN ? region - d0 : kTileN);
    const long long* row0 = c + (g * (tpg + 1) + t) * W;
    const long long* row1 = row0 + W;
    for (int r = tid; r < W; r += blockDim.x) {
      const long long a = row0[r];
      src[r] = (g * W + r) * runs.stride + a;
      offs[r + 1] = (int)(row1[r] - a);
    }
    __syncthreads();
    if (tid == 0) {
      offs[0] = 0;
      for (int r = 0; r < W; ++r) offs[r + 1] += offs[r];
    }
    __syncthreads();
    n = offs[W];
  } else {
    out0 = ngroups * region + (tile - ngroups * tpg) * kTileN;
    end = out0 + kTileN;
  }
  if (end > cap) end = cap;
  if (n > 0) {  // the same branch for the whole CTA
    const E* merged = smj_mp::merge_tile<E, kThreads, kTileN, true>(
        runs.cols(), src, offs, W, buf0, buf1);
    for (int p = tid; p < n; p += kThreads)
      store_elem<E>(out_k, out_p, out0 + p, merged[smj_mp::sw<E>(p)]);
  }
  for (long long i = out0 + n + tid; i < end; i += kThreads) {
    out_k[i] = SMJ_KEY_POS_INF;
    if constexpr (sizeof(E) == 8) out_p[i] = SMJ_KEY_POS_INF;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename E, int kTileN>
int launch_coranks(const Runs& runs, long long* c, long long ngroups,
                   long long tpg, int W, int parts, cudaStream_t s) {
  const long long warps[2] = {ngroups * (cdiv(tpg, kCoarse) + 1),
                              ngroups * (tpg + 1)};
  const int cta_warps = corank_warps(W);
  const size_t smem = (size_t)cta_warps * smj_mp::corank_words(W) * 8;
  if (W > 32 && smem > 48 * 1024) {  // fan-in 2,048: one warp's 64 KB
    const cudaError_t err = cudaFuncSetAttribute(
        corank_kernel<E, false, kTileN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int pass = 0; pass < 2; ++pass) {
    if ((parts & (1 << pass)) == 0) continue;
    if (pass == 1 && W <= kSampledMaxFanin) {  // the sampled fine pass
      void (*fine)(SampledPass, Runs, long long*, long long, long long,
                   int) = corank_kernel<E, kTileN>;
      const size_t fsmem = fine_smem<E, kTileN>(W);
      if (fsmem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
        if (err != cudaSuccess) return (int)err;
      }
      fine<<<(unsigned)(ngroups * cdiv(tpg, kCoarse)), kFineThreads, fsmem,
             s>>>(SampledPass{}, runs, c, ngroups, tpg, W);
      continue;
    }
    const long long blocks = cdiv(warps[pass], cta_warps);
    if (W <= 32) {  // one run a lane: the windows in registers
      corank_kernel<E, true, kTileN>
          <<<(unsigned)blocks, cta_warps * 32, smem, s>>>(
              runs, c, ngroups, tpg, W, pass == 0);
    } else {
      corank_kernel<E, false, kTileN>
          <<<(unsigned)blocks, cta_warps * 32, smem, s>>>(
              runs, c, ngroups, tpg, W, pass == 0);
    }
  }
  return (int)cudaSuccess;
}

// The three launches of one merge at tiles of kTileN outputs; c holds at
// least ngroups * (tpg + 1) * W int64s.  parts is a mask of the launches
// to make: 1 the coarse co-ranks, 2 the fine ones, 4 the tile merge (on
// the co-ranks c holds).
template <typename E, int kTileN>
int launch(const Runs& runs, int* out_k, int* out_p, long long* c,
           long long c_elems, long long cap, long long ngroups, int W,
           int parts, cudaStream_t s) {
  if (W < 2 || W > kMaxFanin || (W & (W - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long region = (long long)W * runs.stride;
  const long long tpg = cdiv(region, kTileN);
  if (c_elems < ngroups * (tpg + 1) * W) return (int)cudaErrorInvalidValue;
  const long long done = ngroups * region;
  const long long tiles = ngroups * tpg + (cap > done ? cdiv(cap - done,
                                                           kTileN) : 0);
  if (tiles > INT_MAX || ngroups * (tpg + 1) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int err0 = launch_coranks<E, kTileN>(runs, c, ngroups, tpg, W, parts,
                                             s);
  if (err0 != (int)cudaSuccess) return err0;
  if ((parts & 4) == 0) return (int)cudaGetLastError();
  const size_t smem = merge_smem<E, kTileN>(W);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<E, kTileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    merge_kernel<E, kTileN>
        <<<(unsigned)tiles, kMergeThreads<E, kTileN>, smem, s>>>(
            runs, c, out_k, out_p, cap, ngroups, tpg, W);
  }
  return (int)cudaGetLastError();
}

template <typename E, int kTileN>
int merge_occupancy(int* ctas) {
  const size_t smem = merge_smem<E, kTileN>(16);
  const cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<E, kTileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, merge_kernel<E, kTileN>, kMergeThreads<E, kTileN>, smem);
}

// tile: outputs a merge tile, kTile for pairs; 2,048, 4,096 or 8,192 for
// keys.  Pairs merge at fan-in kMaxPairFanin at most.
int launch_any(const Runs& runs, int* out_k, int* out_p, long long* c,
               long long c_elems, long long cap, long long ngroups,
               int fanin, int tile, int parts, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  if (parts < 1 || parts > 7) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (runs.p != nullptr) {
    if (tile != kTile || fanin > kMaxPairFanin)
      return (int)cudaErrorInvalidValue;
    return launch<long long, kTile>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
  }
  switch (tile) {
    case kTile / 2:
      return launch<int, kTile / 2>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
    case kTile:
      return launch<int, kTile>(runs, out_k, out_p, c, c_elems, cap, ngroups,
                                fanin, parts, s);
    case kTile * 2:
      return launch<int, kTile * 2>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Fine boundaries whose sampled brackets overflowed their stage since the
// last reset (the search then ran on the device columns), on the current
// card: the tests and the smoke read it; it synchronises.  -1 on error.
SMJ_API long long smj_corank_fallbacks(int reset) {
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_corank_fallbacks, sizeof(n)) !=
      cudaSuccess)
    return -1;
  if (reset) {
    const unsigned long long zero = 0;
    if (cudaMemcpyToSymbol(g_corank_fallbacks, &zero, sizeof(zero)) !=
        cudaSuccess)
      return -1;
  }
  return (long long)n;
}

// The CTAs an SM holds of the tile merge at `tile` outputs, keys only
// (pairs 0; 2,048, 4,096 or 8,192) or pairs (tile 4,096), at fan-in 16,
// into *ctas (a host int).
SMJ_API int smj_multiway_merge_occupancy(int tile, int pairs, int* ctas) {
  if (pairs) {
    return tile == kTile ? merge_occupancy<long long, kTile>(ctas)
                         : (int)cudaErrorInvalidValue;
  }
  switch (tile) {
    case kTile / 2:
      return merge_occupancy<int, kTile / 2>(ctas);
    case kTile:
      return merge_occupancy<int, kTile>(ctas);
    case kTile * 2:
      return merge_occupancy<int, kTile * 2>(ctas);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Elements (int64) of the co-rank scratch a merge of ngroups groups of
// `fanin` runs of `stride` slots needs at tiles of `tile` outputs
// (tile >= 1).
SMJ_API long long smj_multiway_merge_scratch(long long ngroups,
                                             long long stride, int fanin,
                                             int tile) {
  if (tile < 1) return -1;
  return ngroups * (cdiv((long long)fanin * stride, tile) + 1) * fanin;
}

// Merges in_k (and in_p, or NULL for keys only) [0, total), runs of
// `span`, group by group into out_k (out_p) [0, cap); cap >= total.
// tile: outputs a merge tile, kTile with pairs; 2,048, 4,096 or 8,192
// for keys.  scratch: scratch_elems >= smj_multiway_merge_scratch(...,
// tile) int64s on the card.  parts is 7; a mask of 1 (coarse co-ranks),
// 2 (fine co-ranks) and 4 (tile merge) runs only those launches, for
// timing each.  The wrapper makes the tensors' card current.
SMJ_API int smj_multiway_merge(const int* in_k, const int* in_p, int* out_k,
                               int* out_p, long long* scratch,
                               long long scratch_elems, long long cap,
                               long long total, long long span, int fanin,
                               int tile, int parts, void* stream) {
  if (span < 1 || fanin < 2) return (int)cudaErrorInvalidValue;
  const long long nruns = total > 0 ? cdiv(total, span) : 1;
  const Runs runs{in_k, in_p, nullptr, total, span};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    cdiv(nruns, fanin), fanin, tile, parts, stream);
}

// The varlen mode: run r at r * stride holds lens[r] elements (lens an
// int32 device vector of nruns entries, nruns a multiple of fanin);
// cap >= nruns * stride.  tile as for smj_multiway_merge.
SMJ_API int smj_multiway_merge_varlen(const int* in_k, const int* in_p,
                                      int* out_k, int* out_p,
                                      long long* scratch,
                                      long long scratch_elems, long long cap,
                                      const int* lens, long long nruns,
                                      long long stride, int fanin, int tile,
                                      int parts, void* stream) {
  if (stride < 1 || fanin < 2 || nruns % fanin != 0)
    return (int)cudaErrorInvalidValue;
  const Runs runs{in_k, in_p, lens, 0, stride};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    nruns / fanin, fanin, tile, parts, stream);
}
