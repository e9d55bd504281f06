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
// int64 a run a tile boundary).  The merge is bound by shared memory and
// instruction issue, log2(W) merge steps an element, and the co-rank
// search by dependent loads.
//
// Design: merge-path tiles of kTile outputs, three launches.
//   1. corank_kernel, coarse: one warp per coarse boundary b = min(t *
//      kTile, live) of a group, t a multiple of kCoarse, finds each run's
//      consumed prefix c[t][r] (how many of the group's first b outputs
//      come from run r; ties go to the lower run).  The search narrows the
//      value of output b - 1 between the smallest and largest element of
//      the runs' windows [lo_r, hi_r) and narrows the windows with it: a
//      run's elements <= a probe below output b - 1 go before the
//      boundary, its elements > a probe above it after.  The warp splits
//      into 32 / W groups of W lanes (one lane a run; W > 32: 32 lanes,
//      several runs a lane), each group tries its own probe, so a round
//      cuts the value range into 32 / W + 1 parts.  The range is re-read
//      from the windows' ends each round, and the search stops once the
//      windows' starts or ends sum to b.
//   2. corank_kernel, fine: the same search for every other boundary,
//      inside the windows the two coarse boundaries around it leave: at
//      most kCoarse tiles of outputs, not the whole run.
//   3. merge_kernel, one CTA per tile: it loads the tile's W segments
//      [c[t][r], c[t+1][r]) into shared memory with coalesced loads,
//      merges them in log2(W) rounds of pairwise merge path between two
//      buffers (each thread finds its co-rank by binary search, then merges
//      kPerThread outputs serially, the two heads in registers; A, the
//      lower runs, wins ties, so the rounds keep run order among equal
//      elements), writes the tile back coalesced, and writes the pads
//      after the group's live elements.
// Pairs travel as one int64 whose signed order is the lexicographic order
// (smj_pack); the pad pair packs to LLONG_MAX, so a real payload equal to
// INT32_MAX or INT32_MIN still sorts before it.  Offsets are 64-bit.
#include "smj_common.cuh"

namespace {

constexpr int kTile = 4096;  // outputs a merge tile
// Threads of a merge tile: 256 for keys, at least 6 CTAs an SM (their
// registers capped to fit); 512 for pairs, whose two 34 KB buffers allow
// only 3 CTAs an SM.  Each thread merges kTile / threads outputs a round.
template <typename E>
constexpr int kMergeThreads = sizeof(E) == 8 ? 512 : 256;
template <typename E>
constexpr int kMergeMinBlocks = sizeof(E) == 8 ? 1 : 6;
constexpr int kCorankThreads = 256;
constexpr int kCoarse = 32;  // tiles between two coarse boundaries
constexpr int kMaxFanin = 1024;
constexpr unsigned kFullWarp = 0xffffffffu;

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
};

// Element i of the columns as a value: the key (K2) or the packed pair
// (K6).
template <typename E>
__device__ __forceinline__ E load_elem(const Runs& runs, long long i) {
  if constexpr (sizeof(E) == 8) {
    return smj_pack(__ldg(runs.k + i), __ldg(runs.p + i));
  } else {
    return __ldg(runs.k + i);
  }
}

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

// First index in [lo, hi) of the run at `base` whose value is > v (kUpper)
// or >= v.
template <typename E, bool kUpper>
__device__ __forceinline__ long long run_bound(const Runs& runs,
                                               long long base, long long lo,
                                               long long hi, long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long m = load_elem<E>(runs, base + mid);
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

// c[g][t][r] for the boundaries t of every group (tpg + 1 of them a group:
// t = 0 .. tpg); coarse: t a multiple of kCoarse, and tpg; fine: every
// other t.  One warp a boundary.  The warp splits into P = 32 / G groups
// of G = min(W, 32) lanes; lane rl of a group covers runs rl + 32 j, j <
// kRpl, and every group tries its own probe value each round, so a round
// cuts the value range into P + 1 parts, not two.
template <typename E, int kRpl>
__global__ void __launch_bounds__(kCorankThreads)
corank_kernel(Runs runs, long long* __restrict__ c, long long ngroups,
              long long tpg, int W, bool coarse) {
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
  const int G = W < 32 ? W : 32;
  const int P = 32 / G;
  const int probe = lane / G;
  const int rl = lane % G;
  const long long run0 = g * W;
  long long len[kRpl], wlo[kRpl], whi[kRpl];
  long long live = 0;
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const int r = j * 32 + rl;
    len[j] = r < W ? runs.len(run0 + r) : 0;
    live += len[j];
  }
  live = group_sum(live, G);
  const long long b = t * kTile < live ? t * kTile : live;
  long long* row = c + (g * (tpg + 1) + t) * W;
  if (coarse) {
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      wlo[j] = 0;
      whi[j] = len[j];
    }
  } else {
    const long long t0 = t / kCoarse * kCoarse;
    const long long t1 = t0 + kCoarse < tpg ? t0 + kCoarse : tpg;
    const long long* lo_row = c + (g * (tpg + 1) + t0) * W;
    const long long* hi_row = c + (g * (tpg + 1) + t1) * W;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const int r = j * 32 + rl;
      wlo[j] = r < W ? lo_row[r] : 0;
      whi[j] = r < W ? hi_row[r] : 0;
    }
  }
  // Invariant: sum(wlo) <= b <= sum(whi); every element before wlo is
  // among the first b outputs and every one of them lies before whi; the
  // value of output b - 1 lies in [vlo, vhi].
  long long vlo = LLONG_MIN, vhi = LLONG_MAX;
  for (;;) {
    long long slo = 0, shi = 0, mn = LLONG_MAX, mx = LLONG_MIN;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const long long base = (run0 + j * 32 + rl) * runs.stride;
      slo += wlo[j];
      shi += whi[j];
      if (whi[j] > wlo[j]) {
        const long long lo_v = load_elem<E>(runs, base + wlo[j]);
        const long long hi_v = load_elem<E>(runs, base + whi[j] - 1);
        mn = lo_v < mn ? lo_v : mn;
        mx = hi_v > mx ? hi_v : mx;
      }
    }
    slo = group_sum(slo, G);
    shi = group_sum(shi, G);
    if (slo == b || shi == b) {
      if (probe == 0) {
#pragma unroll
        for (int j = 0; j < kRpl; ++j) {
          const int r = j * 32 + rl;
          if (r < W) row[r] = slo == b ? wlo[j] : whi[j];
        }
      }
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
    long long u[kRpl], cnt = 0;
#pragma unroll
    for (int j = 0; j < kRpl; ++j) {
      const long long base = (run0 + j * 32 + rl) * runs.stride;
      u[j] = run_bound<E, true>(runs, base, wlo[j], whi[j], mid);
      cnt += u[j];
    }
    cnt = group_sum(cnt, G);
    const unsigned exact = __ballot_sync(kFullWarp, cnt == b);
    if (exact != 0) {  // the elements <= that probe are the first b
      const int src = (__ffs(exact) - 1) / G * G + rl;
#pragma unroll
      for (int j = 0; j < kRpl; ++j) {
        const long long v = __shfl_sync(kFullWarp, u[j], src);
        const int r = j * 32 + rl;
        if (probe == 0 && r < W) row[r] = v;
      }
      return;
    }
    // the probes below output b - 1 raise the windows' starts, the first
    // one above it lowers their ends
    const int below = __popc(__ballot_sync(kFullWarp, cnt < b)) / G;
    if (below > 0) {
      const int src = (below - 1) * G + rl;
#pragma unroll
      for (int j = 0; j < kRpl; ++j)
        wlo[j] = __shfl_sync(kFullWarp, u[j], src);
      vlo = __shfl_sync(kFullWarp, mid, src) + 1;
    }
    if (below < P) {
      const int src = below * G + rl;
#pragma unroll
      for (int j = 0; j < kRpl; ++j)
        whi[j] = __shfl_sync(kFullWarp, u[j], src);
      vhi = __shfl_sync(kFullWarp, mid, src);
    }
  }
  // output b - 1 has the value v = vlo: every run gives its elements < v,
  // then the elements == v fill the rest of the prefix in run order
  long long lt[kRpl], eq[kRpl], less = 0;
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const long long base = (run0 + j * 32 + rl) * runs.stride;
    lt[j] = run_bound<E, false>(runs, base, wlo[j], whi[j], vlo);
    eq[j] = run_bound<E, true>(runs, base, lt[j], whi[j], vlo) - lt[j];
    less += lt[j];
  }
  long long left = b - group_sum(less, G);
#pragma unroll
  for (int j = 0; j < kRpl; ++j) {
    const int r = j * 32 + rl;
    const long long incl = group_inclusive_sum(eq[j], G, rl);
    long long take = left - (incl - eq[j]);
    take = take < 0 ? 0 : (take > eq[j] ? eq[j] : take);
    if (probe == 0 && r < W) row[r] = lt[j] + take;
    left -= __shfl_sync(kFullWarp, incl, probe * G + G - 1);
    if (left < 0) left = 0;
  }
}

// Slot of tile position p in a shared buffer: one spare element after
// every 128 bytes, so that a warp's threads, each writing its own run of
// kPerThread outputs, hit distinct banks.
template <typename E>
__device__ __forceinline__ int sw(int p) {
  return p + (p >> (sizeof(E) == 8 ? 4 : 5));
}

template <typename E>
__host__ __device__ constexpr int buf_elems() {
  return kTile + kTile / (sizeof(E) == 8 ? 16 : 32);
}

// Co-rank of diagonal d of merge(buf[a0, a0 + na), buf[b0, b0 + nb)) in
// shared memory: how many of its first d outputs come from a (a wins
// ties).
template <typename E>
__device__ __forceinline__ int co_rank(const E* buf, int a0, int na, int b0,
                                       int nb, int d) {
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

// Dynamic shared memory of a merge tile: two buffers, then W segment
// starts (int64) and W + 1 segment offsets (int).
template <typename E>
constexpr size_t merge_smem(int W) {
  return 2 * buf_elems<E>() * sizeof(E) + (size_t)W * 8 +
         (size_t)(W + 1) * 4;
}

// One CTA a tile: tiles [0, ngroups * tpg) merge tile t of group g, the
// rest write the pads past the last group's region.
template <typename E>
__global__ void __launch_bounds__(kMergeThreads<E>, kMergeMinBlocks<E>)
merge_kernel(Runs runs, const long long* __restrict__ c,
             int* __restrict__ out_k, int* __restrict__ out_p, long long cap,
             long long ngroups, long long tpg, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = kMergeThreads<E>;
  constexpr int kPerThread = kTile / kThreads;
  E* buf0 = reinterpret_cast<E*>(smem);
  E* buf1 = buf0 + buf_elems<E>();
  long long* src = reinterpret_cast<long long*>(buf1 + buf_elems<E>());
  int* offs = reinterpret_cast<int*>(src + W);
  const int tid = threadIdx.x;
  const long long region = (long long)W * runs.stride;
  const long long tile = blockIdx.x;
  long long out0, end;  // the tile's first slot and the end of its slots
  int n = 0;            // live outputs of the tile
  if (tile < ngroups * tpg) {
    const long long g = tile / tpg;
    const long long t = tile - g * tpg;
    const long long d0 = t * kTile;
    out0 = g * region + d0;
    end = out0 + (region - d0 < kTile ? region - d0 : kTile);
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
    out0 = ngroups * region + (tile - ngroups * tpg) * kTile;
    end = out0 + kTile;
  }
  if (end > cap) end = cap;
  if (n > 0) {  // the same branch for the whole CTA
    // coalesced load of the segments: slot p of the tile comes from the
    // segment s with offs[s] <= p < offs[s + 1]
    int lo = 0, hi = W;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offs[mid] <= tid) lo = mid; else hi = mid;
    }
    E v[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int p = tid + q * kThreads;
      if (p < n) {
        while (offs[lo + 1] <= p) ++lo;
        v[q] = load_elem<E>(runs, src[lo] + (p - offs[lo]));
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int p = tid + q * kThreads;
      if (p < n) buf0[sw<E>(p)] = v[q];
    }
    __syncthreads();
    // log2(W) rounds: merge pairs of s-segment runs from `from` into `to`
    E* from = buf0;
    E* to = buf1;
    const int p0 = tid * kPerThread;
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
        int ia = co_rank(from, a0, na, b0, nb, p0 - a0);
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
    for (int p = tid; p < n; p += kThreads)
      store_elem<E>(out_k, out_p, out0 + p, from[sw<E>(p)]);
  }
  for (long long i = out0 + n + tid; i < end; i += kThreads) {
    out_k[i] = SMJ_KEY_POS_INF;
    if constexpr (sizeof(E) == 8) out_p[i] = SMJ_KEY_POS_INF;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename E, int kRpl>
void launch_coranks(const Runs& runs, long long* c, long long ngroups,
                    long long tpg, int W, int parts, cudaStream_t s) {
  const long long warps[2] = {ngroups * (cdiv(tpg, kCoarse) + 1),
                              ngroups * (tpg + 1)};
  for (int pass = 0; pass < 2; ++pass) {
    if ((parts & (1 << pass)) == 0) continue;
    const long long blocks = cdiv(warps[pass] * 32, kCorankThreads);
    corank_kernel<E, kRpl><<<(unsigned)blocks, kCorankThreads, 0, s>>>(
        runs, c, ngroups, tpg, W, pass == 0);
  }
}

// The three launches of one merge; c holds at least ngroups * (tpg + 1) *
// W int64s.  parts is a mask of the launches to make: 1 the coarse
// co-ranks, 2 the fine ones, 4 the tile merge (on the co-ranks c holds).
template <typename E>
int launch(const Runs& runs, int* out_k, int* out_p, long long* c,
           long long c_elems, long long cap, long long ngroups, int W,
           int parts, cudaStream_t s) {
  if (W < 2 || W > kMaxFanin || (W & (W - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long region = (long long)W * runs.stride;
  const long long tpg = cdiv(region, kTile);
  if (c_elems < ngroups * (tpg + 1) * W) return (int)cudaErrorInvalidValue;
  const long long done = ngroups * region;
  const long long tiles = ngroups * tpg + (cap > done ? cdiv(cap - done,
                                                           kTile) : 0);
  if (tiles > INT_MAX || cdiv(ngroups * (tpg + 1) * 32, kCorankThreads) >
                             INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (W <= 32) {
    launch_coranks<E, 1>(runs, c, ngroups, tpg, W, parts, s);
  } else {
    launch_coranks<E, kMaxFanin / 32>(runs, c, ngroups, tpg, W, parts, s);
  }
  if ((parts & 4) == 0) return (int)cudaGetLastError();
  const size_t smem = merge_smem<E>(W);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    merge_kernel<E><<<(unsigned)tiles, kMergeThreads<E>, smem, s>>>(
        runs, c, out_k, out_p, cap, ngroups, tpg, W);
  }
  return (int)cudaGetLastError();
}

int launch_any(const Runs& runs, int* out_k, int* out_p, long long* c,
               long long c_elems, long long cap, long long ngroups,
               int fanin, int parts, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  if (parts < 1 || parts > 7) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return runs.p == nullptr
             ? launch<int>(runs, out_k, out_p, c, c_elems, cap, ngroups,
                           fanin, parts, s)
             : launch<long long>(runs, out_k, out_p, c, c_elems, cap,
                                 ngroups, fanin, parts, s);
}

}  // namespace

// Elements (int64) of the co-rank scratch a merge of ngroups groups of
// `fanin` runs of `stride` slots needs.
SMJ_API long long smj_multiway_merge_scratch(long long ngroups,
                                             long long stride, int fanin) {
  return ngroups * (cdiv((long long)fanin * stride, kTile) + 1) * fanin;
}

// Merges in_k (and in_p, or NULL for keys only) [0, total), runs of
// `span`, group by group into out_k (out_p) [0, cap); cap >= total.
// scratch: scratch_elems int64s on the card.  parts is 7; a mask of 1
// (coarse co-ranks), 2 (fine co-ranks) and 4 (tile merge) runs only those
// launches, for timing each.  The wrapper makes the tensors' card current.
SMJ_API int smj_multiway_merge(const int* in_k, const int* in_p, int* out_k,
                               int* out_p, long long* scratch,
                               long long scratch_elems, long long cap,
                               long long total, long long span, int fanin,
                               int parts, void* stream) {
  if (span < 1 || fanin < 2) return (int)cudaErrorInvalidValue;
  const long long nruns = total > 0 ? cdiv(total, span) : 1;
  const Runs runs{in_k, in_p, nullptr, total, span};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    cdiv(nruns, fanin), fanin, parts, stream);
}

// The varlen mode: run r at r * stride holds lens[r] elements (lens an
// int32 device vector of nruns entries, nruns a multiple of fanin);
// cap >= nruns * stride.
SMJ_API int smj_multiway_merge_varlen(const int* in_k, const int* in_p,
                                      int* out_k, int* out_p,
                                      long long* scratch,
                                      long long scratch_elems, long long cap,
                                      const int* lens, long long nruns,
                                      long long stride, int fanin,
                                      int parts, void* stream) {
  if (stride < 1 || fanin < 2 || nruns % fanin != 0)
    return (int)cudaErrorInvalidValue;
  const Runs runs{in_k, in_p, lens, 0, stride};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    nruns / fanin, fanin, parts, stream);
}
