// K4: one pairwise merge pass.  The run pairs (2j, 2j+1) of a uniform-lens
// layout merge into runs of twice the length, keys only or (key, payload)
// pairs in lexicographic order, ascending or descending.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/sort.py
// `_merge_pass_kernel` / `_merge_pair_body` (reached through `merge_pass`,
// keys-only and with payloads).  There one program per run pair streams an
// (asc, desc) pair through VMEM windows and a log2(T)-stage bitonic merge.
// Run r starts at r * span and holds clip(total - r * span, 0, span)
// elements; output run j starts at 2j * span.
//
// What bounds it on the H100: each element is read and written once (8 B
// per key, 16 B per pair), so a pass is bound by device-memory bandwidth.
// The tile splits cost one search per tile, not one per element.
//
// Design: merge-path tiles.  Each CTA owns kTile consecutive outputs of one
// pair.  Warps 0 and 1 find the co-ranks of the tile's first and last
// output (how many of them come from run A) by a 32-way search: each round
// the warp probes 32 candidates at once and keeps the interval the ballot
// points to.  The CTA then loads the A and B windows of the tile into
// shared memory with coalesced loads; each thread finds its own co-rank in
// shared memory by binary search, merges kPerThread outputs serially into
// registers, and the tile is written back coalesced.  A run without a
// partner (odd run count, or the last run of the two-run layout) is copied
// through.  Pairs travel as one int64 whose signed order is the
// lexicographic order (smj_pack).  Ties go to run A; in pair mode equal
// elements are identical, so the output is fixed exactly.  Output slots
// from `total` to the end of the buffer get the pad that sorts last in the
// pass's direction.  The TPU's (asc, desc) run pairs, `flip` and `b_asc`
// existed because Mosaic has no reverse: here both runs of a pair go the
// output's direction.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // outputs per CTA
constexpr unsigned kFullWarp = 0xffffffffu;

// One element: an int32 key (keys only) or a packed (key, payload) pair.
template <typename T>
__device__ __forceinline__ T load_elem(const int* __restrict__ k,
                                       const int* __restrict__ p,
                                       long long i) {
  if constexpr (sizeof(T) == 8) {
    return smj_pack(__ldg(k + i), __ldg(p + i));
  } else {
    return __ldg(k + i);
  }
}

template <typename T>
__device__ __forceinline__ void store_elem(int* __restrict__ k,
                                           int* __restrict__ p, long long i,
                                           T v) {
  if constexpr (sizeof(T) == 8) {
    k[i] = smj_key(v);
    p[i] = smj_payload(v);
  } else {
    k[i] = v;
  }
}

template <typename T>
__device__ __forceinline__ T pad_value(bool desc) {
  if constexpr (sizeof(T) == 8) {
    return desc ? LLONG_MIN : LLONG_MAX;
  } else {
    return desc ? SMJ_KEY_NEG_INF : SMJ_KEY_POS_INF;
  }
}

// a is output before b; run A wins ties.
template <typename T>
__device__ __forceinline__ bool before(T a, T b, bool desc) {
  return desc ? a >= b : a <= b;
}

// Co-rank of diagonal d of merge(A[0, la), B[0, lb)): how many of its first
// d outputs come from A (runs at a0 and b0 of the device columns).  Called
// by a whole warp; returns the same value in every lane.
template <typename T>
__device__ long long warp_co_rank(const int* __restrict__ k,
                                  const int* __restrict__ p, long long a0,
                                  long long la, long long b0, long long lb,
                                  long long d, bool desc) {
  const int lane = threadIdx.x & 31;
  long long lo = d > lb ? d - lb : 0;
  long long hi = d < la ? d : la;
  // invariant: the co-rank lies in [lo, hi]; A[i] is among the first d
  // outputs iff it goes before B[d - 1 - i], true for i below the co-rank
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long i = lo + lane * step;
    const bool in = i < hi && before(load_elem<T>(k, p, a0 + i),
                                     load_elem<T>(k, p, b0 + d - 1 - i),
                                     desc);
    const int c = __popc(__ballot_sync(kFullWarp, in));
    if (c == 0) {
      hi = lo;
    } else {
      const long long last_in = lo + (c - 1) * step;
      const long long first_out = last_in + step;
      lo = last_in + 1;
      if (first_out < hi) hi = first_out;
    }
  }
  return lo;
}

// The same co-rank over two windows in shared memory, one thread.
template <typename T>
__device__ __forceinline__ int co_rank(const T* a, int na, const T* b, int nb,
                                       int d, bool desc) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(a[mid], b[d - 1 - mid], desc)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ long long run_len(long long total, long long start,
                                             long long span) {
  const long long left = total - start;
  return left < 0 ? 0 : (left < span ? left : span);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_pass_kernel(const int* __restrict__ in_k, const int* __restrict__ in_p,
                  int* __restrict__ out_k, int* __restrict__ out_p,
                  long long cap, long long total, long long span,
                  long long tiles_per_pair, bool desc) {
  __shared__ T buf[kTile];
  __shared__ long long split[2];
  const long long pair = blockIdx.x / tiles_per_pair;
  const long long d0 = (blockIdx.x % tiles_per_pair) * (long long)kTile;
  const long long a0 = 2 * pair * span;
  const long long b0 = a0 + span;
  const long long la = run_len(total, a0, span);
  const long long lb = run_len(total, b0, span);
  const long long len = la + lb;
  if (d0 < len) {  // the same branch for the whole CTA
    const long long d1 = d0 + kTile < len ? d0 + kTile : len;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const long long s = warp_co_rank<T>(in_k, in_p, a0, la, b0, lb,
                                          warp == 0 ? d0 : d1, desc);
      if ((threadIdx.x & 31) == 0) split[warp] = s;
    }
    __syncthreads();
    const long long i0 = split[0];
    const int n = (int)(d1 - d0);
    const int na = (int)(split[1] - i0);
    const int nb = n - na;
    for (int t = threadIdx.x; t < na; t += kThreads)
      buf[t] = load_elem<T>(in_k, in_p, a0 + i0 + t);
    for (int t = threadIdx.x; t < nb; t += kThreads)
      buf[na + t] = load_elem<T>(in_k, in_p, b0 + (d0 - i0) + t);
    __syncthreads();
    T v[kPerThread];
    const int k0 = threadIdx.x * kPerThread;
    if (k0 < n) {
      int ia = co_rank(buf, na, buf + na, nb, k0, desc);
      int ib = k0 - ia;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (k0 + j < n) {
          const bool take_a =
              ib >= nb || (ia < na && before(buf[ia], buf[na + ib], desc));
          v[j] = take_a ? buf[ia++] : buf[na + ib++];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (k0 + j < n) buf[k0 + j] = v[j];
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads)
      store_elem<T>(out_k, out_p, a0 + d0 + t, buf[t]);
  }
  // slots of this tile past the pair's live length (only after `total`)
  const long long tile_end = d0 + kTile < 2 * span ? d0 + kTile : 2 * span;
  const long long pad_to = a0 + tile_end < cap ? a0 + tile_end : cap;
  const T pad = pad_value<T>(desc);
  for (long long g = a0 + (d0 > len ? d0 : len) + threadIdx.x; g < pad_to;
       g += kThreads)
    store_elem<T>(out_k, out_p, g, pad);
}

}  // namespace

// One merge pass over in_k (and in_p, or NULL for keys only) [0, total)
// with runs of `span`, into out_k (out_p) [0, cap).  The wrapper checks
// that cap <= npairs * 2 * span and makes the tensors' card current.
SMJ_API int smj_merge_pass(const int* in_k, const int* in_p, int* out_k,
                           int* out_p, long long cap, long long total,
                           long long span, int descending, void* stream) {
  long long nruns = (total + span - 1) / span;
  if (nruns < 1) nruns = 1;
  const long long npairs = (nruns + 1) / 2;
  const long long tiles_per_pair = (2 * span + kTile - 1) / kTile;
  const long long blocks = npairs * tiles_per_pair;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_p == nullptr) {
    merge_pass_kernel<int><<<(unsigned)blocks, kThreads, 0, s>>>(
        in_k, in_p, out_k, out_p, cap, total, span, tiles_per_pair,
        descending != 0);
  } else {
    merge_pass_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        in_k, in_p, out_k, out_p, cap, total, span, tiles_per_pair,
        descending != 0);
  }
  return (int)cudaGetLastError();
}
