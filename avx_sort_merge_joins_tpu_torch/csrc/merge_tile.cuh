// The merge-path tile of the gated merge K9 (chunk_gated_merge.cu): the
// W-way co-rank search of one tile boundary and the rank-scatter merge of
// one tile in shared memory.  W ascending strips lie `stride` slots apart
// in a landing buffer.  (K2, K6 and K11 use merge_path.cuh's search and
// pairwise tile merge, and the two loads below.)
//
// Both are templated on the load of the landing.  K9's landing is fixed
// during its launch and goes through the read-only path (SmjLdgLoad, an
// __ldg); K11's is written during its launch by other CTAs, so no read of
// it may take that path (SmjPlainLoad, a plain coherent load).  That is
// also why the searches here do not call smj_common.cuh's bounds, which
// read with __ldg.
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

__device__ __forceinline__ long long smj_warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long smj_warp_inclusive_sum(long long v,
                                                            int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// First index in a[lo, hi) whose key is >= key (upper false) or > key
// (upper true), each key read by `ld`.
template <class Load>
__device__ __forceinline__ long long smj_bound_by(Load ld, const int* a,
                                                  long long lo, long long hi,
                                                  int key, bool upper) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int v = ld(a + mid);
    if (upper ? v <= key : v < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over a shared-memory slice a[lo, hi).
__device__ __forceinline__ int smj_shared_bound(const int* a, int lo, int hi,
                                                int key, bool upper) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (upper ? a[mid] <= key : a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One warp: c[r] = strip r's share of the first b of `total` merged keys,
// strip r live on land[r * stride, r * stride + len(r)), the lanes
// covering strips lane, lane + 32, ...  A binary search over the key
// domain finds v, the key at merged position b - 1; each strip gives its
// keys < v, then keys == v in strip order up to b (ties go to the lower
// strip, as K2's do).
template <class Load, class Len>
__device__ void smj_corank(Load ld, const int* land, Len len, long long* c,
                           long long b, long long total, long long stride,
                           int W, int lane) {
  if (b == 0 || b == total) {
    for (int r = lane; r < W; r += 32) c[r] = b == 0 ? 0 : len(r);
    return;
  }
  // v: the smallest key with at least b keys <= v in all strips
  long long lo = INT_MIN, hi = INT_MAX;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    long long cnt = 0;
    for (int r = lane; r < W; r += 32) {
      const long long s = (long long)r * stride;
      cnt += smj_bound_by(ld, land, s, s + len(r), (int)mid, true) - s;
    }
    if (smj_warp_sum(cnt) >= b) hi = mid; else lo = mid + 1;
  }
  const int v = (int)lo;
  long long less = 0;
  for (int r = lane; r < W; r += 32) {
    const long long s = (long long)r * stride;
    less += smj_bound_by(ld, land, s, s + len(r), v, false) - s;
  }
  // keys == v fill the rest of the prefix in strip order
  long long left = b - smj_warp_sum(less);
  for (int base = 0; base < W; base += 32) {
    const int r = base + lane;
    long long lt = 0, eq = 0;
    if (r < W) {
      const long long s = (long long)r * stride;
      const long long e = s + len(r);
      lt = smj_bound_by(ld, land, s, e, v, false) - s;
      eq = smj_bound_by(ld, land, s, e, v, true) - s - lt;
    }
    const long long incl = smj_warp_inclusive_sum(eq, lane);
    long long take = left - (incl - eq);
    take = take < 0 ? 0 : (take > eq ? eq : take);
    if (r < W) c[r] = lt + take;
    left -= __shfl_sync(0xffffffffu, incl, 31);
    if (left < 0) left = 0;
  }
}

// The whole CTA: merges one tile, whose segment r is strip r's
// [c0[r], c0[r] + offs[r + 1] - offs[r]), into out[0, offs[W]).  The
// segments are copied into buf (offs[W] <= its size) and each key's slot
// is its index plus its bounds in the other segments (K2's rank-scatter,
// in shared memory).  offs and c0 may lie in shared or global memory.
template <class Load>
__device__ void smj_merge_tile(Load ld, const int* land, const long long* c0,
                               const long long* offs, int* buf, int* out,
                               long long stride, int W) {
  const long long n = offs[W];
  for (long long p = threadIdx.x; p < n; p += blockDim.x) {
    int lo = 0, hi = W;  // the segment holding p: offs[lo] <= p < offs[lo+1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offs[mid] <= p) lo = mid; else hi = mid;
    }
    buf[p] = ld(land + (long long)lo * stride + c0[lo] + (p - offs[lo]));
  }
  __syncthreads();
  for (long long p = threadIdx.x; p < n; p += blockDim.x) {
    int r = 0, hi = W;
    while (hi - r > 1) {
      const int mid = (r + hi) >> 1;
      if (offs[mid] <= p) r = mid; else hi = mid;
    }
    const int key = buf[p];
    long long slot = p - offs[r];
    for (int q = 0; q < W; ++q) {
      if (q == r) continue;
      slot += smj_shared_bound(buf, (int)offs[q], (int)offs[q + 1], key,
                               q < r) - offs[q];
    }
    out[slot] = key;
  }
}
