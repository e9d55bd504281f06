// Shared device helpers of the sort-merge-join kernels.
//
// Every entry point has a plain C interface (called through ctypes): it
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_KEY_POS_INF INT_MAX
#define SMJ_KEY_NEG_INF INT_MIN

#define SMJ_API extern "C" __attribute__((visibility("default")))

// A (key, payload) int32 pair packed into one int64 whose signed order is
// the pairs' lexicographic order: the key in the high half, the payload
// with its sign bit flipped in the low half.  The pads (INT32_MAX,
// INT32_MAX) and (INT32_MIN, INT32_MIN) pack to LLONG_MAX and LLONG_MIN.
__device__ __forceinline__ long long smj_pack(int key, int payload) {
  return (long long)(((unsigned long long)(unsigned)key << 32) |
                     ((unsigned)payload ^ 0x80000000u));
}

__device__ __forceinline__ int smj_key(long long v) { return (int)(v >> 32); }

__device__ __forceinline__ int smj_payload(long long v) {
  return (int)((unsigned)v ^ 0x80000000u);
}

// Bounds over a (key, payload) column pair in lexicographic order, the
// order of smj_pack: the first index in [lo, hi) whose pair is >= v
// (kUpper false) or > v (kUpper true).  Each step loads both planes at
// `mid` at once and compares one packed int64: two independent loads, one
// round of latency, whatever the data.  Loading the payload plane only on
// a key tie saves loads but pays a second, dependent round on every tie,
// and the (hi, lo) planes of KEY_8B keys that fit in 32 bits tie on every
// step.
template <bool kUpper>
__device__ __forceinline__ long long smj_pair_bound(
    const int* __restrict__ k, const int* __restrict__ p, long long lo,
    long long hi, long long v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long m = smj_pack(__ldg(k + mid), __ldg(p + mid));
    if (kUpper ? m <= v : m < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
