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
