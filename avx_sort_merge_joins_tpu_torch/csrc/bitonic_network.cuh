// The bitonic network of the block sorts, in registers, warp shuffles and
// shared memory: one CTA sorts one tile of kPer * blockDim.x elements
// ascending.  Thread t holds the kPer consecutive elements [t * kPer,
// (t + 1) * kPer) of the tile in registers.
//
// The network is the "flip" form of the bitonic sort: phase k (k = 2, 4,
// ..., tile) first compares element i with i ^ (k - 1), the mirror image
// inside its k-block, then runs the half-cleaners i ^ j for j = k/4, ...,
// 1.  Every comparator puts the smaller element at the lower index, so no
// stage needs a direction.  A stage of stride j (the flip: k/2) runs
//   * in registers when j < kPer, as unrolled compare-exchanges;
//   * through __shfl_xor_sync when kPer <= j < 32 * kPer: the partner is
//     lane ^ (j / kPer) (the flip: lane ^ (k / kPer - 1), element kPer - 1
//     - e), and each thread keeps the minima or the maxima of its pairs;
//   * through shared memory when j >= 32 * kPer: the threads store their
//     elements, meet at a barrier and read their partners'.
// Shared memory holds the tile with one spare slot every kPer elements,
// so that thread t's element e lies at t * (kPer + 1) + e: a warp's
// threads reading or writing the same e hit 32 distinct banks (4-byte
// elements, kPer + 1 odd).  Each thread loads and stores its own kPer
// elements with 16-byte accesses, straight from and to device memory.
//
// Every register index is a constant after unrolling (the templates
// below), so the elements never go to local memory.  E is int for K1 and
// long long for the packed pairs of K5 (a 64-bit shuffle is two 32-bit
// ones; with 8-byte elements a half-warp's accesses t * (kPer + 1) + e
// cover all 32 banks, so the shared stages stay free of conflicts).  K1
// runs sort_tile; K5 loads its two int32 planes itself, packs them in
// registers and runs sort_regs.
#pragma once

#include "smj_common.cuh"

namespace smj_bitonic {

constexpr unsigned kFullWarp = 0xffffffffu;

// Shared memory of a tile: one spare slot after every kPer elements, so
// that thread t's element e lies at t * (kPer + 1) + e.
template <int kPer>
__host__ __device__ constexpr int tile_slots(int tile) {
  return tile + tile / kPer;
}

// The smaller of a and b if keep_min, else the larger.
template <typename E>
__device__ __forceinline__ E keep(E a, E b, bool keep_min) {
  return keep_min ? (a < b ? a : b) : (a < b ? b : a);
}

template <typename E>
__device__ __forceinline__ void cmpx(E& lo, E& hi) {
  const E a = lo < hi ? lo : hi;
  hi = lo < hi ? hi : lo;
  lo = a;
}

// The half-cleaners of strides J, J/2, ..., 1 inside a thread.
template <typename E, int kPer, int J>
__device__ __forceinline__ void reg_cleaners(E (&x)[kPer]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if ((e & J) == 0) cmpx(x[e], x[e + J]);
    reg_cleaners<E, kPer, J / 2>(x);
  }
}

// Phases K, 2K, ..., kPer: those that stay inside a thread.
template <typename E, int kPer, int K>
__device__ __forceinline__ void reg_phases(E (&x)[kPer]) {
  if constexpr (K <= kPer) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if ((e ^ (K - 1)) > e) cmpx(x[e], x[e ^ (K - 1)]);
    reg_cleaners<E, kPer, K / 4>(x);
    reg_phases<E, kPer, 2 * K>(x);
  }
}

// One compare-exchange stage across threads: element e of this thread
// meets element e (flip: kPer - 1 - e) of thread t ^ kM, read from a warp
// lane (shuffle) or from shared memory; this thread keeps the smaller of
// each pair if it is the lower of the two.
template <typename E, int kPer, bool kFlip, int kM>
__device__ __forceinline__ void cross_stage(E (&x)[kPer], E* tile) {
  const int t = threadIdx.x;
  // the lower thread of the pair: for a half-cleaner the bit kM is clear;
  // for the flip (kM = 2^p - 1) the top bit of kM is clear
  constexpr int kTop = kFlip ? (kM + 1) >> 1 : kM;
  const bool keep_min = (t & kTop) == 0;
  if constexpr (kM < 32) {
    if constexpr (kFlip) {
#pragma unroll
      for (int e = 0; e < kPer / 2; ++e) {
        const E a = __shfl_xor_sync(kFullWarp, x[kPer - 1 - e], kM);
        const E b = __shfl_xor_sync(kFullWarp, x[e], kM);
        x[e] = keep(x[e], a, keep_min);
        x[kPer - 1 - e] = keep(x[kPer - 1 - e], b, keep_min);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] = keep(x[e], __shfl_xor_sync(kFullWarp, x[e], kM), keep_min);
      }
    }
  } else {
    __syncthreads();  // every read of the last use of the tile is done
    const int own = t * (kPer + 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e) tile[own + e] = x[e];
    __syncthreads();
    const int other = (t ^ kM) * (kPer + 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      x[e] = keep(x[e], tile[other + (kFlip ? kPer - 1 - e : e)], keep_min);
    }
  }
}

// The half-cleaners of strides J, J/2, ..., kPer, across threads.
template <typename E, int kPer, int J>
__device__ __forceinline__ void cross_cleaners(E (&x)[kPer], E* tile) {
  if constexpr (J >= kPer) {
    cross_stage<E, kPer, false, J / kPer>(x, tile);
    cross_cleaners<E, kPer, J / 2>(x, tile);
  }
}

// Phases K, 2K, ..., kSize: those that cross threads.
template <typename E, int kPer, int kSize, int K>
__device__ __forceinline__ void cross_phases(E (&x)[kPer], E* tile) {
  if constexpr (K <= kSize) {
    cross_stage<E, kPer, true, K / kPer - 1>(x, tile);
    cross_cleaners<E, kPer, K / 4>(x, tile);
    reg_cleaners<E, kPer, kPer / 2>(x);
    cross_phases<E, kPer, kSize, 2 * K>(x, tile);
  }
}

// 16 bytes as 4 ints or 2 long longs, and back.
__device__ __forceinline__ void unpack(const int4& w, int* x) {
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}

__device__ __forceinline__ void unpack(const int4& w, long long* x) {
  x[0] = (long long)(((unsigned long long)(unsigned)w.y << 32) |
                     (unsigned)w.x);
  x[1] = (long long)(((unsigned long long)(unsigned)w.w << 32) |
                     (unsigned)w.z);
}

__device__ __forceinline__ int4 pack(const int* x) {
  return make_int4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ int4 pack(const long long* x) {
  return make_int4((int)x[0], (int)(x[0] >> 32), (int)x[1],
                   (int)(x[1] >> 32));
}

// Thread t's elements [t * kPer, (t + 1) * kPer) of the tile, straight
// from device memory into registers: kPer * sizeof(E) / 16 loads of 16
// bytes when the tile is aligned and whole, else one element a load with
// `pad` past n.  A warp's loads cover 32 * kPer consecutive elements, so
// each byte is read once (its 128-byte lines meet in L1), and the loads
// need no shared memory, no barrier and no second copy of the elements in
// registers.
template <typename E, int kPer>
__device__ __forceinline__ void load_own(const E* in, long long n, E pad,
                                         E (&x)[kPer]) {
  constexpr int kVec = 16 / sizeof(E);
  const long long i0 = (long long)threadIdx.x * kPer;
  if (i0 + kPer <= n && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(in + i0);
#pragma unroll
    for (int q = 0; q < kPer / kVec; ++q) {
      const int4 w = v[q];
      unpack(w, &x[q * kVec]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e] = i0 + e < n ? in[i0 + e] : pad;
  }
}

// The same for the stores (the output tile is whole).
template <typename E, int kPer>
__device__ __forceinline__ void store_own(E* out, const E (&x)[kPer]) {
  constexpr int kVec = 16 / sizeof(E);
  const long long i0 = (long long)threadIdx.x * kPer;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    int4* v = reinterpret_cast<int4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kPer / kVec; ++q) v[q] = pack(&x[q * kVec]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[i0 + e] = x[e];
  }
}

// The network: sorts the kSize elements that the tile's kSize / kPer
// threads hold, kPer each, ascending into the same places (thread t ends
// with the elements of ranks [t * kPer, (t + 1) * kPer)).  tile: shared
// memory of tile_slots<kPer>(kSize) elements.  Every stage is unrolled:
// its stride, its route and which threads keep the minima are constants.
template <typename E, int kPer, int kSize>
__device__ __forceinline__ void sort_regs(E (&x)[kPer], E* tile) {
  reg_phases<E, kPer, 2>(x);
  cross_phases<E, kPer, kSize, 2 * kPer>(x, tile);
}

// Sorts tile blockIdx.x, elements [b * kSize, (b + 1) * kSize) of in[0,
// n), ascending into the same slots of out, `pad` in the slots past n,
// with kSize / kPer threads: load_own, sort_regs, store_own.
template <typename E, int kPer, int kSize>
__device__ __forceinline__ void sort_tile(const E* in, E* out, long long n,
                                          E pad, E* tile) {
  const long long base = (long long)blockIdx.x * kSize;
  E x[kPer];
  load_own<E, kPer>(in + base, n - base, pad, x);
  sort_regs<E, kPer, kSize>(x, tile);
  store_own<E, kPer>(out + base, x);
}

}  // namespace smj_bitonic
