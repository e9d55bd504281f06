// K8: histogram of the radix-partition ids ((k - 1) & mask) >> shift of an
// int32 key column, for fanouts 2^1 .. 2^16: per tile of 65,536 keys, or one
// global row.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/partition.py
// `_hist_kernel` (reached through `radix_hist`), which counts the ids of a
// (512, 128) tile lane-parallel: for every chunk of 128 ids and every one of
// the 128 lane rotations it compares, so its work grows as fanout x 128 and
// the JAX package stops it at 2^7 and sends larger fanouts to a one-hot
// matmul on the MXU (`radix_hist_mxu`).  Here one kernel covers every
// fanout.
//
// What bounds it on the H100: each key is read once (4 B) and each count
// written once, so device-memory bytes bound it (128M keys: 0.153 ms for the
// global histogram at 3.35 TB/s; 1954 x 65,536 per-tile counts at 2^16 add
// 512 MB, 0.306 ms in all).  Around that sit the shared-memory atomics, one
// per key in the worst case.
//
// Design: one CTA counts a tile into a private histogram of 32-bit counters
// in shared memory and writes it out (per tile), or walks a share of the
// tiles and adds its histogram to the global row with one atomicAdd per
// non-zero bin (global).  2^16 32-bit counters are 256 KB, over the 227 KB a
// CTA may use, and 16-bit counters overflow on a tile whose 65,536 keys all
// fall in one bin; so above 2^15 bins the ids are split by their top bit
// over two CTAs, each holding 2^15 counters (128 KB) and reading the same
// tile (the two sit next to each other in the grid, so the second read
// mostly hits L2).  Keys come in as int4 loads, four per lane.  Skewed keys
// (Zipf) put most of a warp's ids on a few bins, which would serialise the
// shared-memory atomics on one address; each warp first groups equal ids
// with __match_any_sync and only the group's first lane adds the group's
// size.  The id's shift is logical (unsigned), as the TPU kernel's
// shift_right_logical.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileKeys = 65536;             // keys per tile: HIST_TILE
constexpr int kMaxCtaBins = 1 << 15;         // 128 KB of counters per CTA
constexpr unsigned kNoBin = 0xffffffffu;     // a lane with no id to add

// Counts one id of this CTA's share of the bins; every lane of the warp
// calls it together (bin == kNoBin: nothing to add).
__device__ __forceinline__ void count_bin(unsigned* counts, unsigned bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int lane = threadIdx.x & 31;
  if (bin != kNoBin && lane == __ffs(peers) - 1)
    atomicAdd(counts + bin, (unsigned)__popc(peers));
}

// The CTA's bin of `key`, or kNoBin when its id belongs to the other split.
__device__ __forceinline__ unsigned cta_bin(int key, unsigned mask,
                                            int shift, int log_bins,
                                            unsigned split) {
  const unsigned pid = (((unsigned)key - 1u) & mask) >> shift;
  return (pid >> log_bins) == split ? (pid & ((1u << log_bins) - 1u))
                                    : kNoBin;
}

// Adds the ids of keys[lo, hi) to `counts`.  Every warp runs the same
// number of rounds, so __match_any_sync always sees all 32 lanes.
__device__ __forceinline__ void count_range(const int* __restrict__ keys,
                                            long long lo, long long hi,
                                            bool vec, unsigned mask,
                                            int shift, int log_bins,
                                            unsigned split,
                                            unsigned* counts) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = lo + (long long)(threadIdx.x >> 5) * 128;
  for (long long base = warp0; base < hi; base += (long long)kThreads * 4) {
    const long long i = base + lane * 4;
    int k[4];
    bool ok[4];
    if (vec && base + 128 <= hi) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(keys + i));
      k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
      ok[0] = ok[1] = ok[2] = ok[3] = true;
    } else {
      for (int j = 0; j < 4; ++j) {
        ok[j] = i + j < hi;
        k[j] = ok[j] ? __ldg(keys + i + j) : 0;
      }
    }
    for (int j = 0; j < 4; ++j)
      count_bin(counts, ok[j] ? cta_bin(k[j], mask, shift, log_bins, split)
                              : kNoBin);
  }
}

// blockIdx.x = item * nsplit + split.  Per tile: item is the tile.  Global:
// item walks the tiles item, item + nitems, ... and adds its counts to
// out[0, fanout) at the end.
__global__ void radix_hist_kernel(const int* __restrict__ keys, long long n,
                                  unsigned mask, int shift, int fanout,
                                  int log_bins, int nsplit, long long ntiles,
                                  bool per_tile, bool vec,
                                  int* __restrict__ out) {
  extern __shared__ unsigned counts[];
  const int bins = 1 << log_bins;
  const unsigned split = blockIdx.x % nsplit;
  const long long item = blockIdx.x / nsplit;
  const long long nitems = gridDim.x / nsplit;
  const long long first_bin = (long long)split * bins;
  for (int b = threadIdx.x; b < bins; b += kThreads) counts[b] = 0;
  __syncthreads();
  for (long long tile = item; tile < ntiles; tile += nitems) {
    const long long lo = tile * kTileKeys;
    const long long hi = lo + kTileKeys < n ? lo + kTileKeys : n;
    count_range(keys, lo, hi, vec, mask, shift, log_bins, split, counts);
    if (per_tile) {
      __syncthreads();
      int* row = out + tile * fanout + first_bin;
      for (int b = threadIdx.x; b < bins; b += kThreads) {
        row[b] = (int)counts[b];
        counts[b] = 0;
      }
    }
    __syncthreads();
  }
  if (!per_tile) {
    for (int b = threadIdx.x; b < bins; b += kThreads)
      if (counts[b] != 0) atomicAdd(out + first_bin + b, (int)counts[b]);
  }
}

}  // namespace

// Histogram of the ids ((keys[i] - 1) & mask) >> shift, i in [0, n), with
// mask = (2^nbits - 1) << shift.  per_tile: out is (cdiv(n, 65536), 2^nbits)
// int32, row t counting keys [65536 t, 65536 (t + 1)); else out is the
// (2^nbits,) int32 global row, zeroed by the caller.  The wrapper checks
// 1 <= nbits <= 16, shift >= 0, nbits + shift <= 31 and n < 2^31, and makes
// the tensor's card current.
SMJ_API int smj_radix_hist(const int* keys, long long n, int nbits, int shift,
                           int per_tile, int* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int fanout = 1 << nbits;
  const unsigned mask = (unsigned)(fanout - 1) << shift;
  const int bins = fanout < kMaxCtaBins ? fanout : kMaxCtaBins;
  const int log_bins = nbits < 15 ? nbits : 15;
  const int nsplit = fanout / bins;
  const long long ntiles = (n + kTileKeys - 1) / kTileKeys;
  long long nitems = ntiles;
  if (!per_tile) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long want = 2LL * sms / nsplit > 0 ? 2LL * sms / nsplit : 1;
    if (nitems > want) nitems = want;
  }
  const size_t smem = (size_t)bins * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      radix_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  radix_hist_kernel<<<(unsigned)(nitems * nsplit), kThreads, smem,
                      (cudaStream_t)stream>>>(
      keys, n, mask, shift, fanout, log_bins, nsplit, ntiles, per_tile != 0,
      vec, out);
  return (int)cudaGetLastError();
}
