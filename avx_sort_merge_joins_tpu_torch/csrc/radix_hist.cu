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
// per key.
//
// Design, from timings of the parts of the kernel it replaces (PERF.md,
// K8): the keys alone streamed at about 80% of the bound and a plain
// shared atomicAdd per key cost little more, uniform or Zipf; the warp
// aggregation of equal ids (__match_any_sync) took three quarters of the
// time, and 2^16 bins read the keys twice.  So:
// - every key adds 1 with a plain shared-memory atomicAdd into the CTA's
//   one histogram, no aggregation: private copies of the histogram for
//   every warp, with a column a lane at small fanouts, timed the same
//   (PERF.md), so the CTA keeps one;
// - 2^16 32-bit counters (256 KB) do not fit a CTA, so at 2^16 the CTA
//   counts in 16-bit halves of 2^15 words (128 KB) and reads the keys once.
//   An add that wraps a half (it returned 0xffff there) adds 65,536 to that
//   bin's count outside the word; a wrapping low half also carried 1 into
//   the high half, which its thread takes back, and every carry, take-back
//   or add that wraps the high half through 0xffff or 0 is accounted for
//   the same way, so each bin's count is its half plus 65,536 times its
//   wraps.  (Two CTAs of a cluster, each holding half of the bins and
//   adding the other half's ids through distributed shared memory, read
//   the keys once too, but the remote atomics made 2^16 four times slower
//   than 2^14.)
// - each thread keeps kVecs 16-byte loads in flight; the global mode's grid
//   is as many CTAs as the card holds at once (at most kMaxCtasPerSm an
//   SM), by the occupancy API, each counting one contiguous share of the
//   keys and adding its non-zero counts to the row with one atomicAdd
//   each; the per-tile mode gives every tile a CTA that writes its row.
// The id's shift is logical (unsigned), as the TPU kernel's
// shift_right_logical.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileKeys = 65536;  // keys per tile: HIST_TILE
constexpr int kLogWords = 15;     // 128 KB of counter words at most a CTA
constexpr int kVecs = 2;          // 16-byte loads in flight a thread
constexpr int kMaxCtasPerSm = 2;  // global mode
constexpr int kFixSlots = 8;      // per tile: wraps of 16-bit halves
constexpr unsigned kHalf = 0xffffu;

// The 32-bit counter words of 2^nbits bins: one a bin, or (packed, above
// 2^kLogWords bins) two, bin b in half b & 1 of word b >> 1.
int words_of(int nbits) {
  return nbits > kLogWords ? 1 << (nbits - 1) : 1 << nbits;
}

// Calls f(key) for every key of keys[lo, hi) the calling thread owns: the
// CTA's threads take consecutive 16-byte vectors (kVecs of them in flight
// a thread) when `vec` (keys + lo 16-byte aligned), then the ragged tail.
template <class F>
__device__ __forceinline__ void for_keys(const int* __restrict__ keys,
                                         long long lo, long long hi, bool vec,
                                         F f) {
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(keys + lo);
    const long long nv = (hi - lo) >> 2;
    for (long long i = threadIdx.x; i < nv;
         i += (long long)kThreads * kVecs) {
      int4 x[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u)
        if (i + u * kThreads < nv) x[u] = __ldg(v + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kVecs; ++u)
        if (i + u * kThreads < nv) {
          f(x[u].x);
          f(x[u].y);
          f(x[u].z);
          f(x[u].w);
        }
    }
    lo += nv << 2;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    f(__ldg(keys + i));
}

// The counts a CTA keeps outside its packed words: 65,536 times the wraps
// of a 16-bit half, added straight to the global row, or (per tile, where
// the row is written at the end) kept in a short list: a tile's 65,536
// keys wrap a half only when they all fall in its bin, once.
struct Fixes {
  bool per_tile;
  int* out;  // the global row
  int* n;    // per tile: the list in shared memory
  int* bin;
  int* add;

  __device__ __forceinline__ void operator()(unsigned b, int v) const {
    if (!per_tile) {
      atomicAdd(out + b, v);
      return;
    }
    const int i = atomicAdd(n, 1);
    if (i < kFixSlots) {
      bin[i] = (int)b;
      add[i] = v;
    }
  }
};

// The add of id pid into packed word w returned `old`, which wrapped the
// half of pid (its old half was 0xffff).
__device__ __forceinline__ void on_wrap(unsigned* w, unsigned pid,
                                        unsigned old, const Fixes& fix) {
  fix(pid, 65536);
  if ((pid & 1u) == 0) {
    // the low half carried 1 into the high half (bin pid + 1), which may
    // have wrapped it; take the carry back, which may wrap it the other way
    if ((old >> 16) == kHalf) fix(pid + 1, 65536);
    if ((atomicAdd(w, 0xffff0000u) >> 16) == 0) fix(pid + 1, -65536);
  }
}

// Per tile: CTA b counts tile b and writes its row.  Global: CTA b counts
// keys [b chunk, (b + 1) chunk) and adds its counts to out[0, fanout).
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int* __restrict__ keys, long long n, unsigned mask,
                  int shift, int fanout, long long chunk, bool per_tile,
                  bool vec, int* __restrict__ out) {
  extern __shared__ unsigned counts[];
  __shared__ int fix_n, fix_bin[kFixSlots], fix_add[kFixSlots];
  const bool packed = fanout > (1 << kLogWords);
  for (int w = threadIdx.x; w < fanout >> (packed ? 1 : 0); w += kThreads)
    counts[w] = 0;
  if (threadIdx.x == 0) fix_n = 0;
  __syncthreads();
  const Fixes fix{per_tile, out, &fix_n, fix_bin, fix_add};
  const long long lo = per_tile ? blockIdx.x * (long long)kTileKeys
                                : blockIdx.x * chunk;
  long long hi = lo + (per_tile ? kTileKeys : chunk);
  hi = hi < n ? hi : n;
  if (lo < hi)
    for_keys(keys, lo, hi, vec, [&](int key) {
      const unsigned pid = (((unsigned)key - 1u) & mask) >> shift;
      if (packed) {
        const unsigned sh = (pid & 1u) << 4;
        const unsigned old = atomicAdd(counts + (pid >> 1), 1u << sh);
        if (((old >> sh) & kHalf) == kHalf)
          on_wrap(counts + (pid >> 1), pid, old, fix);
      } else {
        atomicAdd(counts + pid, 1u);
      }
    });
  __syncthreads();
  int* row = out + (per_tile ? blockIdx.x * (long long)fanout : 0);
  for (int b = threadIdx.x; b < fanout; b += kThreads) {
    const unsigned s =
        packed ? (counts[b >> 1] >> ((b & 1) << 4)) & kHalf : counts[b];
    if (per_tile) {
      row[b] = (int)s;
    } else if (s != 0) {
      atomicAdd(row + b, (int)s);
    }
  }
  if (per_tile && fix_n > 0) {  // every thread sees the same fix_n
    __syncthreads();
    if (threadIdx.x < fix_n && threadIdx.x < kFixSlots)
      atomicAdd(row + fix_bin[threadIdx.x], fix_add[threadIdx.x]);
  }
}

// Launches the kernel for 2^nbits bins (stream non-null), or reports its
// CTAs an SM into *ctas.
int run(const int* keys, long long n, int nbits, int shift, bool per_tile,
        int* out, cudaStream_t stream, int* ctas) {
  if (nbits < 1 || nbits > kLogWords + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)words_of(nbits) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      radix_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(radix_hist_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_hist_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (ctas != nullptr) {
    *ctas = per_sm;
    return (int)cudaSuccess;
  }
  long long grid = (n + kTileKeys - 1) / kTileKeys;
  long long chunk = 0;
  if (!per_tile) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    grid = (long long)sms * (per_sm < kMaxCtasPerSm ? per_sm : kMaxCtasPerSm);
    // at least one round of every thread's loads a CTA
    const long long most = (n + 4LL * kThreads * kVecs - 1) /
                           (4LL * kThreads * kVecs);
    grid = grid < most ? grid : most;
    chunk = ((n + grid - 1) / grid + 3) / 4 * 4;
  }
  const int fanout = 1 << nbits;
  const unsigned mask = (unsigned)(fanout - 1) << shift;
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  radix_hist_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      keys, n, mask, shift, fanout, chunk, per_tile, vec, out);
  return (int)cudaGetLastError();
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
  return run(keys, n, nbits, shift, per_tile != 0, out,
             (cudaStream_t)stream, nullptr);
}

// The CTAs an SM holds of the kernel that counts 2^nbits bins, into *ctas
// (a host int): its threads and counters together.
SMJ_API int smj_radix_hist_occupancy(int nbits, int* ctas) {
  return run(nullptr, 0, nbits, 0, false, nullptr, nullptr, ctas);
}
