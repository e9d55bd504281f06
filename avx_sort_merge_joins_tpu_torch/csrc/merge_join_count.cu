// K3, K7 and K10: exact match count of two key columns, sum over keys k of
// cntR(k) * cntS(k), in int64.  K3 takes int32 keys, each side one
// ascending run; K7 takes 64-bit keys, each side given as two int32 planes
// (hi, lo with its sign bit flipped) whose lexicographic order is the int64
// order; K10 takes int32 keys, each side two ascending runs (the layout of
// a multiway sort stopped one merge level early).
//
// Replaces the TPU kernels avx_sort_merge_joins_tpu/ops/mergejoin.py
// `_count_kernel` with `_segmented_counts` (reached through
// `merge_join_count_fused`), `_count_kernel64` (reached through
// `merge_join_count_fused64`) and `_count_kernel2` (reached through
// `merge_join_count_fused2`).  Those run as grid=(1,): one serial
// read-only pass over R and S (S negated, or as bitwise-NOT planes, and
// read back to front), with the count in base-2^30 int32 limbs and an
// overflow flag; `_count_kernel2` first merges the two runs of each side
// and then the two sides, through three tagged bitonic selects per tile.
//
// What bounds them on the H100: R is read once (4 B per key, 8 B per
// 64-bit key); each R key then costs two binary searches over S of
// log2(nS) dependent steps (K10: two in each S run).  Neighbouring threads
// hold neighbouring R keys, so their searches share the upper levels of
// the path in L1/L2; the kernels are bound by load latency and L1/L2
// throughput.
//
// Design: a grid-stride loop in which each thread adds
// upper_bound(S, r) - lower_bound(S, r) for its R keys, summed in int64
// within the warp (shuffles) and the block (shared memory), then one
// atomicAdd per block.  The count needs no limbs and no overflow flag
// (nR * nS < 2^62), S stays ascending, and the grid fills all SMs.  K7
// forms each 64-bit key in registers from its two planes (smj_pack of
// (hi, lo_biased) is the original int64 key) and probes both S planes on
// every search step (smj_pair_bound), so equal hi planes with different lo
// never match.  K10 needs no merge at all: the count does not depend on
// the order of R, so its two runs are simply r[0, nR), and each R key adds
// its count in each S run, so a key found in both runs of S counts in
// both.  Dropped with the merges: the 4-way tagged select, the
// double-buffered windows and the spare rows past each run.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

// Adds the block's sum of `acc` to *out: shuffles within the warp, shared
// memory across warps, one atomicAdd per block.  Every thread calls it.
__device__ __forceinline__ void block_add(unsigned long long acc,
                                          unsigned long long* out) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc != 0) atomicAdd(out, acc);
  }
}

__global__ void merge_join_count_kernel(const int* __restrict__ r,
                                        long long nR,
                                        const int* __restrict__ s,
                                        long long nS,
                                        unsigned long long* out) {
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nR;
       i += stride) {
    const int key = r[i];
    const long long lo = smj_lower_bound(s, 0, nS, key);
    if (lo < nS && __ldg(s + lo) == key)
      acc += smj_upper_bound(s, lo + 1, nS, key) - lo;
  }
  block_add(acc, out);
}

__global__ void merge_join_count64_kernel(const int* __restrict__ rh,
                                          const int* __restrict__ rl,
                                          long long nR,
                                          const int* __restrict__ sh,
                                          const int* __restrict__ sl,
                                          long long nS,
                                          unsigned long long* out) {
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nR;
       i += stride) {
    const long long key = smj_pack(rh[i], rl[i]);
    const long long lo = smj_pair_bound<false>(sh, sl, 0, nS, key);
    if (lo < nS && smj_pack(__ldg(sh + lo), __ldg(sl + lo)) == key)
      acc += smj_pair_bound<true>(sh, sl, lo + 1, nS, key) - lo;
  }
  block_add(acc, out);
}

// Number of elements equal to `key` in the ascending a[lo, hi).
__device__ __forceinline__ long long count_in(const int* __restrict__ a,
                                              long long lo, long long hi,
                                              int key) {
  const long long first = smj_lower_bound(a, lo, hi, key);
  if (first == hi || __ldg(a + first) != key) return 0;
  return smj_upper_bound(a, first + 1, hi, key) - first;
}

__global__ void merge_join_count2_kernel(const int* __restrict__ r,
                                         long long nR,
                                         const int* __restrict__ s,
                                         long long s0_end, long long s1_lo,
                                         long long s1_end,
                                         unsigned long long* out) {
  unsigned long long acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nR;
       i += stride) {
    const int key = r[i];
    acc += count_in(s, 0, s0_end, key) + count_in(s, s1_lo, s1_end, key);
  }
  block_add(acc, out);
}

}  // namespace

// Adds the match count of r[0, nR) and s[0, nS) to *out (int64, zeroed by
// the caller, who also makes the tensors' card current).
SMJ_API int smj_merge_join_count(const int* r, long long nR, const int* s,
                                 long long nS, unsigned long long* out,
                                 void* stream) {
  if (nR == 0) return (int)cudaSuccess;
  long long blocks = (nR + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  merge_join_count_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(r, nR, s, nS, out);
  return (int)cudaGetLastError();
}

// The same over 64-bit keys: R as planes (rh, rl)[0, nR), S as planes
// (sh, sl)[0, nS), both ascending in lexicographic order.
SMJ_API int smj_merge_join_count64(const int* rh, const int* rl, long long nR,
                                   const int* sh, const int* sl, long long nS,
                                   unsigned long long* out, void* stream) {
  if (nR == 0) return (int)cudaSuccess;
  long long blocks = (nR + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  merge_join_count64_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(rh, rl, nR, sh, sl, nS,
                                                      out);
  return (int)cudaGetLastError();
}

// The same where S holds two ascending runs, s[0, min(nS, span_s)) and
// s[span_s, nS) (empty when nS <= span_s); R's two runs together are
// r[0, nR), in any order.
SMJ_API int smj_merge_join_count2(const int* r, long long nR, const int* s,
                                  long long nS, long long span_s,
                                  unsigned long long* out, void* stream) {
  if (nR == 0) return (int)cudaSuccess;
  long long blocks = (nR + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const long long s0_end = nS < span_s ? nS : span_s;
  const long long s1_end = nS > span_s ? nS : span_s;
  merge_join_count2_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(r, nR, s, s0_end, span_s,
                                                     s1_end, out);
  return (int)cudaGetLastError();
}
