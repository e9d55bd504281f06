// K5: bitonic sort of each BLOCK-pair block of (key, payload) int32 pairs
// in lexicographic order, every block ascending or every block descending.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/sort.py
// `_block_sort_kernel` (reached through `sort_blocks` with payloads), which
// sorts each (block_rows, 128) key tile and payload tile with the bitonic
// network of ops/bitonic.py and its lexicographic compare `lex_lt_le`.
//
// What bounds it on the H100: device memory is touched once (8 B read and
// 8 B written per pair), so, like K1, the kernel is bound by shared-memory
// traffic and by the __syncthreads() between the 105 stages of the network
// at B = 16,384.
//
// Design: K1's network over packed pairs.  Each pair is loaded as one
// int64 whose signed order is the lexicographic order (smj_pack), so a
// compare-exchange is one 64-bit compare and one 64-bit swap instead of
// two compares and two swaps over two arrays.  16,384 pairs take 128 KB of
// dynamic shared memory, under the 227 KB a CTA may use.  The `descending`
// flag mirrors every compare; the ragged last block is padded with the
// pair that sorts to the junk end, (INT32_MAX, INT32_MAX) ascending or
// (INT32_MIN, INT32_MIN) descending.  The TPU's alternating block
// directions and `flip` are not carried over: every block goes one way.
#include "smj_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void block_sort_pairs_kernel(const int* __restrict__ keys,
                                        const int* __restrict__ payloads,
                                        int* __restrict__ out_keys,
                                        int* __restrict__ out_payloads,
                                        long long n, int block,
                                        bool descending) {
  extern __shared__ long long ptile[];
  const long long base = (long long)blockIdx.x * block;
  const long long pad = descending ? LLONG_MIN : LLONG_MAX;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const long long g = base + i;
    ptile[i] = g < n ? smj_pack(keys[g], payloads[g]) : pad;
  }
  __syncthreads();
  const int half = block >> 1;
  for (int k = 2; k <= block; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // t-th pair of this stage: lower index i, partner i + j
        const int i = 2 * t - (t & (j - 1));
        const bool up = ((i & k) == 0) != descending;
        const long long a = ptile[i];
        const long long b = ptile[i + j];
        if ((a > b) == up) {
          ptile[i] = b;
          ptile[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const long long v = ptile[i];
    out_keys[base + i] = smj_key(v);
    out_payloads[base + i] = smj_payload(v);
  }
}

}  // namespace

// Sorts the pairs (keys[i], payloads[i]), i in [0, n), block by block into
// out_keys/out_payloads[0, nblocks * block).  block is a power of two in
// [1024, 16384]; the wrapper checks it and makes the tensors' card current.
SMJ_API int smj_block_sort_pairs(const int* keys, const int* payloads,
                                 int* out_keys, int* out_payloads,
                                 long long n, int block, int nblocks,
                                 int descending, void* stream) {
  const size_t smem = (size_t)block * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = block / 2 < kMaxThreads ? block / 2 : kMaxThreads;
  block_sort_pairs_kernel<<<nblocks, threads, smem, (cudaStream_t)stream>>>(
      keys, payloads, out_keys, out_payloads, n, block, descending != 0);
  return (int)cudaGetLastError();
}
