// K1: ascending bitonic sort of each BLOCK-key block, keys only.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/sort.py
// `_block_sort_kernel_keys` (reached through `sort_blocks`), which sorts
// each (block_rows, 128) VMEM tile with the bitonic network of
// ops/bitonic.py.  The m-way join runs it with every block ascending.
//
// What bounds it on the H100: device memory is touched once (4 B read and
// 4 B written per key, 0.31 ms for 128M keys), so the kernel is bound by
// the log2(B)(log2(B)+1)/2 stages of the network (105 at B = 16,384): how
// many of them go through shared memory, and the barriers between those.
//
// Design (bitonic_network.cuh): one CTA sorts one block, each of its B /
// kPer threads holding kPer = 32 consecutive keys in registers.  Of the
// 105 stages at B = 16,384 (512 threads), the 60 of stride below 32 run
// in registers, the 35 of stride 32-512 through warp shuffles, and only
// the 10 of stride 1,024 and above through shared memory, one barrier
// pair each, on a padded tile (64 KB + 2 KB at B = 16,384, above the 48
// KB static limit, hence the cudaFuncSetAttribute below).  Each thread
// loads and stores its own 32 keys with 16-byte accesses, straight between
// device memory and registers.  The ragged last block is padded with
// INT32_MAX, so the output holds nblocks * B keys with the pads at the
// end.  The TPU's 65,536-key block does not fit in 227 KB of
// shared memory and is not carried over.
#include "bitonic_network.cuh"

namespace {

constexpr int kPer = 32;          // keys a thread
constexpr int kMaxThreads = 512;  // B = 16,384
// at most 64 registers a thread: two CTAs of 512 threads an SM (shared
// memory would allow three)
constexpr int kMinBlocks = 2;

template <int kBlock>
__global__ void __launch_bounds__(kBlock / kPer, kMinBlocks)
block_sort_kernel(const int* __restrict__ in, int* __restrict__ out,
                  long long n) {
  extern __shared__ int tile[];
  smj_bitonic::sort_tile<int, kPer, kBlock>(in, out, n, SMJ_KEY_POS_INF,
                                            tile);
}

size_t smem_of(int block) {
  return (size_t)smj_bitonic::tile_slots<kPer>(block) * sizeof(int);
}

// Lets the kernel take its tile and asks for the largest shared memory
// carveout, so that shared memory does not cut the CTAs an SM.
template <int kBlock>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<kBlock>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_of(kBlock));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(block_sort_kernel<kBlock>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Launches (stream non-null) or reports the CTAs an SM into *ctas.
template <int kBlock>
int run(const int* in, int* out, long long n, int nblocks,
        cudaStream_t stream, int* ctas) {
  const cudaError_t err = prepare<kBlock>();
  if (err != cudaSuccess) return (int)err;
  if (ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, block_sort_kernel<kBlock>, kBlock / kPer, smem_of(kBlock));
  block_sort_kernel<kBlock><<<nblocks, kBlock / kPer, smem_of(kBlock),
                              stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

int dispatch(const int* in, int* out, long long n, int block, int nblocks,
             cudaStream_t stream, int* ctas) {
  switch (block) {
    case 1024: return run<1024>(in, out, n, nblocks, stream, ctas);
    case 2048: return run<2048>(in, out, n, nblocks, stream, ctas);
    case 4096: return run<4096>(in, out, n, nblocks, stream, ctas);
    case 8192: return run<8192>(in, out, n, nblocks, stream, ctas);
    case 16384: return run<16384>(in, out, n, nblocks, stream, ctas);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Sorts keys in[0, n) block by block into out[0, nblocks * block).
// block is a power of two in [1024, 16384]; the wrapper checks it and makes
// the tensors' card current.
SMJ_API int smj_block_sort(const int* in, int* out, long long n, int block,
                           int nblocks, void* stream) {
  return dispatch(in, out, n, block, nblocks, (cudaStream_t)stream, nullptr);
}

// The CTAs an SM holds of block_sort_kernel at `block`, into *ctas (a host
// int): its registers, threads and shared tile together.
SMJ_API int smj_block_sort_occupancy(int block, int* ctas) {
  return dispatch(nullptr, nullptr, 0, block, 0, nullptr, ctas);
}
