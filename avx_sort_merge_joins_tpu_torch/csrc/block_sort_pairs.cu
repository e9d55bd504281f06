// K5: sort of each BLOCK-pair block of (key, payload) int32 pairs in
// lexicographic order, every block ascending or every block descending.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/sort.py
// `_block_sort_kernel` (reached through `sort_blocks` with payloads), which
// sorts each (block_rows, 128) key tile and payload tile with the bitonic
// network of ops/bitonic.py and its lexicographic compare `lex_lt_le`.
//
// What bounds it on the H100: device memory is touched once (8 B read and
// 8 B written a pair, 0.611 ms for 128M pairs), so the kernel is bound by
// how often the sort moves each pair between threads, and by the barriers
// of the moves through shared memory.
//
// Design: each pair is one int64 whose signed order is the lexicographic
// order (smj_pack), so a compare-exchange is one 64-bit compare and swap.
// Each of the B / kPer threads (kPer = 16: 1,024 threads at B = 16,384)
// loads its kPer consecutive keys and payloads with 16-byte loads from the
// two planes and packs them in registers.  Each thread sorts its own
// pairs with the register phases of K1's network (bitonic_network.cuh's
// sort_regs: 10 compare-exchange stages, constant register indices); then
// log2(B / kPer) merge-path rounds (10 at 16,384) build the block: in each
// the threads store their pairs into a padded shared tile (one CTA an SM
// at 16,384: 128 KB + 8 KB), find where their kPer outputs start in the
// pair of runs they merge, and merge them into registers.  A round moves
// each pair through shared memory once; the network's stages across
// threads move every pair at each of them, two 32-bit shuffles for a
// 64-bit pair (the whole network: 40 shuffle and 15 shared stages at
// 16,384), and measured slower at every run length they sort
// (bench/kernel_variants.py), as did 32 pairs a thread (512 threads, up
// to 128 registers).  Every block is sorted ascending; a descending block
// is stored reversed (equal packed values are identical pairs, so this is
// exact), with each thread writing the mirror-image slots in reverse
// order.  The ragged last block is padded with the pair that sorts to the
// junk end: (INT32_MAX, INT32_MAX) ascending, (INT32_MIN, INT32_MIN)
// descending (it sorts first and is stored last).  The TPU's alternating
// block directions and `flip` are not carried over: every block goes one
// way.
#include "bitonic_network.cuh"

namespace {

constexpr int kPer = 16;           // pairs a thread
constexpr int kMaxThreads = 1024;  // B = 16,384
// one CTA an SM at B = 16,384 (its shared tile)
constexpr int kMinBlocks = 1;
// the network sorts runs of up to kRunMax pairs (kPer: each thread its
// own, in registers); merge rounds do the rest
constexpr int kRunMax = kPer;

// The tile's slot of the block's pair i: one spare slot every kPer pairs
// (bitonic_network.cuh's layout: thread t's pair e at t * (kPer + 1) + e).
__device__ __forceinline__ int slot(int i) { return i + i / kPer; }

// One merge round: the block holds ascending runs of L pairs, thread t
// the ranks [t * kPer, (t + 1) * kPer) of its run; afterwards it holds the
// same ranks of the run of 2 L merged from runs 2m and 2m + 1.  The
// threads store their pairs into the tile, find where their kPer outputs
// start by a merge-path search of the two runs (ties to the lower run),
// and merge them into registers.  The tile has one slot past the block:
// the step after the upper run's last pair reads it and drops it.
template <int L>
__device__ __forceinline__ void merge_round(long long (&x)[kPer],
                                            long long* tile) {
  const int o = threadIdx.x * kPer;  // the thread's first output
  const int lo_run = o & ~(2 * L - 1), q = o - lo_run;
  __syncthreads();  // every read of the tile's last use is done
#pragma unroll
  for (int e = 0; e < kPer; ++e) tile[slot(o + e)] = x[e];
  __syncthreads();
  auto A = [&](int k) { return tile[slot(lo_run + k)]; };
  auto B = [&](int k) { return tile[slot(lo_run + L + k)]; };
  int lo = q > L ? q - L : 0, hi = q < L ? q : L;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (A(mid - 1) <= B(q - mid)) lo = mid; else hi = mid - 1;
  }
  int ia = lo, ib = q - lo;
  long long a = A(ia), b = B(ib);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const bool take_a = ia < L && (ib >= L || a <= b);
    x[e] = take_a ? a : b;
    ia += take_a;
    ib += !take_a;
    const long long next = take_a ? A(ia) : B(ib);
    a = take_a ? next : a;
    b = take_a ? b : next;
  }
}

// The merge rounds from runs of L pairs up to the block.
template <int L, int kBlock>
__device__ __forceinline__ void merge_rounds(long long (&x)[kPer],
                                             long long* tile) {
  if constexpr (L < kBlock) {
    merge_round<L>(x, tile);
    merge_rounds<2 * L, kBlock>(x, tile);
  }
}

// Thread t's pairs [t * kPer, (t + 1) * kPer) of the block (keys, pays:
// its first slot), packed: kPer / 4 16-byte loads from each plane when
// the block is whole and both planes aligned, else one pair a load with
// `pad` past n.
__device__ __forceinline__ void load_pairs(const int* keys, const int* pays,
                                           long long n, long long pad,
                                           long long (&x)[kPer]) {
  const long long i0 = (long long)threadIdx.x * kPer;
  if (i0 + kPer <= n && ((reinterpret_cast<uintptr_t>(keys) |
                          reinterpret_cast<uintptr_t>(pays)) & 15) == 0) {
    const int4* kv = reinterpret_cast<const int4*>(keys + i0);
    const int4* pv = reinterpret_cast<const int4*>(pays + i0);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 k = kv[q];
      const int4 p = pv[q];
      x[4 * q] = smj_pack(k.x, p.x);
      x[4 * q + 1] = smj_pack(k.y, p.y);
      x[4 * q + 2] = smj_pack(k.z, p.z);
      x[4 * q + 3] = smj_pack(k.w, p.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      x[e] = i0 + e < n ? smj_pack(keys[i0 + e], pays[i0 + e]) : pad;
  }
}

// Stores the thread's sorted pairs, ranks [t * kPer, (t + 1) * kPer) of
// the block, unpacked into the two planes (out_keys, out_pays: the
// block's first slot): at the same slots, or (kReversed) at the mirror
// slots B - 1 - rank, which thread B / kPer - 1 - t's slots hold.
template <int kBlock, bool kReversed>
__device__ __forceinline__ void store_pairs(int* out_keys, int* out_pays,
                                            const long long (&x)[kPer]) {
  const int t = kReversed ? kBlock / kPer - 1 - (int)threadIdx.x
                          : (int)threadIdx.x;
  const long long i0 = (long long)t * kPer;
  auto at = [&](int e) { return x[kReversed ? kPer - 1 - e : e]; };
  if (((reinterpret_cast<uintptr_t>(out_keys) |
        reinterpret_cast<uintptr_t>(out_pays)) & 15) == 0) {
    int4* kv = reinterpret_cast<int4*>(out_keys + i0);
    int4* pv = reinterpret_cast<int4*>(out_pays + i0);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      kv[q] = make_int4(smj_key(at(4 * q)), smj_key(at(4 * q + 1)),
                        smj_key(at(4 * q + 2)), smj_key(at(4 * q + 3)));
      pv[q] = make_int4(smj_payload(at(4 * q)), smj_payload(at(4 * q + 1)),
                        smj_payload(at(4 * q + 2)),
                        smj_payload(at(4 * q + 3)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      out_keys[i0 + e] = smj_key(at(e));
      out_pays[i0 + e] = smj_payload(at(e));
    }
  }
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock / kPer, kMinBlocks)
block_sort_pairs_kernel(const int* __restrict__ keys,
                        const int* __restrict__ payloads,
                        int* __restrict__ out_keys,
                        int* __restrict__ out_payloads, long long n,
                        bool descending) {
  extern __shared__ long long ptile[];
  const long long base = (long long)blockIdx.x * kBlock;
  long long x[kPer];
  load_pairs(keys + base, payloads + base, n - base,
             descending ? LLONG_MIN : LLONG_MAX, x);
  constexpr int kRun = kBlock < kRunMax ? kBlock : kRunMax;
  smj_bitonic::sort_regs<long long, kPer, kRun>(x, ptile);
  merge_rounds<kRun, kBlock>(x, ptile);
  if (descending)
    store_pairs<kBlock, true>(out_keys + base, out_payloads + base, x);
  else
    store_pairs<kBlock, false>(out_keys + base, out_payloads + base, x);
}

size_t smem_of(int block) {
  return (size_t)(smj_bitonic::tile_slots<kPer>(block) + 1) *
         sizeof(long long);
}

// Lets the kernel take its tile and asks for the largest shared memory
// carveout.
template <int kBlock>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_pairs_kernel<kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_of(kBlock));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(block_sort_pairs_kernel<kBlock>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Launches (stream non-null) or reports the CTAs an SM into *ctas.
template <int kBlock>
int run(const int* keys, const int* pays, int* out_keys, int* out_pays,
        long long n, int nblocks, bool descending, cudaStream_t stream,
        int* ctas) {
  const cudaError_t err = prepare<kBlock>();
  if (err != cudaSuccess) return (int)err;
  if (ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, block_sort_pairs_kernel<kBlock>, kBlock / kPer,
        smem_of(kBlock));
  block_sort_pairs_kernel<kBlock><<<nblocks, kBlock / kPer, smem_of(kBlock),
                                    stream>>>(keys, pays, out_keys, out_pays,
                                              n, descending);
  return (int)cudaGetLastError();
}

int dispatch(const int* keys, const int* pays, int* out_keys, int* out_pays,
             long long n, int block, int nblocks, bool descending,
             cudaStream_t stream, int* ctas) {
  static_assert(16384 / kPer <= kMaxThreads, "too many threads a CTA");
  switch (block) {
    case 1024: return run<1024>(keys, pays, out_keys, out_pays, n, nblocks,
                                descending, stream, ctas);
    case 2048: return run<2048>(keys, pays, out_keys, out_pays, n, nblocks,
                                descending, stream, ctas);
    case 4096: return run<4096>(keys, pays, out_keys, out_pays, n, nblocks,
                                descending, stream, ctas);
    case 8192: return run<8192>(keys, pays, out_keys, out_pays, n, nblocks,
                                descending, stream, ctas);
    case 16384: return run<16384>(keys, pays, out_keys, out_pays, n, nblocks,
                                  descending, stream, ctas);
    default: return (int)cudaErrorInvalidValue;
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
  return dispatch(keys, payloads, out_keys, out_payloads, n, block, nblocks,
                  descending != 0, (cudaStream_t)stream, nullptr);
}

// The CTAs an SM holds of block_sort_pairs_kernel at `block`, into *ctas
// (a host int): its registers, threads and shared tile together.
SMJ_API int smj_block_sort_pairs_occupancy(int block, int* ctas) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, 0, block, 0, false,
                  nullptr, ctas);
}
