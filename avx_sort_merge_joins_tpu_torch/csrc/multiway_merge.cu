// K2 and K6: merge each group of `fanin` consecutive ascending runs into
// one ascending run, in the uniform-lens layout.  K2 merges int32 keys; K6
// merges (key, payload) int32 pairs, given as two columns, in lexicographic
// order.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/multiwaymerge.py
// `_mwaymerge_kernel` (reached through `multiway_merge`: keys-only with
// leaf prefetch for K2, `keys_only=False` with two FIFO trees and four
// head windows for K6), which streams each group through a FIFO heap tree
// in VMEM, one program per group.  Run r starts at r * span and holds
// clip(total - r * span, 0, span) elements; group g's output starts at
// g * fanin * span.
//
// What bounds it on the H100: each key is read and written once in device
// memory (8 B; 16 B per pair), but finding its output position costs
// (fanin - 1) binary searches of log2(span) dependent steps.  Neighbouring
// threads hold neighbouring elements of one sorted run, so their searches
// walk the same path and hit L1/L2; the kernel is bound by load latency
// and L1/L2 throughput, not by device-memory bandwidth.  K6 probes both
// planes on every step (smj_pair_bound): twice K2's loads per step, but
// the two are independent and cost one round of latency.  Loading the
// payload plane only after the keys tie saves loads but pays a second,
// dependent round on every tie, and the (hi, lo) planes of KEY_8B keys
// that fit in 32 bits tie on every step.  On an NVIDIA H100 80GB HBM3
// (700 W), the four levels of a 128M-pair sort took 131.6 ms with both
// planes probed, on any data; probing on a tie only took 115.0 ms on
// foreign keys with random payloads and 206.1 ms on KEY_8B planes
// (scripts/exp_torch_k6_probe.py).
//
// Design: a rank-scatter merge.  One thread per input element e at index i
// of run r writes it to
//   group start + i + sum_{j<r} upper_bound(run j, e)
//                   + sum_{j>r} lower_bound(run j, e),
// which is a unique position even under duplicates: equal elements of an
// earlier run go first (as the TPU kernel's A-side preference does), so
// the same (key, payload) pair sitting in several runs of a group still
// lands in distinct slots.  No block waits on another, so the last level
// -- a single serial stream on the TPU -- fills the card like every other
// level.  Positions total .. cap - 1 get the pad: INT32_MAX, on both
// planes for K6.  A real pair whose payload is INT32_MAX or INT32_MIN
// still sorts before the pad pair, whose key no real pair has, and the
// pads lie outside every run's [start, end) so no search sees them.
// Offsets are 64-bit.
//
// The varlen mode of K2 (smj_multiway_merge_varlen) takes the run lengths
// from an int32 device vector instead of the uniform formula: the
// counterpart of the TPU kernel's dynamic-lens mode
// (ops/multiwaymerge.py:522-560), which the distributed joins use to merge
// the runs each shard receives.  Runs may be empty, the stride need not be
// a power of two, and a group whose live keys fall short of its region
// ends in pads.
#include "smj_common.cuh"

namespace {

constexpr int kThreads = 256;

// Upper or lower bound of element v in one run: v is an int32 key (K2) or
// a packed (key, payload) pair (K6).
template <bool kPairs>
__device__ __forceinline__ long long bound(const int* __restrict__ k,
                                           const int* __restrict__ p,
                                           long long lo, long long hi,
                                           long long v, bool upper) {
  if constexpr (kPairs) {
    return upper ? smj_pair_bound<true>(k, p, lo, hi, v)
                 : smj_pair_bound<false>(k, p, lo, hi, v);
  } else {
    return upper ? smj_upper_bound(k, lo, hi, (int)v)
                 : smj_lower_bound(k, lo, hi, (int)v);
  }
}

template <bool kPairs>
__global__ void multiway_merge_kernel(const int* __restrict__ in_k,
                                      const int* __restrict__ in_p,
                                      int* __restrict__ out_k,
                                      int* __restrict__ out_p, long long cap,
                                      long long total, long long span,
                                      int fanin) {
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= cap) return;
  if (at >= total) {
    out_k[at] = SMJ_KEY_POS_INF;
    if constexpr (kPairs) out_p[at] = SMJ_KEY_POS_INF;
    return;
  }
  const int key = in_k[at];
  int pay = 0;
  if constexpr (kPairs) pay = in_p[at];
  const long long v = kPairs ? smj_pack(key, pay) : (long long)key;
  const long long r = at / span;
  const long long first = r - r % fanin;  // first run of this group
  long long dst = first * span + (at - r * span);
  for (long long j = first; j < first + fanin; ++j) {
    const long long start = j * span;
    if (start >= total) break;
    if (j == r) continue;
    const long long end = start + span < total ? start + span : total;
    dst += bound<kPairs>(in_k, in_p, start, end, v, j < r) - start;
  }
  out_k[dst] = key;
  if constexpr (kPairs) out_p[dst] = pay;
}

__device__ __forceinline__ long long run_len(const int* __restrict__ lens,
                                             long long r, long long stride) {
  const long long l = __ldg(lens + r);
  return l < 0 ? 0 : (l > stride ? stride : l);
}

// K2 with run lengths in device memory (varlen): run r starts at
// r * stride and holds lens[r] keys (clamped to [0, stride]); group g of
// `fanin` runs merges into [g * fanin * stride, ...), its live keys first
// and INT32_MAX after them.  Each thread plays two roles for its slot:
// as an input slot it scatters its key like the uniform kernel, searching
// only the live prefix of each other run; as an output slot past its
// group's live total it writes the pad.  The two sets of writes are
// disjoint.  Slots past the last group are pads.
__global__ void multiway_merge_varlen_kernel(const int* __restrict__ in_k,
                                             const int* __restrict__ lens,
                                             int* __restrict__ out_k,
                                             long long cap, long long nruns,
                                             long long stride, int fanin) {
  const long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= cap) return;
  if (at >= nruns * stride) {
    out_k[at] = SMJ_KEY_POS_INF;
    return;
  }
  const long long r = at / stride;
  const long long i = at - r * stride;
  const long long first = r - r % fanin;
  long long group_total = 0;
  for (long long j = first; j < first + fanin; ++j)
    group_total += run_len(lens, j, stride);
  if (at - first * stride >= group_total) out_k[at] = SMJ_KEY_POS_INF;
  if (i >= run_len(lens, r, stride)) return;
  const int key = in_k[at];
  long long dst = first * stride + i;
  for (long long j = first; j < first + fanin; ++j) {
    if (j == r) continue;
    const long long start = j * stride;
    const long long end = start + run_len(lens, j, stride);
    dst += (j < r ? smj_upper_bound(in_k, start, end, key)
                  : smj_lower_bound(in_k, start, end, key)) - start;
  }
  out_k[dst] = key;
}

}  // namespace

// Varlen K2: merges the groups of `fanin` runs of in_k (run r at r * stride,
// lens[r] keys, lens an int32 device vector of nruns entries, nruns a
// multiple of fanin) into out_k [0, cap); cap >= nruns * stride.
SMJ_API int smj_multiway_merge_varlen(const int* in_k, const int* lens,
                                      int* out_k, long long cap,
                                      long long nruns, long long stride,
                                      int fanin, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  const long long blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  multiway_merge_varlen_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      in_k, lens, out_k, cap, nruns, stride, fanin);
  return (int)cudaGetLastError();
}

// Merges in_k (and in_p, or NULL for keys only) [0, total) group by group
// into out_k (out_p) [0, cap); cap >= total.  The wrapper makes the
// tensors' card current.
SMJ_API int smj_multiway_merge(const int* in_k, const int* in_p, int* out_k,
                               int* out_p, long long cap, long long total,
                               long long span, int fanin, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  const long long blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_p == nullptr) {
    multiway_merge_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        in_k, in_p, out_k, out_p, cap, total, span, fanin);
  } else {
    multiway_merge_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        in_k, in_p, out_k, out_p, cap, total, span, fanin);
  }
  return (int)cudaGetLastError();
}
