// K4: one pairwise merge pass.  The run pairs (2j, 2j+1) merge into runs of
// twice the length, keys only or (key, payload) pairs in lexicographic
// order; in the uniform mode every run `span` long but the last ones,
// ascending or descending; in the varlen mode every run at a fixed stride
// with its length in a device vector, ascending.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/sort.py
// `_merge_pass_kernel` / `_merge_pair_body` (reached through `merge_pass`,
// keys-only and with payloads, uniform lens or a traced `lens` vector with
// `b_asc`).  There one program per run pair streams an (asc, desc) pair
// through VMEM windows and a log2(T)-stage bitonic merge.  Uniform: run r
// starts at r * span and holds clip(total - r * span, 0, span) elements.
// Varlen: run r starts at r * stride and holds clip(lens[r], 0, stride).
// Output run j starts at 2j * span (2j * stride).
//
// What bounds it on the H100: each element is read and written once (8 B
// per key, 16 B per pair; in the varlen mode every slot of the output is
// written, pads included), so a pass is bound by device-memory bandwidth.
//
// Design, from timings of the parts of the kernel it replaces (PERF.md,
// K4): that kernel gave each CTA 2,048 outputs and searched both of its
// ends with 32 lanes in device memory, so its searches alone took a
// quarter to a half of the pass.  Here a CTA owns consecutive merge-path
// tiles of one pair (Shape: keys 7 tiles of 4,096 outputs, pairs 2 of
// 2,048).  It searches the tiles' boundaries at once, 4 lanes a boundary
// (every round a group probes 4 candidates and keeps the interval its
// ballot points to: fewer scattered sectors a search than 32 lanes, which
// cost more than their rounds saved), once for the CTA.  Each tile then
// goes through merge_path.cuh's tile merge at W = 2 (the round K2, K6 and
// K11 take log2(W) of): its A and B segments are loaded coalesced into
// registers, staged in the padded shared buffer, merged in one pairwise
// merge-path round and written back coalesced.  Keys load the next tile
// during the merge and store (47 registers, 5 CTAs an SM); pairs, whose
// loads ahead would take 16 more registers, keep 6 CTAs an SM at 40
// registers instead, which hides their loads better, and take 2 tiles a
// CTA, which spreads a 16M-pair pass over more CTAs.  Ties go to run A; in
// pair mode equal elements are identical, so the output is fixed exactly.  Pairs travel as one int64 whose signed order is the
// lexicographic order (smj_pack).  The descending merge is the ascending
// merge of the bitwise complements (~ reverses the signed order of a key,
// and ~smj_pack(k, p) == smj_pack(~k, ~p)): the loads complement, the
// stores complement back.  A run without a partner (odd run count, or an
// empty B) is copied through.  The slots of a pair's output run past its
// live length get the pad that sorts last in the pass's direction (in the
// uniform mode the slots from `total` to the end of the buffer).  The
// TPU's (asc, desc) run pairs, `flip` and `b_asc` existed because Mosaic
// has no reverse: here both runs of a pair go the output's direction.
#include <type_traits>

#include "merge_path.cuh"

namespace {

// A CTA's shape for keys (E = int) and pairs (E = long long): its threads,
// the outputs a tile, the CTAs an SM its registers must leave room for,
// its tiles (their kGroup + 1 boundaries searched at once, kLanes lanes a
// boundary) and whether it loads each next tile during a merge, from
// bench/kernel_variants.py (PERF.md, K4).
constexpr int kLanes = 4;

template <int kThreadsN, int kTileN, int kMinCtasN, int kGroupN,
          bool kPrefetchN>
struct ShapeOf {
  static constexpr int kThreads = kThreadsN;
  static constexpr int kTile = kTileN;
  static constexpr int kMinCtas = kMinCtasN;
  static constexpr int kGroup = kGroupN;
  static constexpr bool kPrefetch = kPrefetchN;
  static constexpr int kPerThread = kTile / kThreads;
  static constexpr int kSearchers = ((kGroup + 1) * kLanes + 31) / 32 * 32;
  static_assert(kSearchers <= kThreads && kGroup <= kThreads &&
                    kLanes <= 32 && kTile % kThreads == 0,
                "the boundaries' searches take whole warps of the CTA");
};

template <typename E>
struct Shape;
template <>
struct Shape<int> : ShapeOf<256, 4096, 5, 7, true> {};  // keys
template <>
struct Shape<long long> : ShapeOf<256, 2048, 6, 2, false> {};  // pairs

// A key's complement: the loads of a descending pass.
struct SmjNotLdgLoad {
  __device__ __forceinline__ int operator()(const int* p) const {
    return ~__ldg(p);
  }
};

// Uniform mode: run r holds clip(total - r * span, 0, span) elements.
struct UniformRuns {
  long long total;
  long long span;

  __device__ __forceinline__ long long len(long long r) const {
    const long long left = total - r * span;
    return left < 0 ? 0 : (left < span ? left : span);
  }
};

// Varlen mode: run r holds clip(lens[r], 0, stride) elements.
struct VarlenRuns {
  const int* lens;
  long long stride;

  __device__ __forceinline__ long long len(long long r) const {
    const long long v = __ldg(lens + r);
    return v < 0 ? 0 : (v < stride ? v : stride);
  }
};

// Co-rank of diagonal d of merge(A[0, la), B[0, lb)): how many of its first
// d outputs come from A, runs at a0 and b0 of the columns (A wins ties).
// Called by whole warps, each aligned group of kLanes lanes with its own
// d; returns the group's co-rank in each of its lanes.  Each round the
// group probes kLanes candidates at once and keeps the interval its ballot
// points to.
template <typename E, class C>
__device__ long long group_co_rank(const C& cols, long long a0, long long la,
                                   long long b0, long long lb, long long d) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int shift = lane - sub;  // the group's first lane
  const unsigned group = kLanes == 32
                             ? smj_mp::kFullWarp
                             : ((1u << (kLanes % 32)) - 1u) << shift;
  long long lo = d > lb ? d - lb : 0;
  long long hi = d < la ? d : la;
  // invariant: the co-rank lies in [lo, hi]; A[i] is among the first d
  // outputs iff A[i] <= B[d - 1 - i], true for i below the co-rank
  while (__any_sync(smj_mp::kFullWarp, lo < hi)) {
    const long long step = (hi - lo + kLanes - 1) / kLanes;
    const long long i = lo + sub * step;
    const bool in = i < hi && cols.template at<E>(a0 + i) <=
                                  cols.template at<E>(b0 + d - 1 - i);
    const int c = __popc(__ballot_sync(smj_mp::kFullWarp, in) & group);
    if (lo < hi) {
      if (c == 0) {
        hi = lo;
      } else {
        const long long last_in = lo + (c - 1) * step;
        const long long first_out = last_in + step;
        lo = last_in + 1;
        if (first_out < hi) hi = first_out;
      }
    }
  }
  return lo;
}

// Writes element v (in the merge's domain) to slot i of the output.
template <typename E, bool kDesc>
__device__ __forceinline__ void store(int* __restrict__ k,
                                      int* __restrict__ p, long long i, E v) {
  if constexpr (kDesc) v = ~v;
  if constexpr (sizeof(E) == 8) {
    k[i] = smj_key(v);
    p[i] = smj_payload(v);
  } else {
    k[i] = v;
  }
}

// CTA b: pair b / groups, outputs [g kGroup kTile, (g + 1) kGroup kTile) of
// that pair's output run, g = b % groups; `stride` is the distance of two
// runs (span or stride), cap the buffer's slots.  The CTA searches its
// tiles' kGroup + 1 boundaries at once, then merges its tiles one by one
// (with kPrefetch, loading the next into registers during each merge).
template <typename E, bool kDesc, class Runs>
__global__ void __launch_bounds__(Shape<E>::kThreads, Shape<E>::kMinCtas)
merge_pass_kernel(const int* __restrict__ in_k, const int* __restrict__ in_p,
                  int* __restrict__ out_k, int* __restrict__ out_p,
                  long long cap, Runs runs, long long stride,
                  long long groups) {
  using S = Shape<E>;
  constexpr int kThreads = S::kThreads, kTile = S::kTile;
  constexpr int kGroup = S::kGroup;
  extern __shared__ long long merge_pass_smem[];
  E* const buf0 = reinterpret_cast<E*>(merge_pass_smem);
  E* const buf1 = buf0 + smj_mp::buf_elems<E, kTile>();
  __shared__ long long cor[kGroup + 1];
  __shared__ long long src[kGroup][2];
  __shared__ int offs[kGroup][3];
  using Load =
      typename std::conditional<kDesc, SmjNotLdgLoad, SmjLdgLoad>::type;
  const smj_mp::Cols<Load> cols{in_k, in_p, Load{}};
  const long long pair = blockIdx.x / groups;
  const long long a0 = 2 * pair * stride;
  const long long b0 = a0 + stride;
  const long long la = runs.len(2 * pair);
  const long long lb = runs.len(2 * pair + 1);
  const long long len = la + lb;
  const long long region = cap - a0 < 2 * stride ? cap - a0 : 2 * stride;
  const long long d_begin = (blockIdx.x % groups) * (long long)kGroup * kTile;
  const long long d_end = d_begin + (long long)kGroup * kTile < region
                              ? d_begin + (long long)kGroup * kTile
                              : region;
  const long long live_end = d_end < len ? d_end : len;
  if (d_begin < live_end) {  // the same branch for the whole CTA
    if (threadIdx.x < S::kSearchers) {
      const int j = threadIdx.x / kLanes;  // past kGroup: a search of d_end
      const long long d = j <= kGroup && d_begin + (long long)j * kTile <
                                             live_end
                              ? d_begin + (long long)j * kTile
                              : live_end;
      const long long c = group_co_rank<E>(cols, a0, la, b0, lb, d);
      if (threadIdx.x % kLanes == 0 && j <= kGroup) cor[j] = c;
    }
    __syncthreads();
    const int ntiles = (int)((live_end - d_begin + kTile - 1) / kTile);
    if (threadIdx.x < ntiles) {
      const int t = threadIdx.x;
      const long long t0 = d_begin + (long long)t * kTile;
      src[t][0] = a0 + cor[t];
      src[t][1] = b0 + (t0 - cor[t]);
      offs[t][0] = 0;
      offs[t][1] = (int)(cor[t + 1] - cor[t]);
      offs[t][2] = (int)(t0 + kTile < live_end ? kTile : live_end - t0);
    }
    __syncthreads();
    E v[S::kPerThread];
    if (S::kPrefetch)
      smj_mp::load_tile<E, kThreads, kTile>(cols, src[0], offs[0], 2, v);
    for (int t = 0; t < ntiles; ++t) {
      if (!S::kPrefetch)
        smj_mp::load_tile<E, kThreads, kTile>(cols, src[t], offs[t], 2, v);
      smj_mp::stage_tile<E, kThreads, kTile>(v, offs[t][2], buf0);
      __syncthreads();
      if (S::kPrefetch && t + 1 < ntiles)
        smj_mp::load_tile<E, kThreads, kTile>(cols, src[t + 1], offs[t + 1],
                                              2, v);
      const E* m =
          smj_mp::merge_rounds<E, kThreads, kTile>(offs[t], 2, buf0, buf1);
      const long long o0 = a0 + d_begin + (long long)t * kTile;
      for (int q = threadIdx.x; q < offs[t][2]; q += kThreads)
        store<E, kDesc>(out_k, out_p, o0 + q, m[smj_mp::sw<E>(q)]);
    }
  }
  // the slots of this CTA's range past the pair's live length
  const int pad = kDesc ? SMJ_KEY_NEG_INF : SMJ_KEY_POS_INF;
  for (long long i = a0 + (d_begin > len ? d_begin : len) + threadIdx.x;
       i < a0 + d_end; i += S::kThreads) {
    out_k[i] = pad;
    if constexpr (sizeof(E) == 8) out_p[i] = pad;
  }
}

// Lets merge_pass_kernel<E, kDesc, Runs> take its two tile buffers and
// launches it over npairs pairs (stream non-null), or reports its CTAs an
// SM into *ctas.
template <typename E, bool kDesc, class Runs>
int launch(const int* in_k, const int* in_p, int* out_k, int* out_p,
           long long cap, Runs runs, long long stride, long long npairs,
           cudaStream_t stream, int* ctas) {
  using S = Shape<E>;
  const auto kernel = merge_pass_kernel<E, kDesc, Runs>;
  const size_t smem =
      2 * (size_t)smj_mp::buf_elems<E, S::kTile>() * sizeof(E);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, kernel, S::kThreads, smem);
  const long long per_cta = (long long)S::kGroup * S::kTile;
  const long long groups = (2 * stride + per_cta - 1) / per_cta;
  const long long blocks = npairs * groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  kernel<<<(unsigned)blocks, S::kThreads, smem, stream>>>(
      in_k, in_p, out_k, out_p, cap, runs, stride, groups);
  return (int)cudaGetLastError();
}

// Keys (pairs false) or pairs.
template <bool kDesc, class Runs>
int dispatch(const int* in_k, const int* in_p, int* out_k, int* out_p,
             long long cap, Runs runs, long long stride, long long npairs,
             bool pairs, cudaStream_t stream, int* ctas) {
  return pairs ? launch<long long, kDesc>(in_k, in_p, out_k, out_p, cap,
                                          runs, stride, npairs, stream, ctas)
               : launch<int, kDesc>(in_k, in_p, out_k, out_p, cap, runs,
                                    stride, npairs, stream, ctas);
}

}  // namespace

// One merge pass over in_k (and in_p, or NULL for keys only) [0, total)
// with runs of `span`, into out_k (out_p) [0, cap).  The wrapper checks
// that cap <= npairs * 2 * span and makes the tensors' card current.
SMJ_API int smj_merge_pass(const int* in_k, const int* in_p, int* out_k,
                           int* out_p, long long cap, long long total,
                           long long span, int descending, void* stream) {
  long long nruns = (total + span - 1) / span;
  if (nruns < 1) nruns = 1;
  const UniformRuns runs{total, span};
  const long long npairs = (nruns + 1) / 2;
  const bool pairs = in_p != nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return descending
             ? dispatch<true>(in_k, in_p, out_k, out_p, cap, runs, span,
                              npairs, pairs, s, nullptr)
             : dispatch<false>(in_k, in_p, out_k, out_p, cap, runs, span,
                               npairs, pairs, s, nullptr);
}

// One ascending merge pass over nruns runs (nruns even) at `stride`, run r
// holding clip(lens[r], 0, stride) elements (lens: nruns int32 on the
// card), into out_k (out_p) [0, nruns * stride), every slot past a pair's
// live length padded.  The wrapper checks the lens vector and the columns'
// size and makes the tensors' card current.
SMJ_API int smj_merge_pass_varlen(const int* in_k, const int* in_p,
                                  int* out_k, int* out_p, const int* lens,
                                  long long nruns, long long stride,
                                  void* stream) {
  return dispatch<false>(in_k, in_p, out_k, out_p, nruns * stride,
                         VarlenRuns{lens, stride}, stride, nruns / 2,
                         in_p != nullptr, (cudaStream_t)stream, nullptr);
}

// The CTAs an SM holds of the uniform, ascending pass kernel, keys only
// (pairs 0) or pairs, into *ctas (a host int).
SMJ_API int smj_merge_pass_occupancy(int pairs, int* ctas) {
  return dispatch<false>(nullptr, nullptr, nullptr, nullptr, 0,
                         UniformRuns{0, 1}, 1, 0, pairs != 0, nullptr, ctas);
}
