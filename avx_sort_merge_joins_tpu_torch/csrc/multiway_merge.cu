// K2 and K6: merge each group of `fanin` consecutive ascending runs into
// one ascending run.  K2 merges int32 keys; K6 merges (key, payload) int32
// pairs, given as two columns, in lexicographic order.  Both take the
// uniform-lens layout (smj_multiway_merge: run r starts at r * span and
// holds clip(total - r * span, 0, span) elements) or run lengths from an
// int32 device vector (smj_multiway_merge_varlen: run r starts at
// r * stride and holds lens[r] elements, clamped to [0, stride]).  Group g
// merges into [g * fanin * stride, ...): its live elements first, then
// INT32_MAX on both planes up to the end of its region; slots past the
// last group's region are pads too.
//
// Replaces the TPU kernel avx_sort_merge_joins_tpu/ops/multiwaymerge.py
// `_mwaymerge_kernel` (reached through `multiway_merge`: keys-only with
// leaf prefetch for K2, `keys_only=False` with two FIFO trees and four
// head windows for K6, uniform lens or a dynamic `lens` vector), which
// streams each group through a FIFO heap tree in VMEM, one program per
// group.  Here a group spreads over the whole card: the last level of a
// 128M sort is one group.
//
// What bounds it on the H100: each element is read and written once in
// device memory (8 B a key, 16 B a pair), plus the co-rank scratch (one
// int64 a run a tile boundary).  The merge is bound by shared memory and
// instruction issue, log2(W) merge steps an element, and the co-rank
// search by dependent loads.
//
// Design: merge-path tiles of kTile outputs, three launches; the co-rank
// search and the tile merge are merge_path.cuh's, shared with K11.  K9
// (chunk_gated_merge.cu) runs the varlen mode's launches, its gate
// between the co-ranks and the tile merge.  The keys-only launches also
// come at tiles of 2,048 and 8,192 outputs (the entries' `tile`: the -m
// merge-buffer size picks one); pairs and every other caller take kTile
// = 4,096.
//   1. corank_kernel, coarse: one warp per coarse boundary b = min(t *
//      kTile, live) of a group, t a multiple of kCoarse, finds each run's
//      consumed prefix c[t][r] (ties go to the lower run), its windows
//      starting as the whole runs.
//   2. corank_kernel, fine: the same search for every other boundary,
//      inside the windows the two coarse boundaries around it leave: at
//      most kCoarse tiles of outputs, not the whole run.
//   3. merge_kernel, one CTA per tile: it merges the tile's W segments
//      [c[t][r], c[t+1][r]) in shared memory, writes the tile back
//      coalesced, and writes the pads after the group's live elements.
// Pairs travel as one int64 whose signed order is the lexicographic order
// (smj_pack); the pad pair packs to LLONG_MAX, so a real payload equal to
// INT32_MAX or INT32_MIN still sorts before it.  Offsets are 64-bit.
#include "merge_path.cuh"

namespace {

using smj_mp::kTile;  // outputs a merge tile
// Threads of a merge tile of kTileN outputs: kTileN / 16 for keys (256 at
// kTile), 6 * kTile / kTileN CTAs an SM at least, so that the registers
// and the shared buffers an SM holds are the same at every tile; 512 for
// pairs (only at kTile), whose two 34 KB buffers allow 3 CTAs an SM
// (registers capped to fit: 44 allowed only 2).  Each thread merges
// kTileN / threads outputs a round.
template <typename E, int kTileN>
constexpr int kMergeThreads = sizeof(E) == 8 ? 512 : kTileN / 16;
template <typename E, int kTileN>
constexpr int kMergeMinBlocks = sizeof(E) == 8 ? 3 : 6 * kTile / kTileN;
constexpr int kCorankThreads = 256;
constexpr int kCoarse = 32;  // tiles between two coarse boundaries
constexpr int kMaxFanin = 2048;      // keys
constexpr int kMaxPairFanin = 1024;  // pairs
// shared memory of a co-rank CTA, at most: its warps' windows
constexpr long long kCorankSmem = 48 * 1024;

// The runs of one call.  Run r starts at r * stride; it holds lens[r]
// elements, or (lens null, the uniform layout) clip(total - r * stride, 0,
// stride).  p is null for keys only.
struct Runs {
  const int* k;
  const int* p;
  const int* lens;
  long long total;
  long long stride;

  __device__ __forceinline__ long long len(long long r) const {
    const long long l = lens != nullptr ? (long long)__ldg(lens + r)
                                        : total - r * stride;
    return l < 0 ? 0 : (l > stride ? stride : l);
  }

  __device__ __forceinline__ smj_mp::Cols<SmjLdgLoad> cols() const {
    return {k, p, SmjLdgLoad()};
  }
};

template <typename E>
__device__ __forceinline__ void store_elem(int* __restrict__ k,
                                           int* __restrict__ p, long long i,
                                           E v) {
  if constexpr (sizeof(E) == 8) {
    k[i] = smj_key(v);
    p[i] = smj_payload(v);
  } else {
    k[i] = v;
  }
}

// Warps of a co-rank CTA at fan-in W: as many as kCorankSmem holds
// windows for, at most kCorankThreads / 32.
int corank_warps(int W) {
  const long long per = smj_mp::corank_words(W) * 8;
  const long long w = kCorankSmem / per;
  return (int)(w < 1 ? 1 : (w > kCorankThreads / 32 ? kCorankThreads / 32
                                                     : w));
}

// c[g][t][r] for the boundaries t of every group (tpg + 1 of them a group:
// t = 0 .. tpg, tiles of kTileN outputs); coarse: t a multiple of
// kCoarse, and tpg; fine: every other t.  One warp a boundary, its
// starting windows in dynamic shared memory (kRegs, fan-in <= 32: the
// search then keeps them in registers).
template <typename E, bool kRegs, int kTileN>
__global__ void __launch_bounds__(kCorankThreads)
corank_kernel(Runs runs, long long* __restrict__ c, long long ngroups,
              long long tpg, int W, bool coarse) {
  extern __shared__ long long ws_all[];
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per = coarse ? (tpg + kCoarse - 1) / kCoarse + 1 : tpg + 1;
  if (warp >= ngroups * per) return;  // the same for the whole warp
  const long long g = warp / per;
  long long t = warp - g * per;
  if (coarse) {
    t = t * kCoarse < tpg ? t * kCoarse : tpg;
  } else if (t % kCoarse == 0 || t == tpg) {
    return;
  }
  long long* ws = ws_all + (threadIdx.x >> 5) * smj_mp::corank_words(W);
  long long* wlo = ws;
  long long* whi = ws + W;
  const long long run0 = g * W;
  long long live = 0;
  for (int r = lane; r < W; r += 32) live += runs.len(run0 + r);
  live = smj_mp::group_sum(live, 32);
  const long long b = t * kTileN < live ? t * kTileN : live;
  long long* row = c + (g * (tpg + 1) + t) * W;
  if (coarse) {
    for (int r = lane; r < W; r += 32) {
      wlo[r] = 0;
      whi[r] = runs.len(run0 + r);
    }
  } else {
    const long long t0 = t / kCoarse * kCoarse;
    const long long t1 = t0 + kCoarse < tpg ? t0 + kCoarse : tpg;
    const long long* lo_row = c + (g * (tpg + 1) + t0) * W;
    const long long* hi_row = c + (g * (tpg + 1) + t1) * W;
    for (int r = lane; r < W; r += 32) {
      wlo[r] = lo_row[r];
      whi[r] = hi_row[r];
    }
  }
  __syncwarp();
  smj_mp::corank<E, kRegs>(runs.cols(), run0 * runs.stride, runs.stride, W,
                           b, ws, row, lane);
}

// Dynamic shared memory of a merge tile of kTileN outputs: two buffers,
// then W segment starts (int64) and W + 1 segment offsets (int).  The
// wrapper's merge_smem_bytes is this sum for keys.
template <typename E, int kTileN>
constexpr size_t merge_smem(int W) {
  return 2 * smj_mp::buf_elems<E, kTileN>() * sizeof(E) + (size_t)W * 8 +
         (size_t)(W + 1) * 4;
}

// One CTA a tile: tiles [0, ngroups * tpg) merge tile t of group g, the
// rest write the pads past the last group's region.
template <typename E, int kTileN>
__global__ void __launch_bounds__(kMergeThreads<E, kTileN>,
                                  kMergeMinBlocks<E, kTileN>)
merge_kernel(Runs runs, const long long* __restrict__ c,
             int* __restrict__ out_k, int* __restrict__ out_p, long long cap,
             long long ngroups, long long tpg, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = kMergeThreads<E, kTileN>;
  E* buf0 = reinterpret_cast<E*>(smem);
  E* buf1 = buf0 + smj_mp::buf_elems<E, kTileN>();
  long long* src =
      reinterpret_cast<long long*>(buf1 + smj_mp::buf_elems<E, kTileN>());
  int* offs = reinterpret_cast<int*>(src + W);
  const int tid = threadIdx.x;
  const long long region = (long long)W * runs.stride;
  const long long tile = blockIdx.x;
  long long out0, end;  // the tile's first slot and the end of its slots
  int n = 0;            // live outputs of the tile
  if (tile < ngroups * tpg) {
    const long long g = tile / tpg;
    const long long t = tile - g * tpg;
    const long long d0 = t * kTileN;
    out0 = g * region + d0;
    end = out0 + (region - d0 < kTileN ? region - d0 : kTileN);
    const long long* row0 = c + (g * (tpg + 1) + t) * W;
    const long long* row1 = row0 + W;
    for (int r = tid; r < W; r += blockDim.x) {
      const long long a = row0[r];
      src[r] = (g * W + r) * runs.stride + a;
      offs[r + 1] = (int)(row1[r] - a);
    }
    __syncthreads();
    if (tid == 0) {
      offs[0] = 0;
      for (int r = 0; r < W; ++r) offs[r + 1] += offs[r];
    }
    __syncthreads();
    n = offs[W];
  } else {
    out0 = ngroups * region + (tile - ngroups * tpg) * kTileN;
    end = out0 + kTileN;
  }
  if (end > cap) end = cap;
  if (n > 0) {  // the same branch for the whole CTA
    const E* merged = smj_mp::merge_tile<E, kThreads, kTileN>(
        runs.cols(), src, offs, W, buf0, buf1);
    for (int p = tid; p < n; p += kThreads)
      store_elem<E>(out_k, out_p, out0 + p, merged[smj_mp::sw<E>(p)]);
  }
  for (long long i = out0 + n + tid; i < end; i += kThreads) {
    out_k[i] = SMJ_KEY_POS_INF;
    if constexpr (sizeof(E) == 8) out_p[i] = SMJ_KEY_POS_INF;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename E, int kTileN>
int launch_coranks(const Runs& runs, long long* c, long long ngroups,
                   long long tpg, int W, int parts, cudaStream_t s) {
  const long long warps[2] = {ngroups * (cdiv(tpg, kCoarse) + 1),
                              ngroups * (tpg + 1)};
  const int cta_warps = corank_warps(W);
  const size_t smem = (size_t)cta_warps * smj_mp::corank_words(W) * 8;
  if (W > 32 && smem > 48 * 1024) {  // fan-in 2,048: one warp's 64 KB
    const cudaError_t err = cudaFuncSetAttribute(
        corank_kernel<E, false, kTileN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int pass = 0; pass < 2; ++pass) {
    if ((parts & (1 << pass)) == 0) continue;
    const long long blocks = cdiv(warps[pass], cta_warps);
    if (W <= 32) {  // one run a lane: the windows in registers
      corank_kernel<E, true, kTileN>
          <<<(unsigned)blocks, cta_warps * 32, smem, s>>>(
              runs, c, ngroups, tpg, W, pass == 0);
    } else {
      corank_kernel<E, false, kTileN>
          <<<(unsigned)blocks, cta_warps * 32, smem, s>>>(
              runs, c, ngroups, tpg, W, pass == 0);
    }
  }
  return (int)cudaSuccess;
}

// The three launches of one merge at tiles of kTileN outputs; c holds at
// least ngroups * (tpg + 1) * W int64s.  parts is a mask of the launches
// to make: 1 the coarse co-ranks, 2 the fine ones, 4 the tile merge (on
// the co-ranks c holds).
template <typename E, int kTileN>
int launch(const Runs& runs, int* out_k, int* out_p, long long* c,
           long long c_elems, long long cap, long long ngroups, int W,
           int parts, cudaStream_t s) {
  if (W < 2 || W > kMaxFanin || (W & (W - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long region = (long long)W * runs.stride;
  const long long tpg = cdiv(region, kTileN);
  if (c_elems < ngroups * (tpg + 1) * W) return (int)cudaErrorInvalidValue;
  const long long done = ngroups * region;
  const long long tiles = ngroups * tpg + (cap > done ? cdiv(cap - done,
                                                           kTileN) : 0);
  if (tiles > INT_MAX || ngroups * (tpg + 1) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int err0 = launch_coranks<E, kTileN>(runs, c, ngroups, tpg, W, parts,
                                             s);
  if (err0 != (int)cudaSuccess) return err0;
  if ((parts & 4) == 0) return (int)cudaGetLastError();
  const size_t smem = merge_smem<E, kTileN>(W);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<E, kTileN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    merge_kernel<E, kTileN>
        <<<(unsigned)tiles, kMergeThreads<E, kTileN>, smem, s>>>(
            runs, c, out_k, out_p, cap, ngroups, tpg, W);
  }
  return (int)cudaGetLastError();
}

// tile: outputs a merge tile, kTile for pairs; 2,048, 4,096 or 8,192 for
// keys.  Pairs merge at fan-in kMaxPairFanin at most.
int launch_any(const Runs& runs, int* out_k, int* out_p, long long* c,
               long long c_elems, long long cap, long long ngroups,
               int fanin, int tile, int parts, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  if (parts < 1 || parts > 7) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (runs.p != nullptr) {
    if (tile != kTile || fanin > kMaxPairFanin)
      return (int)cudaErrorInvalidValue;
    return launch<long long, kTile>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
  }
  switch (tile) {
    case kTile / 2:
      return launch<int, kTile / 2>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
    case kTile:
      return launch<int, kTile>(runs, out_k, out_p, c, c_elems, cap, ngroups,
                                fanin, parts, s);
    case kTile * 2:
      return launch<int, kTile * 2>(runs, out_k, out_p, c, c_elems, cap,
                                    ngroups, fanin, parts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Elements (int64) of the co-rank scratch a merge of ngroups groups of
// `fanin` runs of `stride` slots needs at tiles of `tile` outputs
// (tile >= 1).
SMJ_API long long smj_multiway_merge_scratch(long long ngroups,
                                             long long stride, int fanin,
                                             int tile) {
  if (tile < 1) return -1;
  return ngroups * (cdiv((long long)fanin * stride, tile) + 1) * fanin;
}

// Merges in_k (and in_p, or NULL for keys only) [0, total), runs of
// `span`, group by group into out_k (out_p) [0, cap); cap >= total.
// tile: outputs a merge tile, kTile with pairs; 2,048, 4,096 or 8,192
// for keys.  scratch: scratch_elems >= smj_multiway_merge_scratch(...,
// tile) int64s on the card.  parts is 7; a mask of 1 (coarse co-ranks),
// 2 (fine co-ranks) and 4 (tile merge) runs only those launches, for
// timing each.  The wrapper makes the tensors' card current.
SMJ_API int smj_multiway_merge(const int* in_k, const int* in_p, int* out_k,
                               int* out_p, long long* scratch,
                               long long scratch_elems, long long cap,
                               long long total, long long span, int fanin,
                               int tile, int parts, void* stream) {
  if (span < 1 || fanin < 2) return (int)cudaErrorInvalidValue;
  const long long nruns = total > 0 ? cdiv(total, span) : 1;
  const Runs runs{in_k, in_p, nullptr, total, span};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    cdiv(nruns, fanin), fanin, tile, parts, stream);
}

// The varlen mode: run r at r * stride holds lens[r] elements (lens an
// int32 device vector of nruns entries, nruns a multiple of fanin);
// cap >= nruns * stride.  tile as for smj_multiway_merge.
SMJ_API int smj_multiway_merge_varlen(const int* in_k, const int* in_p,
                                      int* out_k, int* out_p,
                                      long long* scratch,
                                      long long scratch_elems, long long cap,
                                      const int* lens, long long nruns,
                                      long long stride, int fanin, int tile,
                                      int parts, void* stream) {
  if (stride < 1 || fanin < 2 || nruns % fanin != 0)
    return (int)cudaErrorInvalidValue;
  const Runs runs{in_k, in_p, lens, 0, stride};
  return launch_any(runs, out_k, out_p, scratch, scratch_elems, cap,
                    nruns / fanin, fanin, tile, parts, stream);
}
