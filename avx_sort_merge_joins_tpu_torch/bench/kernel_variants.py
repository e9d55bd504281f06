"""Design choices of K1 (block sort), K2/K6 (multiway merge: its
co-ranks and tile merge), K3 (match count), K4 (merge pass), K5 (pair block sort), K7
(64-bit match count), K8 (radix histogram) and K11 (remote-pull push and
gated merge) of the PyTorch port, and the parts
of K9 (chunk-gated merge) and K10 (two-run count), measured against each
other on one NVIDIA GPU, from the root of a checkout (it takes
chip_smoke.py's helpers):

    python -m avx_sort_merge_joins_tpu_torch.bench.kernel_variants [k1 k3 ...]

(the variants of the kernels named among k1, k2, k3, k4, k5, k7, k8,
k9, k10, k11, default all; ``final`` always runs; naming variants runs
those alone beside ``final``; each runs twice, in order and then in
reverse).  K2 and K6 are timed
in parts (coarse co-ranks, fine co-ranks, tile merge) at the benchmark's
shapes: 128M keys, 128M pairs, a 200M-key shard and the W = 8 merge of
a shard's received runs, uniform and Zipf; outside the ``k2_part_*``
variants also one level at each fan-in W = 2-32 over 128M keys and
pairs, and whole merges (every level of a sort) greedy at fan-in 16 and
in the default plan at 128M, 200M and 2,048M keys and 128M pairs.  K4 is timed on 128M
keys in one pass of span 16,384 and one of span 2^26, and on 128M pairs at
span 16,384; K7 at 128M x 128M widened int32 keys, beside K3 on the same
int32 keys (the committed K3 in every variant: a yardstick that does not
change); K8 on 128M keys at bits 7, 14 and 16, uniform and Zipf (z = 1.0
over 2^20 values, drawn on the card), global and per tile.

Each variant is a copy of the package in the checkout with one textual
change to its CUDA sources, written under the gitignored csrc/build/variants/
and built there by the package's own builder:

  final            the sources as committed;
  k2_search_fine   K2/K6's fine co-ranks by the coarse pass's search in
                   device memory, a warp a boundary (the design before the
                   sampled one; the committed K2/K6 samples every 32nd
                   element of each coarse window and finishes each
                   boundary in shared memory);
  k2_stride_16, k2_stride_64  the sampled fine co-ranks at a sample stride
                   of 16 or 64 elements at fan-in 16 (committed: 32; the
                   stride at fan-in W < 16 is 16 / W times it);
  k2_finish_global the sampled brackets finished by the search in device
                   memory, not staged in shared memory;
  k2_finish_4, k2_finish_16  the finish ranking up to 4 or 16 windows'
                   middle elements a round (committed: 8; 16: every
                   window's at fan-in 16);
  k2_part_*        timing only, their rows are wrong (timed on 128M keys
                   alone): the sampled CTA stopping after its samples'
                   loads, after their order, after the brackets, or
                   staging the brackets without the search;
  k2_part_merge_none, k2_part_merge_one  timing only, their columns are
                   wrong where a round is left out (timed on 128M keys and
                   the card16 level): the tile merge loading, staging and
                   storing its tile with no merge round, or with the first
                   round alone (the tile merge's parts on the committed
                   co-ranks);
  k2_pairwise      K2's and K6's tile merge in the branching pairwise
                   rounds that K4 and K11 keep (merge_rounds; the committed
                   K2/K6 take every output by selects,
                   merge_rounds_select);
  k2_out32         K2's tile merge with 32 outputs a thread (128 threads at
                   tiles of 4,096; committed: 16, 256 threads);
  k2_ctas_5        K2's tile merge held to 5 CTAs an SM (up to 48 registers;
                   committed: 6, 40 registers);
  k1_one_cta       K1 allowed 128 registers, one CTA of 512 threads an SM
                   (the committed K1 is capped at 64: two CTAs an SM);
  k1_16_keys       K1 with 16 keys a thread, 1,024 threads a CTA;
  k11_one_tile     K11 with one tile a merge ticket, whose two boundaries
                   two warps search (the committed K11 takes 7 tiles a
                   ticket, 8 warps searching their 8 boundaries at once);
  k11_shared_windows  K11's co-rank windows in shared memory at every
                   shard count (the committed K11 keeps them in registers
                   up to 32 shards, one strip a lane);
  k11_gpu_scope    K11's flags released, polled and acquired at device
                   scope (right on one card only; the committed K11 uses
                   system scope, which a push to another card needs);
  k3_group_4, k3_group_16  K3 with 4 or 16 tiles a CTA (the committed
                   K3: 8 tiles of 1,920, 15 merged elements a thread, 128
                   threads, windows of 2,048);
  k3_tile_7        K3 with 7 merged elements a thread: tiles of 896 in
                   windows of 1,024;
  k3_256_threads   K3 with 256 threads a CTA: tiles of 3,840 in windows
                   of 4,096;
  k3_copy_ahead    K3 copying the next tile's keys during this tile's walk
                   (windows of 4,096; the committed K3 copies a tile's
                   keys when it comes to it);
  k3_32_registers  K3 capped at 32 registers, for 16 CTAs an SM;
  k3_part_*        timing only, their output is wrong: K3 making its
                   global searches and nothing else, or copying its tiles
                   and splitting them without walking them;
  k7_tile_7, k7_256_threads_7, k7_tile_7_copy_ahead, k7_group_4,
  k7_group_8, k7_group_32  K7 in another shape (Count64Shape in
                   csrc/merge_join_count.cu: threads, merged elements a
                   thread, tiles a CTA, window slots, tiles copied ahead;
                   committed: 128, 15, 16, 2,048, 0);
  k7_part_*        timing only, their output is wrong: K7 making its
                   global searches and nothing else, or copying its tiles
                   and splitting them without walking them (K3 and K10
                   unchanged);
  k4_part_*        timing only, their output is wrong: K4 making its tile
                   boundaries' searches and nothing else, or loading and
                   storing its tiles without merging them;
  k4_lanes_32      K4 searching each tile boundary with 32 lanes (the
                   committed K4: 4 lanes a boundary, 8 boundaries a warp);
  k4_keys_*, k4_pairs_*  K4 in another shape (threads, outputs a tile, CTAs
                   an SM its registers leave room for, tiles a CTA, the
                   next tile loaded during a merge or not; the committed
                   shapes, Shape<int> and Shape<long long> in
                   csrc/merge_pass.cu: keys 256 threads, tiles of 4,096,
                   5 CTAs, 7 tiles, loading ahead; pairs 256 threads,
                   tiles of 2,048, 6 CTAs, 2 tiles, not loading ahead);
  k4_streaming_stores  K4 writing with st.global.cs;
  k5_network_only  K5 sorting each whole block with the bitonic network
                   (the committed K5 sorts each thread's 16 pairs with its
                   register phases and merges those runs in log2(B / 16)
                   merge-path rounds);
  k5_runs_<n>      K5 with the network up to runs of n pairs, across
                   threads by shuffles (n <= 512) and shared memory;
  k5_32_pairs      K5 with 32 pairs a thread, 512 threads a CTA at
                   16,384 (up to 128 registers; the committed K5: 16
                   pairs, 1,024 threads, at most 64 registers);
  k5_part_*        timing only, their output is wrong: K5 without its
                   network, or without its merge rounds;
  k8_part_*        timing only, their output is wrong: K8 loading the keys
                   and summing them, or computing their ids and summing
                   those, with no atomic;
  k8_packed_14     K8 counting 2^14 and 2^15 bins in 16-bit halves too
                   (the committed K8 packs only 2^16);
  k8_vecs_1, k8_vecs_4  K8 with 1 or 4 16-byte loads in flight a thread
                   (committed: 2);
  k8_512_threads   K8 with 512 threads a CTA (committed: 1,024).

``final`` also times K9 on shard 0's landing of R in the 8-shard 128M
join, whole and in its parts (its entry point's mask: the co-ranks, the
gate on them, the merge on them), with each of its kernels' device time
a call from torch.profiler, and K10 at 128M x 128M, two runs a
side, beside four K3 launches over the same four run pairs, the yardstick
of its one-launch design.
"""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "avx_sort_merge_joins_tpu_torch"
CSRC = os.path.join(ROOT, PKG, "csrc")
VARIANTS_DIR = os.path.join(CSRC, "build", "variants")

# K4's shapes for keys and pairs (csrc/merge_pass.cu), by their arguments
K4_KEYS = "struct Shape<int> : ShapeOf<{}> {{}};"
K4_PAIRS = "struct Shape<long long> : ShapeOf<{}> {{}};"

# K7's shape (csrc/merge_join_count.cu), by its arguments
K7_SHAPE = "struct Count64Shape : CountShape<{}> {{}};"

# K2/K6's tile merge (csrc/multiway_merge.cu, csrc/merge_path.cuh): its
# call, K2's threads a tile and the select rounds' loop
K2_TILE = "smj_mp::merge_tile<E, kThreads, kTileN, true>("
K2_THREADS = ("constexpr int kMergeThreads = sizeof(E) == 8 ? 512 : "
              "kTileN / 16;")
K2_ROUNDS = ("  for (int s = 1; s < W; s <<= 1) {\n"
             "    merge_pairs_select<")

# keys of the card16 cell's S, whose first K2 level k2_shapes times
CARD16_S = 2_048_000_000

# the line after K8's counting loop
K8_ROW = "  int* row = out + (per_tile ? blockIdx.x * (long long)fanout : 0);"

# name -> (what it measures, [(source, committed text, variant's text)])
VARIANTS = {
    "final": (("k1", "k2", "k3", "k4", "k5", "k7", "k8", "k9", "k10",
               "k11"), []),
    "k2_search_fine": (("k2",), [
        ("multiway_merge.cu",
         "    if (pass == 1 && W <= kSampledMaxFanin) {",
         "    if (pass == 1 && W <= 0) {")]),
    "k2_stride_16": (("k2",), [
        ("multiway_merge.cu", "constexpr int kSampleStride = 32;",
         "constexpr int kSampleStride = 16;")]),
    "k2_stride_64": (("k2",), [
        ("multiway_merge.cu", "constexpr int kSampleStride = 32;",
         "constexpr int kSampleStride = 64;")]),
    "k2_finish_global": (("k2",), [
        ("multiway_merge.cu",
         "    if (total <= 2 * W * s) {  // the same branch for the whole warp",
         "    if (false) {")]),
    "k2_finish_4": (("k2",), [
        ("multiway_merge.cu", "constexpr int kFinishCandidates = 8;",
         "constexpr int kFinishCandidates = 4;")]),
    "k2_finish_16": (("k2",), [
        ("multiway_merge.cu", "constexpr int kFinishCandidates = 8;",
         "constexpr int kFinishCandidates = 16;")]),
    "k2_part_samples": (("k2",), [
        ("multiway_merge.cu", "  // b. their order, then each sample's rank",
         "  return;")]),
    "k2_part_order": (("k2",), [
        ("multiway_merge.cu", "  // c. the brackets of every interior "
         "boundary and run", "  return;")]),
    "k2_part_brackets": (("k2",), [
        ("multiway_merge.cu", "  // d. a warp a boundary: stage its "
         "brackets, then the exact search", "  return;")]),
    "k2_part_stage": (("k2",), [
        ("multiway_merge.cu",
         "      finish_candidates<E>(stk, stp, offs, W, lo, b,\n"
         "                           wfin + warp * fin_words(W), row, lane);",
         "")]),
    "k2_part_merge_none": (("k2",), [
        ("merge_path.cuh", K2_ROUNDS, K2_ROUNDS.replace("s = 1", "s = W"))]),
    "k2_part_merge_one": (("k2",), [
        ("merge_path.cuh", K2_ROUNDS, K2_ROUNDS.replace("s < W", "s < W && "
                                                        "s < 2"))]),
    "k2_pairwise": (("k2",), [
        ("multiway_merge.cu", K2_TILE, K2_TILE.replace("true", "false"))]),
    "k2_out32": (("k2",), [
        ("multiway_merge.cu", K2_THREADS,
         K2_THREADS.replace("/ 16", "/ 32"))]),
    "k2_ctas_5": (("k2",), [
        ("multiway_merge.cu", "constexpr int kMergeMinBlocks = sizeof(E) == 8 "
         "? 3 : 6 * kTile / kTileN;", "constexpr int kMergeMinBlocks = "
         "sizeof(E) == 8 ? 3 : 5 * kTile / kTileN;")]),
    "k1_one_cta": (("k1",), [
        ("block_sort.cu", "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 1;")]),
    "k1_16_keys": (("k1",), [
        ("block_sort.cu", "constexpr int kPer = 32;",
         "constexpr int kPer = 16;"),
        ("block_sort.cu", "constexpr int kMaxThreads = 512;",
         "constexpr int kMaxThreads = 1024;"),
        ("block_sort.cu", "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 1;")]),
    "k11_one_tile": (("k11",), [
        ("remote_pull.cu", "  a.span = group_span(n);",
         "  a.span = 1;")]),
    "k11_shared_windows": (("k11",), [
        ("remote_pull.cu",
         "      if (a.n <= 32)  // one strip a lane: the windows in "
         "registers", "      if (false)")]),
    "k11_gpu_scope": (("k11",), [
        ("remote_pull.cu", "ld.relaxed.sys.global", "ld.relaxed.gpu.global"),
        ("remote_pull.cu", "ld.acquire.sys.global", "ld.acquire.gpu.global"),
        ("remote_pull.cu", "st.release.sys.global", "st.release.gpu.global"),
        ("remote_pull.cu", "__threadfence_system();", "__threadfence();")]),
    "k3_group_4": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountGroup = 8;",
         "constexpr int kCountGroup = 4;")]),
    "k3_group_16": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountGroup = 8;",
         "constexpr int kCountGroup = 16;")]),
    "k3_tile_7": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountPer = 15;",
         "constexpr int kCountPer = 7;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 1024;")]),
    "k3_256_threads": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountThreads = 128;",
         "constexpr int kCountThreads = 256;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 4096;")]),
    "k3_copy_ahead": (("k3",), [
        ("merge_join_count.cu", "constexpr int kCountAhead = 0;",
         "constexpr int kCountAhead = 1;"),
        ("merge_join_count.cu", "constexpr int kCountWindow = 2048;",
         "constexpr int kCountWindow = 4096;")]),
    "k3_32_registers": (("k3",), [
        ("merge_join_count.cu", "__launch_bounds__(kCountThreads)\n"
         "merge_join_count_kernel(", "__launch_bounds__(kCountThreads, 16)\n"
         "merge_join_count_kernel(")]),
    "k3_part_search": (("k3",), [
        ("merge_join_count.cu",
         "  for (int d = 0; d < span; d += kTile) {",
         "  for (int d = span; d < span; d += kTile) {")]),
    "k3_part_no_walk": (("k3",), [
        ("merge_join_count.cu", "    if (dl < D) {", "    if (false) {")]),
    **{f"k7_{name}": (("k7",), [
        ("merge_join_count.cu", K7_SHAPE.format("128, 15, 16, 2048, 0"),
         K7_SHAPE.format(shape))])
       for name, shape in (("tile_7", "128, 7, 8, 1024, 0"),
                           ("256_threads_7", "256, 7, 8, 2048, 0"),
                           ("tile_7_copy_ahead", "128, 7, 8, 2048, 1"),
                           ("group_4", "128, 15, 4, 2048, 0"),
                           ("group_8", "128, 15, 8, 2048, 0"),
                           ("group_32", "128, 15, 32, 2048, 0"))},
    "k7_part_search": (("k7",), [
        ("merge_join_count.cu",
         "  for (int d = 0; d < span; d += kTile) {",
         "  for (int d = kPlanes == 2 ? span : 0; d < span; d += kTile) {")]),
    "k7_part_no_walk": (("k7",), [
        ("merge_join_count.cu", "    if (dl < D) {",
         "    if (kPlanes == 1 && dl < D) {")]),
    "k5_network_only": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kRunMax = kPer;",
         "constexpr int kRunMax = 16384;")]),
    **{f"k5_runs_{n}": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kRunMax = kPer;",
         f"constexpr int kRunMax = {n};")]) for n in (32, 128, 512, 2048)},
    "k5_32_pairs": (("k5",), [
        ("block_sort_pairs.cu", "constexpr int kPer = 16;",
         "constexpr int kPer = 32;"),
        ("block_sort_pairs.cu", "constexpr int kMaxThreads = 1024;",
         "constexpr int kMaxThreads = 512;")]),
    "k5_part_no_network": (("k5",), [
        ("block_sort_pairs.cu",
         "  smj_bitonic::sort_regs<long long, kPer, kRun>(x, ptile);\n",
         "")]),
    "k5_part_no_merge": (("k5",), [
        ("block_sort_pairs.cu", "  merge_rounds<kRun, kBlock>(x, ptile);\n",
         "")]),
    "k4_part_search": (("k4",), [
        ("merge_pass.cu",
         "      if (threadIdx.x % kLanes == 0 && j <= kGroup) cor[j] = c;\n"
         "    }\n",
         "      if (threadIdx.x % kLanes == 0 && j <= kGroup) cor[j] = c;\n"
         "    }\n"
         "    if (threadIdx.x == 0) out_k[a0 + d_begin] = (int)cor[0];\n"
         "    return;\n")]),
    "k4_part_no_merge": (("k4",), [
        ("merge_path.cuh", "  for (int s = 1; s < W; s <<= 1) {\n"
         "    if (p0 < n) {", "  for (int s = W; s < W; s <<= 1) {\n"
         "    if (p0 < n) {")]),
    "k4_lanes_32": (("k4",), [
        ("merge_pass.cu", "constexpr int kLanes = 4;",
         "constexpr int kLanes = 32;")]),
    **{f"k4_keys_{name}": (("k4",), [
        ("merge_pass.cu", K4_KEYS.format("256, 4096, 5, 7, true"),
         K4_KEYS.format(shape))])
       for name, shape in (("tile_8192", "256, 8192, 3, 7, true"),
                           ("one_tile", "256, 4096, 5, 1, true"),
                           ("no_prefetch", "256, 4096, 5, 7, false"),
                           ("6_ctas", "256, 4096, 6, 7, false"))},
    **{f"k4_pairs_{name}": (("k4",), [
        ("merge_pass.cu", K4_PAIRS.format("256, 2048, 6, 2, false"),
         K4_PAIRS.format(shape))])
       for name, shape in (("prefetch", "256, 2048, 2, 2, true"),
                           ("one_tile", "256, 2048, 6, 1, false"),
                           ("7_tiles", "256, 2048, 6, 7, false"),
                           ("tile_4096", "256, 4096, 2, 2, true"))},
    "k4_streaming_stores": (("k4",), [
        ("merge_pass.cu", "    k[i] = smj_key(v);\n    p[i] = smj_payload(v);",
         "    __stcs(k + i, smj_key(v));\n    __stcs(p + i, smj_payload(v));"),
        ("merge_pass.cu", "    k[i] = v;", "    __stcs(k + i, v);")]),
    **{f"k8_part_{what}": (("k8",), [
        ("radix_hist.cu", "  if (lo < hi)\n    for_keys(",
         "  unsigned acc = 0;\n  if (lo < hi)\n    for_keys("),
        ("radix_hist.cu",
         "      if (packed) {\n"
         "        const unsigned sh = (pid & 1u) << 4;\n"
         "        const unsigned old = atomicAdd(counts + (pid >> 1), "
         "1u << sh);\n"
         "        if (((old >> sh) & kHalf) == kHalf)\n"
         "          on_wrap(counts + (pid >> 1), pid, old, fix);\n"
         "      } else {\n"
         "        atomicAdd(counts + pid, 1u);\n"
         "      }", f"      acc += {expr};"),
        ("radix_hist.cu", K8_ROW, "  if (acc == 0x9e3779b9u) counts[0] = "
         "acc;\n" + K8_ROW)])
       for what, expr in (("loads", "(unsigned)key"), ("ids", "pid"))},
    "k8_packed_14": (("k8",), [
        ("radix_hist.cu", "  return nbits > kLogWords ? 1 << (nbits - 1) : "
         "1 << nbits;", "  return nbits > 13 ? 1 << (nbits - 1) : "
         "1 << nbits;"),
        ("radix_hist.cu",
         "  const bool packed = fanout > (1 << kLogWords);",
         "  const bool packed = fanout > (1 << 13);")]),
    **{f"k8_vecs_{v}": (("k8",), [
        ("radix_hist.cu", "constexpr int kVecs = 2;",
         f"constexpr int kVecs = {v};")]) for v in (1, 4)},
    "k8_512_threads": (("k8",), [
        ("radix_hist.cu", "constexpr int kThreads = 1024;",
         "constexpr int kThreads = 512;")]),
}


def make_variant(name: str) -> str:
    """A copy of the package with the variant's changes; its root."""
    root = os.path.join(VARIANTS_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for src, old, new in VARIANTS[name][1]:
        path = os.path.join(root, PKG, "csrc", src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {src} no longer holds {old!r} once: "
                             "update this script")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def zipf_keys(n: int, dev) -> "torch.Tensor":
    """n Zipf (z = 1.0) keys over a seeded permutation of the smoke's
    alphabet of 2^20 values, drawn on the card by inverting the cumulative
    weights (the smoke's host genzipf takes about 36 s at 128M)."""
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(31)
    size = cs.ZIPF_ALPHABET
    weights = 1.0 / torch.arange(1, size + 1, dtype=torch.float64,
                                 device=dev)
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    letters = torch.randperm(size, generator=gen, device=dev).to(
        torch.int32) + 1
    draws = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    rank = torch.searchsorted(cdf, draws).clamp_(max=size - 1)
    return letters[rank]


def k9_device_ms(rf, land, lens, cap: int, chunk: int, arrive,
                 calls: int = 20) -> dict:
    """Milliseconds of device time a K9 call spends in each of its
    kernels (K2's co-rank passes and tile merge, K9's gate), from
    torch.profiler's CUDA activity over ``calls`` calls; the part
    timings above run at the wrapper's host rate when a part is short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rf.chunk_gated_merge(land, lens, cap, chunk, arrive)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"corank_kernel<[^>]*>|gate_kernel|merge_kernel<[^>]*>",
                      e.key)
        if m and e.device_time_total > 0:
            ms = e.device_time_total / calls / 1e3
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms
    return {k: round(v, 4) for k, v in out.items()} or "no device time"


def k11_device_ms(rf, mesh, bflat, rcounts, cap: int, chunk: int,
                  calls: int = 20) -> str:
    """Milliseconds of device time a K11 call spends in its kernel, from
    torch.profiler's CUDA activity over ``calls`` calls: the call's CUDA
    event time less this is the wrapper's share (its scratch, pointer
    table and status read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk)
        torch.cuda.synchronize()
    ms = sum(e.device_time_total for e in prof.key_averages()
             if "remote_pull_kernel" in e.key) / calls / 1e3
    return f"{ms:.4f}" if ms > 0 else "no device time"


def k2_shapes(cs, sort_ops, dev):
    """K2's and K6's inputs at the benchmark's shapes, one at a time:
    (label, keys, payloads or None, n) as block-sorted runs, or (label,
    landing, lens, stride) for the varlen merge, whose levels k2_parts
    takes from the default plan.  128M keys (workload B's sort: W = 32,
    16, 16), 128M (key, row id) pairs, the first (W = 32) level of the
    card16 cell's S (2,048,000,000 keys
    drawn from 1..128M, 16 a key on average), a 200M-key shard of
    workload A (W = 16, 16, 16, 4), and the varlen W = 8 merge of a
    shard's received runs (8 runs of 25M at the stride of slack 2,
    50,003,968), uniform and Zipf 1.0 (zipf_keys)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    n = cs.MAIN_N
    keys = torch.randint(1, n + 1, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    yield ("128M keys", sort_ops.sort_blocks(keys, n), None, n)
    pays = torch.arange(n, dtype=torch.int32, device=dev)
    yield ("128M pairs", *sort_ops.sort_blocks_pairs(keys, pays, n), n)
    del keys, pays
    big = CARD16_S
    keys = torch.randint(1, n + 1, (big,), generator=gen, dtype=torch.int32,
                         device=dev)
    runs = sort_ops.sort_blocks(keys, big)
    del keys
    yield ("2048M keys", runs, None, big)
    del runs
    shard = 200_000_000
    keys = torch.randint(1, 1_600_000_001, (shard,), generator=gen,
                         dtype=torch.int32, device=dev)
    yield ("200M shard", sort_ops.sort_blocks(keys, shard), None, shard)
    del keys
    stride, live = 50_003_968, 25_000_000
    for label in ("uniform", "zipf1"):
        land = torch.full((8 * stride,), 2**31 - 1, dtype=torch.int32,
                          device=dev)
        for r in range(8):
            run = (torch.randint(1, 1_600_000_001, (live,), generator=gen,
                                 dtype=torch.int32, device=dev)
                   if label == "uniform" else zipf_keys(live, dev))
            land[r * stride:r * stride + live] = torch.sort(run).values
        lens = torch.full((8,), live, dtype=torch.int32, device=dev)
        yield (f"varlen W=8 {label}", land, lens, stride)
        del land


def k2_parts(cs, mw, sort_ops, name: str) -> None:
    """K2/K6 timed in parts at k2_shapes' calls (CUDA events, 10 calls
    each): the coarse co-ranks (mask 1), the fine ones on the coarse rows
    (2), both (1 | 2) and the tile merge (4); each call's merged columns
    checked against the plain version, and its co-rank rows against
    ``corank_rows_plain`` where the package has it."""
    import torch

    dev = torch.device("cuda", 0)
    part = name.startswith("k2_part_")
    merge_part = name.startswith("k2_part_merge_")
    plain_rows = None if part else getattr(mw, "corank_rows_plain", None)
    for label, keys, extra, size in k2_shapes(cs, sort_ops, dev):
        if part and label not in (("128M keys", "2048M keys") if merge_part
                                  else ("128M keys",)):
            continue
        if label.startswith("varlen"):
            lens, stride, w = extra, size, extra.numel()
            got = mw.multiway_merge(keys, w, lens=lens, stride=stride)[0]
            if not torch.equal(got, mw.multiway_merge_varlen_plain(
                    keys, w, lens, stride)[0]):
                raise AssertionError(f"{name}: K2 {label}")
            del got
            k2_time(cs, mw, name, label, keys, None,
                    ("smj_multiway_merge_varlen", 1, stride, w,
                     lens.data_ptr(), lens.numel(), stride), plain_rows,
                    dict(lens=lens, stride=stride))
            continue
        runs, rp, n = keys, extra, size
        del keys, extra
        levels = mw.merge_levels(n, cs.BLOCK)
        for level in levels[:1] if n == CARD16_S else levels:
            _, span, nruns, w = level
            ul = (nruns, n, span)
            want = mw.multiway_merge_plain(runs, w, ul, rp)
            # a merge part's output is wrong wherever it leaves out a round
            # the level needs: every level without rounds, a level past the
            # first round's fan-in of 4 with one round
            wrong = merge_part and (name == "k2_part_merge_none" or w > 4)
            if not part or wrong:
                got = mw.multiway_merge(runs, w, ul, rp)[0]
                if all(torch.equal(g, x) for g, x in zip(
                        got if rp is not None else (got,),
                        want if rp is not None else (want,))) == wrong:
                    raise AssertionError(f"{name}: K2 {label} {level} "
                                         f"exact={not wrong}")
                del got
            # (the plain rows of 2.048e9 keys would not fit the card)
            k2_time(cs, mw, name, f"{label} W={w} span={span}", runs, rp,
                    ("smj_multiway_merge", sort_ops.cdiv(nruns, w), span, w,
                     n, span), None if n == CARD16_S else plain_rows,
                    dict(uniform_lens=ul))
            runs, rp = want if rp is not None else (want, None)
        del runs, rp


def k2_fanins(cs, mw, sort_ops, name: str) -> None:
    """One K2 and one K6 level at fan-in W = 2, 4, 8, 16, 32 over 128M
    block-sorted keys and (key, row id) pairs (runs of 16,384), in parts
    (k2_time) and whole (mask 7: coarse and fine co-ranks, then the tile
    merge), each level's columns checked against the plain version."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    n = cs.MAIN_N
    keys = torch.randint(1, n + 1, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    pays = torch.arange(n, dtype=torch.int32, device=dev)
    nruns = sort_ops.cdiv(n, cs.BLOCK)
    for label, runs, rp in (
            ("128M keys", sort_ops.sort_blocks(keys, n), None),
            ("128M pairs", *sort_ops.sort_blocks_pairs(keys, pays, n))):
        for w in (2, 4, 8, 16, 32):
            ul = (nruns, n, cs.BLOCK)
            got = mw.multiway_merge(runs, w, ul, rp)[0]
            want = mw.multiway_merge_plain(runs, w, ul, rp)
            if not all(torch.equal(g, x) for g, x in zip(
                    got if rp is not None else (got,),
                    want if rp is not None else (want,))):
                raise AssertionError(f"{name}: {label} level W={w}")
            del got, want
            call = ("smj_multiway_merge", sort_ops.cdiv(nruns, w), cs.BLOCK,
                    w, n, cs.BLOCK)
            k2_time(cs, mw, name, f"{label} level W={w} span={cs.BLOCK}",
                    runs, rp, call, None, dict(uniform_lens=ul))
            whole = cs.time_ms(lambda: mw.multiway_merge(runs, w, ul, rp), 10)
            print(f"[{name}] K2 {label} level W={w}: whole {whole:.4f} ms",
                  flush=True)
        del runs, rp
    del keys, pays


def k2_plans(cs, mw, sort_ops, name: str) -> None:
    """Whole K2 merges (every level of a sort after its block sort) in
    each candidate plan, at 128M keys (workload B's sort), a 200M-key
    shard (workload A's local sort) and 2,048M keys (the card16 cell's
    S), and whole K6 merges of 128M (key, row id) pairs (the
    materializing join's S): greedy at fan-in 16 (the JAX package's
    schedule) and the default plan (``merge_levels`` with no fan-in),
    timed once where the two are one plan.  CUDA events, 5 calls a plan;
    the default plan's columns equal to greedy 16's, whose keys are
    ascending with the input's sum."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    for label, n, hi, pairs in (
            ("128M keys", cs.MAIN_N, cs.MAIN_N, False),
            ("200M shard", 200_000_000, 1_600_000_000, False),
            ("2048M keys", CARD16_S, cs.MAIN_N, False),
            ("128M pairs", cs.MAIN_N, cs.MAIN_N, True)):
        keys = torch.randint(1, hi + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        total = int(keys.sum(dtype=torch.int64))
        if pairs:
            runs, rp = sort_ops.sort_blocks_pairs(
                keys, torch.arange(n, dtype=torch.int32, device=dev), n)
        else:
            runs, rp = sort_ops.sort_blocks(keys, n), None
        del keys
        nruns = sort_ops.cdiv(n, cs.BLOCK)
        plans = {}
        for fanin in (16, mw.FANIN_DEFAULT):
            levels = mw.merge_levels(n, cs.BLOCK, fanin)
            plans.setdefault(tuple(w for *_, w in levels), levels)
        ref = None
        for fanins, levels in plans.items():
            def merge(levels=levels):
                ks, ps = runs, rp
                for level in levels:
                    out = mw.merge_level(ks, n, level, ps)
                    ks, ps = out if pairs else (out, None)
                return (ks, ps) if pairs else (ks,)

            out = merge()
            if ref is None:
                live = out[0][:n]
                if not (bool((live[1:] >= live[:-1]).all()) and
                        int(live.sum(dtype=torch.int64)) == total):
                    raise AssertionError(f"{name}: {label} {fanins} unsorted")
                ref = out
            elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"{name}: {label} {fanins} != "
                                     f"{next(iter(plans))}")
            del out
            ms = cs.time_ms(merge, 5)
            rounds = sum(w.bit_length() - 1 for w in fanins)
            print(f"[{name}] K2 plan {label} ({nruns} runs) fan-ins "
                  f"{list(fanins)}: {len(fanins)} levels, {rounds} rounds, "
                  f"{ms:.4f} ms", flush=True)
        del runs, rp, ref


def k2_time(cs, mw, name: str, label: str, runs, pays, call, plain_rows,
            layout: dict) -> None:
    import torch

    entry, ngroups, stride, w, *args = call
    scratch = mw.corank_scratch(runs, ngroups, stride, w)

    def part(mask):
        return mw._launch(entry, runs, pays, ngroups, stride, w, *args,
                          parts=mask, scratch=scratch)

    # a co-rank part's rows are wrong: no tile merge on them; a merge part
    # times the tile merge on the committed co-ranks
    masks = ((3, 4) if name.startswith("k2_part_merge_") else (1, 2)
             if name.startswith("k2_part_") else (1, 2, 3, 4))
    ms = {m: cs.time_ms(lambda m=m: part(m), 10) for m in masks}
    rows = ""
    if plain_rows is not None:
        part(3)
        want = plain_rows(runs, w, payloads=pays, **layout)
        got = scratch[:want.numel()].view(want.shape)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: K2 {label}: rows != plain")
        rows = ", rows = plain"
    more = (f", co-rank {ms[3]:.4f}, merge {ms[4]:.4f}" if 4 in ms
            else "")
    first = (f"coarse {ms[1]:.4f} ms, fine {ms[2]:.4f}" if 1 in ms
             else "ms")
    print(f"[{name}] K2 {label}{' pairs' if pays is not None else ''}: "
          f"{first}{more}{rows}", flush=True)


def worker(name: str, kernels: list[str]) -> None:
    """Measure one variant; its package comes first on sys.path."""
    sys.path.append(ROOT)  # chip_smoke's helpers, after the variant
    import torch

    import chip_smoke as cs
    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import partition as pt
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    if not _build.__file__.startswith(os.path.join(VARIANTS_DIR, name)):
        raise SystemExit(f"{name}: imported {_build.__file__}")
    usage = cs.res_usage()
    kinds = {"block_sort_kernelILi16384E": "K1",
             "merge_join_count_kernel": "K3",
             "merge_join_count2_kernel": "K10",
             "merge_join_count64_kernel": "K7",
             "gate_kernel": "K9 gate",
             "merge_pass_kernel": "K4",
             "block_sort_pairs_kernelILi16384E": "K5",
             "radix_hist_kernel": "K8",
             "remote_pull_kernel": "K11",
             "corank_kernelIiLi4096EEEvNS_11SampledPass": "K2 sampled co-rank",
             "corank_kernelIxLi4096EEEvNS_11SampledPass": "K6 sampled co-rank",
             "corank_kernelIiLb1ELi4096E": "K2 co-rank search",
             "merge_kernelIiLi4096E": "K2 tile merge",
             "merge_kernelIxLi4096E": "K6 tile merge"}
    for fn, line in re.findall(r"Function ([^\s:]+):?\n([^\n]*)", usage):
        for pattern, kernel in kinds.items():
            if pattern in fn:
                res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
                print(f"[{name}] {kernel}: REG {res.get('REG')}, STACK "
                      f"{res.get('STACK')}, LOCAL {res.get('LOCAL')}, "
                      f"SHARED {res.get('SHARED')}", flush=True)
    dev = torch.device("cuda", 0)
    what = [k for k in VARIANTS[name][0] if k in kernels]
    if "k1" in what:
        gen = torch.Generator(device=dev).manual_seed(7)
        n = cs.MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        if not torch.equal(sort_ops.sort_blocks(keys, n),
                           sort_ops.sort_blocks_plain(keys, n)):
            raise AssertionError(f"{name}: K1 != plain")
        ms = cs.time_ms(lambda: sort_ops.sort_blocks(keys, n), 10)
        print(f"[{name}] K1 {n} keys: {ms:.3f} ms", flush=True)
        del keys
    if "k3" in what:
        gen = torch.Generator(device=dev).manual_seed(7)
        n = cs.MAIN_N
        rk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        for ns in (n, n // 4):
            sk = torch.sort(torch.randint(1, n + 1, (ns,), generator=gen,
                                          dtype=torch.int32,
                                          device=dev)).values
            exact = int(mergejoin.merge_join_count_fused(rk, sk, n, ns)) \
                == int(mergejoin.merge_join_count_fused_plain(rk, sk, n, ns))
            if exact == name.startswith("k3_part_"):
                raise AssertionError(f"{name}: K3 exact={exact}")
            ms = cs.time_ms(lambda: mergejoin.merge_join_count_fused(
                rk, sk, n, ns), 10)
            print(f"[{name}] K3 {n} x {ns}: {ms:.3f} ms", flush=True)
            del sk
        del rk
    if "k7" in what:
        from avx_sort_merge_joins_tpu_torch.ops import join64

        gen = torch.Generator(device=dev).manual_seed(37)
        rhi, rlo, r64 = cs.wide_planes(cs.CHECK_N, gen, dev)
        shi, slo, s64 = cs.wide_planes(cs.CHECK_N, gen, dev)
        exact = int(mergejoin.merge_join_count_fused64(
            rhi, rlo, shi, slo, cs.CHECK_N, cs.CHECK_N)) == int(
            join64.merge_join_count_torch64(r64, s64))
        del rhi, rlo, r64, shi, slo, s64
        n = cs.MAIN_N
        rk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        sk = torch.sort(torch.randint(1, n + 1, (n,), generator=gen,
                                      dtype=torch.int32, device=dev)).values
        rhi, rlo = join64.widen32(rk)
        shi, slo = join64.widen32(sk)
        exact = exact and int(mergejoin.merge_join_count_fused64(
            rhi, rlo, shi, slo, n, n)) == n
        if exact == name.startswith("k7_part_"):
            raise AssertionError(f"{name}: K7 exact={exact}")
        ms = cs.time_ms(lambda: mergejoin.merge_join_count_fused64(
            rhi, rlo, shi, slo, n, n), 10)
        k3 = cs.time_ms(lambda: mergejoin.merge_join_count_fused(
            rk, sk, n, n), 10)
        print(f"[{name}] K7 {n} x {n}: {ms:.3f} ms; K3 on the same int32 "
              f"keys {k3:.3f} ms", flush=True)
        del rk, sk, rhi, rlo, shi, slo
    if "k4" in what:
        gen = torch.Generator(device=dev).manual_seed(11)
        n = cs.MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        pays = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        first = sort_ops.sort_blocks_plain(keys, n, cs.BLOCK)
        last_span = 1 << 26
        cases = [
            (f"keys span={cs.BLOCK}", first, None, cs.BLOCK),
            (f"keys span={last_span}",
             sort_ops.sorted_groups(keys, n, last_span), None, last_span),
            (f"pairs span={cs.BLOCK}",
             *sort_ops.sort_blocks_pairs_plain(keys, pays, n, cs.BLOCK),
             cs.BLOCK)]
        del keys, pays, first
        for case, rk, rp, span in cases:
            lens = (sort_ops.cdiv(n, span), n, span)
            got = sort_ops.merge_pass(rk, rp, lens)
            want = sort_ops.merge_pass_plain(rk, rp, lens)
            exact = all(g is None or torch.equal(g, w)
                        for g, w in zip(got, want))
            if exact == name.startswith("k4_part_"):
                raise AssertionError(f"{name}: K4 {case} exact={exact}")
            del got, want
            ms = cs.time_ms(lambda: sort_ops.merge_pass(rk, rp, lens), 10)
            print(f"[{name}] K4 {n} {case}: {ms:.3f} ms", flush=True)
        del cases
    if "k8" in what:
        gen = torch.Generator(device=dev).manual_seed(29)
        n = cs.MAIN_N
        uniform = torch.randint(1, 2**26, (n,), generator=gen,
                                dtype=torch.int32, device=dev)
        for dist, k in (("uniform", uniform), ("zipf", zipf_keys(n, dev))):
            for bits in cs.HIST_BITS:
                want = pt.radix_hist_plain(k, bits)
                exact = torch.equal(pt.radix_hist(k, bits), want) and \
                    torch.equal(pt.radix_hist_any(k, bits),
                                want.sum(0, dtype=torch.int32))
                if exact == name.startswith("k8_part_"):
                    raise AssertionError(f"{name}: K8 {dist} bits={bits} "
                                         f"exact={exact}")
                del want
                glob = cs.time_ms(lambda: pt.radix_hist_any(k, bits), 10)
                tile = cs.time_ms(lambda: pt.radix_hist(k, bits), 10)
                print(f"[{name}] K8 {n} {dist} bits={bits}: global "
                      f"{glob:.3f} ms, per tile {tile:.3f} ms", flush=True)
        del uniform
    if "k5" in what:
        gen = torch.Generator(device=dev).manual_seed(11)
        n = cs.MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        pays = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        for desc in (False, True):
            got = sort_ops.sort_blocks_pairs(keys, pays, n, descending=desc)
            want = sort_ops.sort_blocks_pairs_plain(keys, pays, n,
                                                    descending=desc)
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            if exact == name.startswith("k5_part_"):
                raise AssertionError(f"{name}: K5 exact={exact}")
            del got, want
            ms = cs.time_ms(lambda: sort_ops.sort_blocks_pairs(
                keys, pays, n, descending=desc), 10)
            print(f"[{name}] K5 {n} pairs descending={desc}: {ms:.3f} ms",
                  flush=True)
        del keys, pays
    if "k2" in what:
        k2_parts(cs, mw, sort_ops, name)
        if not name.startswith("k2_part_"):
            k2_fanins(cs, mw, sort_ops, name)
            k2_plans(cs, mw, sort_ops, name)
    if "k9" in what:
        landings, cap, _, buckets = cs.dist_landings(dev)
        del buckets
        land, lens = landings[0]
        del landings
        w = cs.DIST_SHARDS
        chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, w)
        arrive = rf.arrival_schedule(w, cap // chunk, 1)
        got = rf.chunk_gated_merge(land, lens, cap, chunk, arrive)
        want = rf.chunk_gated_merge_plain(land, lens, cap, chunk, arrive)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: K9 != plain")
        del got, want
        parts = cs.gated_parts_ms(land, lens, cap, chunk, arrive, 20)
        print(f"[{name}] K9 R landing of shard 0, {w} strips of {cap}, "
              f"push schedule: {parts['all']:.3f} ms; co-ranks "
              f"{parts['corank']:.3f}, gate {parts['gate']:.3f}, merge "
              f"{parts['merge']:.3f}", flush=True)
        print(f"[{name}] K9 device time a call by kernel (torch.profiler): "
              f"{k9_device_ms(rf, land, lens, cap, chunk, arrive)}",
              flush=True)
        del land, lens
    if "k10" in what:
        gen = torch.Generator(device=dev).manual_seed(23)
        n, span = cs.MAIN_N, cs.COUNT2_SPAN
        rk = cs.two_run_column(torch.randperm(n, generator=gen, device=dev)
                               .to(torch.int32) + 1, span)
        sk = cs.two_run_column(torch.randint(1, n + 1, (n,), generator=gen,
                                             dtype=torch.int32, device=dev),
                               span)
        got = int(mergejoin.merge_join_count_fused2(rk, sk, n, n, span,
                                                    span))
        if got != n:
            raise AssertionError(f"{name}: K10 {got} != {n}")
        ms = cs.time_ms(lambda: mergejoin.merge_join_count_fused2(
            rk, sk, n, n, span, span), 10)
        pairs = [(r, s) for r in mergejoin._two_runs(rk, n, span)
                 for s in mergejoin._two_runs(sk, n, span)]
        four = cs.time_ms(lambda: [mergejoin.merge_join_count_fused(
            r, s, r.numel(), s.numel()) for r, s in pairs], 10)
        print(f"[{name}] K10 {n} x {n}, two runs a side: {ms:.3f} ms; four "
              f"K3 launches over the same pairs {four:.3f} ms", flush=True)
        del rk, sk, pairs
    if "k11" in what:
        _, cap, _, buckets = cs.dist_landings(dev)
        w = cs.DIST_SHARDS
        mesh = make_mesh(w, dev)
        chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, w)
        bflat, rcounts = buckets[0]
        del buckets
        full = rf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk)
        want = rf.remote_pull_exchange_merge_plain(mesh, bflat, rcounts, cap,
                                                   chunk)
        if not all(torch.equal(a, b) for a, b in zip(full, want)):
            raise AssertionError(f"{name}: K11 != plain")
        k = rf._checked_pull(mesh, bflat, rcounts, cap, chunk, None)
        ms = cs.time_ms(lambda: rf.remote_pull_exchange_merge(
            mesh, bflat, rcounts, cap, chunk), 10)
        merge = cs.time_ms(lambda: rf._pull_launch(
            mesh, bflat, rcounts, cap, chunk, k, landing=full[3]), 10)
        print(f"[{name}] K11 R over {w} shards: {ms:.3f} ms, the merge "
              f"alone {merge:.3f} ms; the kernel's device time a call "
              f"(torch.profiler) "
              f"{k11_device_ms(rf, mesh, bflat, rcounts, cap, chunk)} ms",
              flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3:])
        return 0
    named = [a for a in sys.argv[1:] if a in VARIANTS]
    unknown = [a for a in sys.argv[1:] if a not in VARIANTS
               and not re.fullmatch(r"k\d+", a)]
    if unknown:
        raise SystemExit(f"unknown variants or kernels: {unknown}")
    kernels = [k for k in sys.argv[1:] if k not in named]
    kernels = kernels or sorted({k for n in named for k in VARIANTS[n][0]}) \
        or ["k1", "k2", "k3", "k4", "k5", "k7", "k8", "k9", "k10", "k11"]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    order = [name for name, (what, _) in VARIANTS.items()
             if name == "final" or (name in named if named else
                                     set(what) & set(kernels))]
    roots = {name: make_variant(name) for name in order}
    failed = []
    for name in order + order[::-1]:
        env = dict(os.environ, PYTHONPATH=roots[name])
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", name, *kernels], env=env,
                            cwd=ROOT).returncode
        if rc != 0:
            print(f"[{name}] failed: exit {rc}", flush=True)
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
