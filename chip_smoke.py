"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no result:

1. Device: require a CUDA card; print its name and power limit.
2. Build: compile the kernels in avx_sort_merge_joins_tpu_torch/csrc with
   nvcc (one process per source, side by side) and print the build time.
3. Kernel vs plain, keys only: K1 (block sort, at every supported block
   size), K2 (multiway merge, fan-in 2 and 16) and K3 (match count) on
   seeded inputs of about 2^22 keys -- ragged last block, heavy
   duplicates, negative keys, the ends of the key domain, a count above
   2^31 -- must equal their plain PyTorch versions exactly (integers:
   tolerance 0); K1 also at the edges of its network (sorted, reversed,
   all-equal, 16-value and domain-end keys at n = block - 1, block, block
   + 1 and 0); K3 also at the edges of its merge-path tiles (a hot key
   only in S over 100 tiles, non-unique R and S, nR + nS at a tile's and
   a CTA's size - 1, + 0 and + 1, nR >> nS, nS >> nR, a side of length
   1, keys at +-(2^31 - 2)).  Then each kernel, its plain version
   and its one-call library yardstick are timed with CUDA events at the
   main path's shapes (128M keys; K2 at the default plan's levels, fan-in
   32, 16, 16); each K2 level also in its parts: the
   co-rank passes (the coarse one and the sampled fine one alone) and the
   tile merge, and its co-rank rows held to ``corank_rows_plain`` bit for
   bit, with no sampled bracket falling back to the search (so each K6
   level at 128M pairs).
4. Kernel vs plain, pairs and merge passes, exact: K5 (pair block sort)
   in both directions at every block size, and at its network's edges
   (sorted and reversed keys, equal keys with distinct payloads, equal
   pairs, keys and payloads at their domains' ends, at n = block - 1,
   block, block + 1 and 0); K4 (merge pass) keys
   only over two successive passes (257 -> 129 -> 65 runs: odd counts, a
   ragged last run), and in pair mode in both directions with duplicate
   keys and payloads and payloads equal to the pads.  Then all 13 K4
   passes over one 128M relation and one K5 launch over 128M pairs, timed
   beside their plain versions and library yardsticks.  (K4 at its tiles'
   and CTAs' edges runs after phase 8's K2/K6 edges: run A of 1, T - 1, T,
   T + 1, C - 1, C, C + 1 against an empty B, a B of 1, of T or as long
   as A, T = K4_TILE and C = K4_CTA, and an empty pass; keys over the
   domain or at its ends; a hot key over many tiles and CTAs; both
   directions, keys and pairs; and the varlen mode with random, empty,
   full and padding runs at strides 1, T + 1, 100,003 and 4,014,080.)
5. Kernel vs plain, exact, at the other shapes the paths of phases 6-7
   give the kernels: one 32M mpsm S chunk of the CLI's 4 and one 2M
   chunk of the benchmark's 64 (K1; K2 at each of its levels, fan-in 16,
   16, 8 and 16, 8; K3 of 128M R against it, also timed), and the 16M
   pair inputs of phase 7 (K5 and every K4 pair-mode pass of ``sort``
   and ``sort_descending``, and the tag-merge count's two-run K4 merges).
6. Join paths, each through the CLI with the launch counts set to 0 just
   before it and read just after: ``-a m-way``, ``-a m-pass`` and ``-a
   mpsm --nchunks 4`` at -r 128000000 -s 128000000 (unique R,
   foreign-key S, data made on the card) must print ``Results =
   128000000`` and launch their kernels (m-way: K1 K2 K3; m-pass: K1 K4
   K3; mpsm: K1 K2 K3).  Phase 9's two paths run here too.
7. Pair sort and tag-merge count: ``sort``/``sort_descending`` of 16M
   seeded pairs must equal ``sort_torch`` and its reverse (K5 and K4
   launching); the tag-merge count of 16M x 16M duplicate-heavy keys
   (K4 in pair mode) must equal K3's count and the torch.sort baseline.
8. Kernel vs plain, pair merges and 64-bit counts, exact: K6 (pair
   multiway merge) at fan-in 2, 4 and 16 over two levels with ragged
   totals, identical pairs in several runs and pad-valued payloads, then
   at every level of a 128M-pair sort's default plan (fan-in 32, 16, 16;
   timed, also in its parts, as K2's) and of a 32M-pair one (16, 16, 8);
   K7 (64-bit
   match count) on keys whose hi plane varies (also with each of the four
   planes a view at a 4-byte offset: the 4-byte copy path), on equal hi
   planes with different lo planes, on one hot key whose product passes
   2^31, on one hot key over many CTAs, and on 128M x 128M sorted planes
   (timed).  Then K2 and K6 where the merge-path tiles have their edges:
   group totals of MERGE_TILE - 1, MERGE_TILE, MERGE_TILE + 1 and 3
   MERGE_TILE + 7 at fan-in 2, 4, 8, 16, uniform and varlen, keys over the
   whole domain or at +-(2^31 - 2) with payloads INT32_MAX and INT32_MIN;
   one hot key
   in every run over many tiles (keys, identical pairs, pairs that differ
   only in payload, alone and between other keys); the varlen K6 at
   dist_materialize's landing (8 strips of 4,014,080 slots, ragged and
   empty) and at fan-in 2, 4, 16 with an odd stride.
9. The materializing and KEY_8B paths: ``-a m-way --materialize`` and
   ``--key8b`` through the CLI at -r 128000000 -s 128000000 must print
   ``Results = 128000000`` and launch K1 K2 K5 K6, and K5 K6 K7; the same
   materializing join through ``sortmergejoin_multiway`` in the process
   must give the plain route's relation row for row (``sort_torch`` of S:
   R is the primary key, so every S tuple matches once); ``--materialize
   --persist`` at 1M x 1M must write R.tbl, S.tbl and an Out.tbl that
   reads back as the output relation; ``--key8b --scalarsort`` at 16M must
   print the kernel route's count.
10. Non-unique relations at 16M x 16M (generated once on the host): the
   count join must equal the torch.sort baseline, and the materializing
   join must give as many rows as that count and the same expanded rows
   as the plain route (duplicate R keys: one row per match pair).
11. Kernel vs plain, histograms, exact: K8 per tile and global at every
   fanout 2^1..2^16 and shifts up to 31 - bits over keys at both ends of
   the domain with a ragged last tile, on a tile of 65,536 equal keys, at
   2^16 on 64M keys on the two bins of one packed word, on one low and on
   one high bin (16-bit halves wrap in every CTA), and at 128M keys for
   bits 7, 14 and 16, uniform and Zipf (z = 1.0, made on the host); the
   128M calls timed beside the plain version and ``torch.bincount``.
12. Kernel vs plain, two-run count, exact: K10 at the 128M route's shapes
   (runs of 67,108,864 and 60,891,136 keys a side; timed, beside four K3
   launches over the same four run pairs and K3 on the same keys merged),
   with R's or S's run 1 empty, with S cut at 64,000,000 (span_r !=
   span_s), on runs of one key each (2^43 matches), on keys at +-(2^31 -
   2) and on a hot key past 2^31.
13. The two-run route: ``_mway_count_device`` at 128M x 128M under
   SMJ_COUNT2=1 must count 128,000,000 with K1 2, K2 6, K10 1 and K3 0
   launches, and under SMJ_COUNT2=0 with K3 1 and K10 0; both timed.
14. The partitioning grid: ``partitioningbench`` at 8,388,608 tuples for
   bits 2, 4, ..., 16 with every variant, and ``hist`` at 128M for bits 7
   and 14; each row's histogram equals ``radix_hist_torch`` and each
   partition ``radix_cluster_numpy`` on its live slices.
15. The other micro-benchmarks once each at their JAX defaults (sortbench
   multiway, keysonly, pairwise; mergebench fifo2, pairwise;
   multiwaymergebench; tputbench tput and mpsm), each passing its own
   check.
16. ``-z 1.0`` at 16M x 16M: ``-a m-way`` through the CLI, and the m-way
   and mpsm joins of the CLI's relations, must equal the torch.sort
   baseline.
17. Kernel vs plain, the distributed m-way join's shapes, exact: shard 0's
   received runs of the 128M x 128M join over 8 shards (8 strips of
   4,014,080 slots, 81,920-key chunks) through K9 under four arrival
   schedules (all at once, the push schedule at rates 1 and 3, a late
   strip and a slow one), waiting ceil(len / 81,920) chunks a strip with
   no violation, and through the varlen K2; K3 of the two merged columns;
   K9 at W = 2, 4, 16 with an empty strip and one chunk a strip; the
   K9 at W = 32, 64 and 1,024 (strips of 8,192, chunks of 1,024, a
   landing 12,293 slots longer than the strips) under the four schedules,
   ragged and with every slot one key, and shard 0's landing of R with
   every slot one key (ties decide every co-rank); the varlen K2 at
   fan-in 2, 4, 16 with ragged and empty runs; K1 and K2 at one shard's
   16M shapes.  K9 timed beside its plain version and torch.sort of the
   landing column, and in its parts (co-ranks, gate, tile merge), and the
   ungated varlen K2 on it; K3 of the two merged columns timed.
18. The distributed m-way paths, each with the launch counts set to 0 just
   before it and read just after: ``-a m-way -n 8`` at 128M x 128M and
   with ``-S RING``, ``-S RANDOM`` and ``-z 1.0`` at 16M x 16M through the
   CLI (``Results = |S|``, K1 K2 K3, three phase times);
   ``dist_mway_join_count(..., remote_pull="emulate")`` at 128M x 128M
   with pull rates 1 and 3 (count 128,000,000, K9 launched 16 times a
   run, no violation); a 2 x 4 ``make_mesh2d`` run and ``overlap=True`` at
   16M; ``dist_join_count`` at 16M against the torch.sort baseline.
19. K11's SASS (cuobjdump of the built library): no load of the
   non-coherent read-only path (LDG.E...CONSTANT), and L1 invalidations
   after its acquire loads: the landing it reads is written in the launch.
   Its registers (cuobjdump -res-usage): at most 40, the six CTAs an SM
   its launch bounds ask for; its CTAs an SM at 2 to 256 shards, printed.
   The registers, stack and static shared memory of K2's and K6's co-rank
   and tile-merge kernels, printed (the sampled fine co-rank with local
   memory or stack fails the run); K1's and K5's registers, local
   memory, stack and CTAs an SM at each block size: a K1 or K5 with local
   memory or stack (their keys and pairs live in registers) fails the
   run.  The same for K4's six kernels and K8's (registers, local memory,
   stack; a K4 or K8 with local memory or stack fails the run), and their
   CTAs an SM: K4 keys and pairs, K8 at every fanout; and for K3's, K7's
   and K10's kernels (one CTA body; K7's static shared memory printed)
   and K9's gate (its co-ranks and merge are K2's kernels): local memory
   or stack fails the run.
20. Kernel vs plain, exact: K11 (push and chunk-gated merge of every
   shard in one launch) at n = 2, 4, 8, 16 shards with strips of 131,072
   slots, chunk = a strip and 16K, 32K, 64K keys, uniform keys, empty
   buckets and shards, a hot key over every strip and the domain's ends,
   at send windows 1, 4, 8, 32 and every push in flight: landing (the
   all-to-all), merged columns, waits ceil(count / chunk), flags 0; then
   strips of 4,095, 4,096, 4,097 and 12,295 keys (the merge tile's edges;
   each alone and mixed), a hot key over many tiles and every strip (alone,
   and between other keys), 32 and 64 shards, at windows 1, 8 and every
   push in flight; then the buckets of R and S
   of the 128M x 128M join over 8 shards (8 x 8 strips of 4,014,080 slots,
   81,920-key chunks); an undersized strip raises.  K11 timed beside its
   plain version, torch.sort of the landing and the bulk composite
   (all-to-all, then K9 a shard), and in parts: a launch with every flag
   set and no push times the merge alone; the one-card copy/merge overlap
   printed.  Then the varlen K4 at that join's landing of R (8 x 8 strips
   of 4,014,080 slots, 128M live keys; the first pass dist_mpass would give
   it), exact, timed beside a uniform pass over 128M keys in runs of 2^21.
21. ``dist_mway_join_count(..., remote_pull="dma")`` over 8 shards, with
   the launch counts set to 0 just before each run and read just after:
   at 128M x 128M (count 128,000,000, K11 launched twice, K9 never, waits
   ceil(len / 81,920), no flag); at 16M with ``-z 1.0`` against the
   torch.sort baseline; at 16M with SMJ_REMOTE_WINDOW 4, 8, 32 and every
   push in flight.  Then the mesh of cards: ``torch.cuda.device_count()``
   and ``can_device_access_peer`` of every pair; the 128M x 128M join
   over 8 shards through the device-a-shard layout (``make_mesh(8,
   devices=[cuda:0] * 8)``) on the bulk, ``-S RING``, emulate (K9) and
   dma (K11, one launch a card) routes, each exact, equal to the
   one-device mesh's count and timed beside it, with the launch counts
   set to 0 just before each run and read just after; K11's per-card
   launch on that join's buckets against its plain version and the
   one-device launch, exact, timed beside it; ``-n 8 --mapping-file`` on
   a file of eight 0s through the CLI (``Results = 128000000``); on a
   machine with two or more cards the join and the K11 check again with
   shard me on cuda:(me mod count) (or, for a pair without peer access,
   dma's refusal), and on one card a line that says they did not run.
22. The distributed m-pass, mpsm and materializing joins over 8 shards,
   each with the launch counts set to 0 just before it and read just
   after: ``-n 8 -a m-pass``, ``-n 8 -a mpsm`` and ``-n 8 --materialize``
   at 128M x 128M through the CLI (``Results = |S|``; launches exactly
   m-pass K1 16, K2 48, K4 48, K3 8; mpsm K1 16, K2 48, K3 512, its S ring
   timed; materialize K1 8, K2 32, K5 8, K6 32); at 16M
   ``dist_mpass_join_count`` with ``overlap=True`` (K4 96) and on a 2 x 4
   mesh, ``dist_join_materialize`` on the 2 x 4 mesh (rows equal S's), and
   ``-n 8 -a mpsm -z 1.0`` through the CLI; ``dist_join_materialize`` at
   128M x 128M, its rows equal to the one-device materializing join's as a
   multiset (``torch.sort`` of the packed pairs on the card); and ``-n 8
   --materialize --persist`` at 1M, its streamed Out.tbl equal to the
   one-device join of the same relations as a multiset.  Then each
   8-shard join (m-way too) at 128M once more under torch.profiler: its
   device time by kernel, the device's busy share of the run's span.
23. The CLI's other outputs and benches: phase 6's ``-a m-way``, ``-a
   m-pass`` and ``-a mpsm`` runs print ``[ROOFLINE]`` rows against the
   card's measured copy rate, each share at most 100%; ``scalebench`` at
   134,217,728 keys on 1, 2, 4, 8 shards and a 2 x 4 mesh, and with
   ``--algo m-pass`` and ``--algo mpsm`` at 16M (every count checked
   against numpy); ``tputbench --mode numa`` at 2^25 keys a shard (the
   aggregate checked against numpy); ``-a m-way -r 16000000 -s 16000000
   -o DIR``: the trace names K1's, K2's and K3's kernels, and the card's
   busy share of the join's span is printed.
24. Kernel vs plain, exact, at the 1.6B scale tier's shapes: K1 and each
   uniform K2 level of shard 0 of R and S (200,000,000 keys each, made by
   ``parallel/scale.py``), the varlen K2 over shard 0's received landings
   of the real exchange (8 runs of stride 50,003,968) and K3 of the two
   merged landings.
25. Workload A through the CLI: ``-a m-way -n 8 -r 1600000000 -s
   1600000000`` after ``empty_cache`` and a reset of the peak memory
   statistics, phased (``SMJ_SCALE_PHASED=1``), fused (``=0``) and with
   ``-z 1.0`` (slack 4): ``Results = 1600000000``, overflow 0, the scale
   tier's line, the ``[RECORD]`` row (phased: sort, merge1 and mergejoin
   columns), launches exactly K1 16, K2 80, K3 8 (derived from the
   schedules); the peak memory, the generation time (and the host's Zipf
   table) and the slack printed.
26. The driver's entry points (``graft_entry.py``): ``entry()``'s forward
   on the card counts 65,536 with K1 2, K2 2, K3 1 launches;
   ``dryrun_multichip(n)`` for n = 2, 4, 8, every leg exact, each leg's
   launches printed and its kernels launched (``LEG_KERNELS``: a leg on
   a plain route fails).
27. The ``-m`` merge tiles: the keys-only K2 at tiles of 2,048 and 8,192
   outputs against its plain version, exact, at group totals T - 1, T,
   T + 1, 3T + 7 for fan-in 2, 4, 8, 16, uniform and varlen, at the
   domain's ends and on a hot key over many tiles; fan-in 2,048 at every
   tile; the K2 levels of a 128M sort's default plan (32, 16, 16) timed
   at each tile; then ``-a
   m-way -m BYTES`` through the CLI at 128M for a budget naming each tile
   (``Results = 128000000``, every K2 launch at that tile, the join's
   time printed).
28. The results grid (``scripts/run_results_grid.py`` of the port) at its
   full sizes into a temporary ``SMJ_GRID_OUT``: 25 rows, every one
   exact, each printed, the 838,860,800-key ``scale`` row's peak device
   memory printed; then rendered by ``scripts/make_results_md.py``.
29. The twins of the experiment scripts with small knobs, side by side
   (``sort-bench.sh`` SIZES="1 64", ``multiwaymerge-bench.sh`` FANINS="4
   2048", ``partitioning-bench.sh`` BITS="2 16", ``cardinality.sh``
   NR=16000000 REPS=1, ``scalesize.sh`` SIZES="1", ``tput-scalability.sh``
   NR=16000000 CHIPS="1 8" REPS=1), then ``workload-a.sh`` at full size:
   every exit code 0, every output line there and exact.

Each phase's wall time is printed as a ``[phase]`` line.  The line before
the last is one JSON object with each kernel's launches
over the runs of phases 6, 7, 9, 13-15, 18, 21-23, 25-26 and 27-28, its
largest error in phases 3-5, 8, 11-12, 17, 20-21, 24 and 27, its times, its
bound and its library yardstick's time; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# The smoke uses one card.  Pin the process to the first visible one, so
# that torch.cuda.device_count() in the result line counts the cards used.
_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
if _visible is None or "," in _visible:
    os.environ["CUDA_VISIBLE_DEVICES"] = (_visible or "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

MAIN_N = 128_000_000
MPSM_CHUNKS = (4, 64)  # the CLI's mpsm run and the benchmark cell's
NONUNIQUE_N = 16_000_000
PAIR_N = 16_000_000
CHECK_N = (1 << 22) + 12_345  # ragged: not a multiple of any block
REPS = 5
DOMAIN_MAX = 2**31 - 2  # keys lie in [-(2^31 - 2), 2^31 - 2]
KEY_INF = 2**31 - 1  # the pad
BLOCK = 16_384
# The least time the card could take: bytes over the H100 SXM's 3.35 TB/s,
# and compare operations over 67e12 a second, the fp32 rate outside the
# tensor cores, the only scalar 32-bit rate in the published table (int32
# compares run at most at it).  The larger of the two bounds the kernel.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {  # id -> (name, source, TPU kernel it replaces)
    "K1": ("K1 block_sort", "block_sort.cu", "ops/sort.py:97"),
    "K2": ("K2 multiway_merge", "multiway_merge.cu",
           "ops/multiwaymerge.py:85"),
    "K3": ("K3 merge_join_count", "merge_join_count.cu",
           "ops/mergejoin.py:179"),
    "K4": ("K4 merge_pass", "merge_pass.cu", "ops/sort.py:279"),
    "K5": ("K5 block_sort_pairs", "block_sort_pairs.cu", "ops/sort.py:86"),
    "K6": ("K6 multiway_merge_pairs", "multiway_merge.cu",
           "ops/multiwaymerge.py:85"),
    "K7": ("K7 merge_join_count64", "merge_join_count.cu",
           "ops/mergejoin.py:747"),
    "K8": ("K8 radix_hist", "radix_hist.cu", "ops/partition.py:62"),
    "K9": ("K9 chunk_gated_merge", "chunk_gated_merge.cu",
           "parallel/remote_fifo.py:181"),
    "K10": ("K10 merge_join_count2", "merge_join_count.cu",
            "ops/mergejoin.py:533"),
    "K11": ("K11 remote_pull (a launch a card; NVLink peer writes across "
            "cards)", "remote_pull.cu", "parallel/remote_fifo.py:272"),
}
PATHS = {  # join path -> (CLI flags, kernels it must launch)
    "m-way": (["-a", "m-way"], ("K1", "K2", "K3")),
    "m-pass": (["-a", "m-pass"], ("K1", "K4", "K3")),
    "mpsm": (["-a", "mpsm", "--nchunks", "4"], ("K1", "K2", "K3")),
    "materialize": (["-a", "m-way", "--materialize"],
                    ("K1", "K2", "K5", "K6")),
    "key8b": (["--key8b"], ("K5", "K6", "K7")),
}
DIST_PATHS = {  # -n 8 path -> (CLI flags, kernels it must launch, phase
    # times it prints, its launches at 128M where they are fixed)
    "m-way": (["-a", "m-way"], ("K1", "K2", "K3"),
              ("sort", "merge1", "mergejoin"), None),
    "m-pass": (["-a", "m-pass"], ("K1", "K2", "K3", "K4"), ("total",),
               {"K1": 16, "K2": 48, "K4": 48, "K3": 8}),
    "mpsm": (["-a", "mpsm"], ("K1", "K2", "K3"), ("total",),
             {"K1": 16, "K2": 48, "K3": 512, "K4": 0}),
    "materialize": (["--materialize"], ("K1", "K2", "K5", "K6"), ("total",),
                    {"K1": 8, "K2": 32, "K5": 8, "K6": 32, "K3": 0}),
}
KEY8B_SCALAR_N = 16_000_000
PERSIST_N = 1_000_000
HIST_CHECK_N = 3 * 65536 + 12_345  # three whole histogram tiles, one ragged
HIST_BITS = (7, 14, 16)  # K8 timed at 128M keys
HIST_WRAP_N = 64 << 20  # K8 at 2^16: halves wrap in every global CTA
ZIPF_ALPHABET = 1 << 20  # the 128M Zipf keys' alphabet (S's maxid)
PART_N = 8_388_608  # scripts/partitioning-bench.sh's 8M tuples
PART_BITS = (2, 4, 6, 8, 10, 12, 14, 16)
PART_BIG_BITS = (7, 14)  # the 128M `hist` rows
ZIPF_N = 16_000_000  # -z 1.0 through the CLI
DIST_SHARDS = 8  # the distributed m-way paths' mesh
DIST_SMALL_N = 16_000_000  # -S RING/RANDOM, 2 x 4, overlap, -z, dist_join
DIST_CAP = 4_014_080  # bucket cap of 16M-key shards over 8 at slack 2
DIST_CHUNK = 81_920  # pick_chunk_elems(DIST_CAP, 16384, 8): 49 a strip
VARLEN_STRIDE = 1_000_003  # varlen K2 checks: an odd stride
MERGE_TILE = 4096  # outputs a merge tile of K2 and K6
EDGE_TOTALS = (MERGE_TILE - 1, MERGE_TILE, MERGE_TILE + 1,
               3 * MERGE_TILE + 7)  # group totals at the tile's edges
NEW_MERGE_TILES = (2048, 8192)  # the keys-only K2's other tiles (-m)
MWAY_M_BUDGETS = {2048: 1, 4096: 40_000, 8192: 1 << 20}  # -m bytes a tile
GRID_ROWS = 25  # the results grid's cells (algo 13, key8b, zipf, card 2 each,
# scale 6)
GRID_SCALE_MAX = 25 * 32 * 1024 * 1024  # its largest row: 838,860,800 a side
TWINS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "avx_sort_merge_joins_tpu_torch", "scripts")
PULL_CAP = 131_072  # K11 checks: strips of 2 to 8 chunks of 64K to 16K
PULL_CHUNKS = (PULL_CAP, 16_384, 32_768, 65_536)  # a strip, T, 2T, 4T
PULL_WINDOWS = (1, 4, 8, 32)  # and every push in flight
PULL_EDGE_LENS = (MERGE_TILE - 1, MERGE_TILE, MERGE_TILE + 1,
                  3 * MERGE_TILE + 7)  # strip lengths at the tile's edges
PULL_EDGE_CAP = 16_384
COUNT2_SPAN = 67_108_864  # run 0 of each side on the 128M two-run route
K4_TILE = 4096  # outputs a merge-path tile of K4 (csrc/merge_pass.cu)
K4_CTA = 7 * K4_TILE  # outputs a CTA of K4: its tiles' 8 boundaries
K4_SPANS = (1, K4_TILE - 1, K4_TILE, K4_TILE + 1, K4_CTA - 1, K4_CTA,
            K4_CTA + 1)  # run A at the tiles' and CTAs' edges
K4_UNIFORM_SPAN = 1 << 21  # the uniform pass timed beside the varlen one
K3_TILE = 1920  # merged elements a tile of K3 (csrc/merge_join_count.cu)
K3_CTA = 8 * K3_TILE  # merged elements a CTA of K3
SCALE_N = 1_600_000_000  # workload A: -r 1600000000 -s 1600000000, -n 8
SCALE_ARGV = ["-a", "m-way", "-n", str(DIST_SHARDS), "-r", str(SCALE_N),
              "-s", str(SCALE_N)]
SCALEBENCH_N = 134_217_728  # scalebench's 1, 2, 4, 8 and 2 x 4 rows
SCALEBENCH_SMALL_N = 16_000_000  # its m-pass and mpsm rows
NUMA_N = 1 << 25  # tputbench --mode numa: keys a shard
TRACE_N = 16_000_000  # -o DIR
ROOFLINE_PATHS = ("m-way", "m-pass", "mpsm")  # CLI runs that print rows
BENCHES = [  # (module, argv): each once at its JAX defaults
    ("sortbench", ["16", "multiway"]), ("sortbench", ["16", "keysonly"]),
    ("sortbench", ["16", "pairwise"]),
    ("mergebench", ["8", "--variant", "fifo2"]),
    ("mergebench", ["8", "--variant", "pairwise"]),
    ("multiwaymergebench", ["1048576", "16"]),
    ("tputbench", ["--mode", "tput", "-n", "16777216"]),
    ("tputbench", ["--mode", "mpsm", "-n", "16777216", "--nchunks", "1",
                   "4"]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); this script runs only "
                         "on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s), "
        f"kind {torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    from avx_sort_merge_joins_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    nvcc = ("library already built" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.2f} s")
    log(f"[build] {_build.build()} ready in "
        f"{time.perf_counter() - t0:.2f} s ({nvcc})")


def time_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


class Timings:
    """Per kernel: kernel, plain and library milliseconds and the bytes
    and operations of the same work, summed over the calls timed."""

    def __init__(self):
        self.rows = {}

    def add(self, k: str, ms: float, plain: float, library: float | None,
            nbytes: float, ops: float) -> None:
        row = self.rows.setdefault(k, [0.0, 0.0, None, 0.0, 0.0])
        row[0] += ms
        row[1] += plain
        if library is not None:
            row[2] = (row[2] or 0.0) + library
        row[3] += nbytes
        row[4] += ops

    def entry(self, k: str) -> dict:
        ms, plain, library, nbytes, ops = self.rows[k]
        bound, by = bound_ms(nbytes, ops)
        return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "library_ms": library}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def key_cases(n: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    return {
        "uniform": rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, n),
        "duplicates": rng.integers(0, 16, n),
        "negative": rng.integers(-(2**30), 0, n),
        "domain_ends": rng.choice(
            np.array([-DOMAIN_MAX, -DOMAIN_MAX + 1, 0,
                      DOMAIN_MAX - 1, DOMAIN_MAX]), n),
    }


def k1_edge_cases(n: int, rng: np.random.Generator,
                  dev: torch.device) -> dict[str, torch.Tensor]:
    """Inputs at the bitonic network's edges: already sorted, reversed, all
    equal, 16 values, the two ends of the key domain."""
    keys = np.sort(rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, n))
    cases = {
        "sorted": keys,
        "reversed": keys[::-1],
        "equal": np.full(n, 5),
        "16_values": rng.integers(0, 16, n),
        "domain_ends": rng.choice(np.array([-DOMAIN_MAX, DOMAIN_MAX]), n),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v).astype(np.int32))
            .to(dev) for k, v in cases.items()}


ERR = {k: 0 for k in KERNELS}


def record(kernel: str, case: str, got, want) -> None:
    """Hold a kernel's output (a tensor or a tuple of them) against its
    plain version's: exact equality."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    e = max(max_abs_err(g, w) for g, w in zip(got, want))
    log(f"[check] {kernel} {case}: max_abs_err {e}")
    if e != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{kernel} {case}: kernel != plain")
    ERR[kernel] = max(ERR[kernel], e)


def padded_rows(col: torch.Tensor, n: int, row: int, fill) -> torch.Tensor:
    """col[:n] padded with ``fill`` to whole rows of ``row`` slots, as a
    (rows, row) view: the input of a library yardstick."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    rows = max(1, sort_ops.cdiv(n, row))
    return sort_ops._padded(col, n, rows * row, fill).view(rows, row)


def merge_parts_ms(runs: torch.Tensor, pays, n: int, level) -> dict:
    """One K2 (``pays`` None) or K6 level timed in its parts, CUDA events:
    the two co-rank passes, the coarse one alone (a search in device
    memory), the fine one alone (sampled, finished in shared memory, up to
    fan-in 32) on the coarse rows, and the tile merge on their co-ranks."""
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    _, span, nruns, w = level
    ngroups = sort_ops.cdiv(nruns, w)
    scratch = mw.corank_scratch(runs, ngroups, span, w)

    def part(mask):
        return time_ms(lambda: mw._launch(
            "smj_multiway_merge", runs, pays, ngroups, span, w, n, span,
            parts=mask, scratch=scratch))

    return {"corank": part(1 | 2), "coarse": part(1), "fine": part(2),
            "merge": part(4)}


def check_corank_rows(kernel: str, runs: torch.Tensor, pays, n: int,
                      level) -> None:
    """One K2 (``pays`` None) or K6 level's co-rank rows, the scratch its
    coarse and fine co-rank launches write, against
    ``corank_rows_plain``: bit for bit, and no sampled bracket fell back
    to the search in device memory."""
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    _, span, nruns, w = level
    ngroups = sort_ops.cdiv(nruns, w)
    scratch = mw.corank_scratch(runs, ngroups, span, w)
    mw.corank_fallbacks(runs.device, reset=True)
    mw._launch("smj_multiway_merge", runs, pays, ngroups, span, w, n, span,
               parts=1 | 2, scratch=scratch)
    want = mw.corank_rows_plain(runs, w, (nruns, n, span), pays)
    record(kernel, f"co-rank rows n={n} level={level}",
           scratch[:want.numel()].view(want.shape), want)
    falls = mw.corank_fallbacks(runs.device)
    if falls:
        raise AssertionError(f"{kernel} level={level}: {falls} sampled "
                             f"brackets fell back to the search")


def gated_parts_ms(land: torch.Tensor, lens: torch.Tensor, stride: int,
                   chunk: int, arrive, reps: int = REPS) -> dict:
    """One K9 call timed whole and in its parts, CUDA events: the two
    co-rank passes, the gate on their co-ranks, and the tile merge on
    them."""
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf

    table = rf._checked(land, lens, stride, chunk, arrive)
    scratch = mw.corank_scratch(land, 1, stride, lens.numel())

    def part(mask):
        return time_ms(lambda: rf._gated_launch(
            land, lens, stride, chunk, table, parts=mask, scratch=scratch),
            reps)

    return {"all": part(15), "corank": part(1 | 2), "gate": part(8),
            "merge": part(4)}


def k3_cases(rng: np.random.Generator,
             dev: torch.device) -> dict[str, tuple]:
    """Sorted (R, S) inputs at the edges of K3's merge-path tiles: a hot
    key only in S over about 100 tiles, non-unique R and S, nR + nS at a
    tile's and a CTA's size - 1, + 0 and + 1, nR >> nS and nS >> nR, a
    side of length 1 and keys at both ends of the domain."""
    def col(a):
        return torch.sort(torch.from_numpy(
            np.asarray(a).astype(np.int32)).to(dev)).values

    hot = 100 * K3_TILE
    cases = {
        "hot key only in S over 100 tiles": (
            col(np.arange(0, 4000, 2)),
            col(np.r_[np.full(hot, 1000), rng.integers(0, 4000, 5000)])),
        "non-unique R and S": (col(rng.integers(0, 1000, 300_000)),
                               col(rng.integers(0, 1000, 200_000))),
        "nR >> nS": (col(rng.integers(0, 1 << 22, 3_000_000)),
                     col(rng.integers(0, 1 << 22, 100))),
        "nS >> nR": (col(rng.integers(0, 1 << 22, 100)),
                     col(rng.integers(0, 1 << 22, 3_000_000))),
        "R of length 1": (col([123]), col(rng.integers(0, 200, 100_000))),
        "S of length 1": (col(rng.integers(0, 200, 100_000)), col([123])),
        "domain ends": (col(rng.choice([-DOMAIN_MAX, DOMAIN_MAX], 50_000)),
                        col(rng.choice([-DOMAIN_MAX, DOMAIN_MAX], 70_000))),
    }
    for size in (K3_TILE, K3_CTA):
        for n in (size - 1, size, size + 1):
            for nr in (1, n // 2, n - 1):
                cases[f"nR + nS = {n}, nR = {nr}"] = (
                    col(rng.integers(0, 50, nr)),
                    col(rng.integers(0, 50, n - nr)))
    return cases


def phase_kernels(dev: torch.device, times: Timings) -> None:
    """Exactness of K1/K2/K3 against their plain versions; then their
    times at the main path's shapes."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    rng = np.random.default_rng(20261016)
    for case, host in key_cases(CHECK_N, rng).items():
        keys = torch.from_numpy(host.astype(np.int32)).to(dev)
        n = keys.numel()
        for block in sort_ops.SUPPORTED_BLOCKS:
            record("K1", f"{case} block={block}",
                   sort_ops.sort_blocks(keys, n, block),
                   sort_ops.sort_blocks_plain(keys, n, block))
        for fanin in (2, 16):
            # first level, then a second level over the first's output;
            # the last group of each level has fewer than fanin runs
            runs = sort_ops.sort_blocks_plain(keys, n, 16384)
            span, nruns = 16384, sort_ops.cdiv(n, 16384)
            for _ in range(2):
                lens = (nruns, n, span)
                want = mw.multiway_merge_plain(runs, fanin, lens)
                record("K2", f"{case} fanin={fanin} span={span}",
                       mw.multiway_merge(runs, fanin, lens)[0], want)
                runs, span, nruns = (want, span * fanin,
                                     sort_ops.cdiv(nruns, fanin))
        s_host = key_cases(CHECK_N // 2, rng)[case].astype(np.int32)
        sk = torch.sort(torch.from_numpy(s_host).to(dev)).values
        rk = torch.sort(keys).values
        ns = sk.numel()
        record("K3", case, mergejoin.merge_join_count_fused(rk, sk, n, ns),
               mergejoin.merge_join_count_fused_plain(rk, sk, n, ns))
    for block in sort_ops.SUPPORTED_BLOCKS:
        got, want = [], []
        for case, keys in k1_edge_cases(3 * block + 1, rng, dev).items():
            for n in (block - 1, block, block + 1, 0, 3 * block + 1):
                got.append(sort_ops.sort_blocks(keys, n, block))
                want.append(sort_ops.sort_blocks_plain(keys, n, block))
        record("K1", f"edges block={block}: sorted, reversed, equal, 16 "
               f"values, domain ends at n = block - 1, block, block + 1, 0",
               tuple(got), tuple(want))
    # no matches, and a count above 2^31 (2^16 x 2^16 equal keys)
    rk = torch.arange(0, 2 * CHECK_N, 2, dtype=torch.int32, device=dev)
    sk = rk + 1
    record("K3", "no_matches", mergejoin.merge_join_count_fused(
        rk, sk, CHECK_N, CHECK_N), mergejoin.merge_join_count_fused_plain(
        rk, sk, CHECK_N, CHECK_N))
    hot = torch.full((1 << 16,), 7, dtype=torch.int32, device=dev)
    got = mergejoin.merge_join_count_fused(hot, hot, 1 << 16, 1 << 16)
    record("K3", "hot_key_2^32", got, mergejoin.merge_join_count_fused_plain(
        hot, hot, 1 << 16, 1 << 16))
    if int(got) != 1 << 32:
        raise AssertionError(f"K3 hot key: {int(got)} != 2^32")
    for case, (rk, sk) in k3_cases(rng, dev).items():
        nr, ns = rk.numel(), sk.numel()
        record("K3", case, mergejoin.merge_join_count_fused(rk, sk, nr, ns),
               mergejoin.merge_join_count_fused_plain(rk, sk, nr, ns))

    # times at the main path's shapes: one 128M relation
    gen = torch.Generator(device=dev).manual_seed(7)
    keys = torch.randint(1, MAIN_N + 1, (MAIN_N,), generator=gen,
                         dtype=torch.int32, device=dev)
    lib_in = padded_rows(keys, MAIN_N, BLOCK, 2**31 - 1)
    times.add("K1", time_ms(lambda: sort_ops.sort_blocks(keys, MAIN_N)),
              time_ms(lambda: sort_ops.sort_blocks_plain(keys, MAIN_N)),
              time_ms(lambda: lib_in.sort(dim=1)),
              4 * MAIN_N + 4 * lib_in.numel(), MAIN_N * math.log2(BLOCK))
    del lib_in
    log(f"[time] K1 sort_blocks n={MAIN_N} block={BLOCK}: "
        f"{times.entry('K1')}")
    runs = sort_ops.sort_blocks(keys, MAIN_N)
    record("K1", "main_shape", runs, sort_ops.sort_blocks_plain(keys, MAIN_N))
    for level in mw.merge_levels(MAIN_N, BLOCK):
        _, span, nruns, w = level
        lens = (nruns, MAIN_N, span)
        got = mw.multiway_merge(runs, w, lens)[0]
        want = mw.multiway_merge_plain(runs, w, lens)
        record("K2", f"main_shape level={level}", got, want)
        del got
        check_corank_rows("K2", runs, None, MAIN_N, level)
        lib_in = padded_rows(runs, MAIN_N, w * span, 2**31 - 1)
        ms = time_ms(lambda: mw.multiway_merge(runs, w, lens))
        parts = merge_parts_ms(runs, None, MAIN_N, level)
        plain = time_ms(lambda: mw.multiway_merge_plain(runs, w, lens))
        library = time_ms(lambda: lib_in.sort(dim=1))
        del lib_in
        times.add("K2", ms, plain, library, 8 * MAIN_N,
                  MAIN_N * math.log2(w))
        log(f"[time] K2 level (stride, span, nruns, w)={level}: "
            f"kernel {ms:.3f} ms (co-rank {parts['corank']:.3f}, of it "
            f"coarse {parts['coarse']:.3f}, fine {parts['fine']:.3f}; merge "
            f"{parts['merge']:.3f}), "
            f"plain {plain:.3f} ms, library {library:.3f} ms, bound "
            f"{bound_ms(8 * MAIN_N, MAIN_N * math.log2(w))[0]:.3f} ms")
        runs = want
    log(f"[time] K2 all levels of an n={MAIN_N} sort: {times.entry('K2')}")
    rk = torch.arange(1, MAIN_N + 1, dtype=torch.int32, device=dev)
    sk = runs[:MAIN_N]
    record("K3", "main_shape", mergejoin.merge_join_count_fused(
        rk, sk, MAIN_N, MAIN_N), mergejoin.merge_join_count_fused_plain(
        rk, sk, MAIN_N, MAIN_N))
    # no one PyTorch call computes the count: no library yardstick
    times.add("K3",
              time_ms(lambda: mergejoin.merge_join_count_fused(
                  rk, sk, MAIN_N, MAIN_N)),
              time_ms(lambda: mergejoin.merge_join_count_fused_plain(
                  rk, sk, MAIN_N, MAIN_N)),
              None, 8 * MAIN_N + 8, 2 * MAIN_N)
    log(f"[time] K3 count {MAIN_N} x {MAIN_N}: {times.entry('K3')}")


def seeded_pairs(n: int, rng: np.random.Generator, keys: np.ndarray):
    """Payloads with duplicates and the two pad values beside ``keys``."""
    pays = rng.integers(-2, 3, n).astype(np.int32)
    pays[::101] = 2**31 - 1
    pays[::103] = -(2**31)
    return keys.astype(np.int32), pays


def k5_edge_cases(n: int, rng: np.random.Generator,
                  dev: torch.device) -> dict[str, tuple]:
    """(key, payload) inputs at the bitonic network's edges: keys sorted or
    reversed, all keys equal with distinct payloads, all pairs equal, and
    keys and payloads at the two ends of their domains."""
    keys = np.sort(rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, n))
    pays = rng.integers(-2**31, 2**31, n)
    ends = np.array([-(2**31), -DOMAIN_MAX, DOMAIN_MAX, 2**31 - 1])
    cases = {
        "sorted": (keys, pays),
        "reversed": (keys[::-1], pays),
        "equal keys": (np.full(n, 5), rng.permutation(n) - n // 2),
        "equal pairs": (np.full(n, 5), np.full(n, -9)),
        "domain ends": (rng.choice(ends[1:3], n), rng.choice(ends, n)),
    }
    return {c: tuple(torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int32)).to(dev) for a in kp) for c, kp in cases.items()}


def phase_pair_kernels(dev: torch.device, times: Timings) -> None:
    """Exactness of K5 and K4 against their plain versions; then K4's 13
    passes over a 128M relation and one 128M K5 launch, timed."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    rng = np.random.default_rng(20261017)
    for case, host in key_cases(CHECK_N, rng).items():
        k, p = (torch.from_numpy(a).to(dev)
                for a in seeded_pairs(CHECK_N, rng, host))
        n = CHECK_N
        for desc in (False, True):
            for block in sort_ops.SUPPORTED_BLOCKS:
                record("K5", f"{case} block={block} descending={desc}",
                       sort_ops.sort_blocks_pairs(k, p, n, block, desc),
                       sort_ops.sort_blocks_pairs_plain(k, p, n, block,
                                                        desc))
        # keys only: 257 -> 129 -> 65 runs, the last one ragged
        runs = sort_ops.sort_blocks_plain(k, n, BLOCK)
        for nruns, span in sort_ops.pair_levels(n, BLOCK)[:2]:
            lens = (nruns, n, span)
            want, _ = sort_ops.merge_pass_plain(runs, None, lens)
            record("K4", f"{case} keys span={span} nruns={nruns}",
                   sort_ops.merge_pass(runs, None, lens)[0], want)
            runs = want
        for desc in (False, True):
            rk, rp = sort_ops.sort_blocks_pairs_plain(k, p, n, BLOCK, desc)
            for nruns, span in sort_ops.pair_levels(n, BLOCK)[:2]:
                lens = (nruns, n, span)
                want = sort_ops.merge_pass_plain(rk, rp, lens, desc)
                record("K4", f"{case} pairs descending={desc} span={span}",
                       sort_ops.merge_pass(rk, rp, lens, desc), want)
                rk, rp = want

    for block in sort_ops.SUPPORTED_BLOCKS:
        got, want = [], []
        for k, p in k5_edge_cases(block + 1, rng, dev).values():
            for n in (block - 1, block, block + 1, 0):
                for desc in (False, True):
                    got += sort_ops.sort_blocks_pairs(k, p, n, block, desc)
                    want += sort_ops.sort_blocks_pairs_plain(k, p, n, block,
                                                             desc)
        record("K5", f"edges block={block}: sorted, reversed, equal keys, "
               f"equal pairs, domain ends at n = block - 1, block, block + "
               f"1, 0, both directions", tuple(got), tuple(want))

    # all 13 K4 passes over one 128M relation, each pass timed
    gen = torch.Generator(device=dev).manual_seed(11)
    keys = torch.randint(1, MAIN_N + 1, (MAIN_N,), generator=gen,
                         dtype=torch.int32, device=dev)
    runs = sort_ops.sort_blocks(keys, MAIN_N)
    for nruns, span in sort_ops.pair_levels(MAIN_N, BLOCK):
        lens = (nruns, MAIN_N, span)
        got, _ = sort_ops.merge_pass(runs, None, lens)
        want, _ = sort_ops.merge_pass_plain(runs, None, lens)
        record("K4", f"main_shape span={span} nruns={nruns}", got, want)
        del got
        lib_in = padded_rows(runs, MAIN_N, 2 * span, 2**31 - 1)
        ms = time_ms(lambda: sort_ops.merge_pass(runs, None, lens))
        plain = time_ms(lambda: sort_ops.merge_pass_plain(runs, None, lens))
        library = time_ms(lambda: lib_in.sort(dim=1))
        del lib_in
        times.add("K4", ms, plain, library, 4 * MAIN_N + 4 * runs.numel(),
                  MAIN_N)
        log(f"[time] K4 pass span={span} nruns={nruns}: kernel {ms:.3f} "
            f"ms, plain {plain:.3f} ms, library {library:.3f} ms")
        runs = want
    log(f"[time] K4 all passes of an n={MAIN_N} sort: {times.entry('K4')}")
    del runs, want

    # one K5 launch over 128M pairs
    pays = torch.randint(-2**31, 2**31 - 1, (MAIN_N,), generator=gen,
                         dtype=torch.int32, device=dev)
    got = sort_ops.sort_blocks_pairs(keys, pays, MAIN_N)
    record("K5", "main_shape", got,
           sort_ops.sort_blocks_pairs_plain(keys, pays, MAIN_N))
    del got
    lib_in = padded_rows(sort_ops.pack_pairs(keys, pays), MAIN_N, BLOCK,
                         2**63 - 1)
    times.add("K5",
              time_ms(lambda: sort_ops.sort_blocks_pairs(keys, pays,
                                                         MAIN_N)),
              time_ms(lambda: sort_ops.sort_blocks_pairs_plain(keys, pays,
                                                               MAIN_N)),
              time_ms(lambda: lib_in.sort(dim=1)),
              8 * MAIN_N + 8 * lib_in.numel(), MAIN_N * math.log2(BLOCK))
    log(f"[time] K5 sort_blocks_pairs n={MAIN_N} block={BLOCK}: "
        f"{times.entry('K5')}")


def pair_inputs(dev: torch.device):
    """The pair phase's seeded inputs: 16M (key, payload) pairs with
    duplicate keys and pad-valued payloads, and two sorted 16M key columns
    over 65,536 values for the tag-merge count."""
    gen = torch.Generator(device=dev).manual_seed(13)
    keys = torch.randint(0, 1 << 20, (PAIR_N,), generator=gen,
                         dtype=torch.int32, device=dev)
    pays = torch.randint(-4, 5, (PAIR_N,), generator=gen, dtype=torch.int32,
                         device=dev)
    pays[::101] = 2**31 - 1
    pays[::103] = -(2**31)
    rk = torch.sort(torch.randint(0, 1 << 16, (PAIR_N,), generator=gen,
                                  dtype=torch.int32, device=dev)).values
    sk = torch.sort(torch.randint(0, 1 << 16, (PAIR_N,), generator=gen,
                                  dtype=torch.int32, device=dev)).values
    return keys, pays, rk, sk


def log_k3_time(shape: str, rk: torch.Tensor, sk: torch.Tensor, nr: int,
                ns: int) -> None:
    """K3 and its plain version timed at one more shape of the paths,
    printed (the kernels line keeps the main shape's time)."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin

    ms = time_ms(lambda: mergejoin.merge_join_count_fused(rk, sk, nr, ns))
    plain = time_ms(lambda: mergejoin.merge_join_count_fused_plain(
        rk, sk, nr, ns))
    log(f"[time] K3 count {nr} x {ns} ({shape}): kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bound_ms(4 * (nr + ns), 2 * nr)[0]:.3f} ms")


def phase_path_shapes(dev: torch.device) -> None:
    """Each kernel against its plain version at the shapes the mpsm path
    and the pair phase give it, beyond phases 3-4's 128M relation."""
    from avx_sort_merge_joins_tpu_torch.models import mpsm
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    # mpsm: one S chunk of the CLI's 4-chunk run and of the benchmark's
    # 64 private runs, foreign keys over R
    rk = torch.arange(1, MAIN_N + 1, dtype=torch.int32, device=dev)
    for nchunks in MPSM_CHUNKS:
        _, chunk = mpsm._chunks(MAIN_N, nchunks)[0]
        gen = torch.Generator(device=dev).manual_seed(17)
        sk = torch.randint(1, MAIN_N + 1, (chunk,), generator=gen,
                           dtype=torch.int32, device=dev)
        runs = sort_ops.sort_blocks_plain(sk, chunk)
        record("K1", f"mpsm chunk n={chunk}",
               sort_ops.sort_blocks(sk, chunk), runs)
        for level in mw.merge_levels(chunk, BLOCK, mpsm.FANIN_DEFAULT):
            _, span, nruns, w = level
            lens = (nruns, chunk, span)
            want = mw.multiway_merge_plain(runs, w, lens)
            record("K2", f"mpsm chunk n={chunk} level={level}",
                   mw.multiway_merge(runs, w, lens)[0], want)
            runs = want
        record("K3", f"mpsm {MAIN_N} x {chunk}",
               mergejoin.merge_join_count_fused(rk, runs, MAIN_N, chunk),
               mergejoin.merge_join_count_fused_plain(rk, runs, MAIN_N,
                                                      chunk))
        log_k3_time(f"an mpsm chunk of {nchunks}", rk, runs, MAIN_N, chunk)
        del sk, runs, want
    del rk

    # the pair phase: K5 and each K4 pass of sort / sort_descending
    keys, pays, rk, sk = pair_inputs(dev)
    for desc in (False, True):
        ks, ps = sort_ops.sort_blocks_pairs_plain(keys, pays, PAIR_N, BLOCK,
                                                  desc)
        record("K5", f"pairs n={PAIR_N} descending={desc}",
               sort_ops.sort_blocks_pairs(keys, pays, PAIR_N, BLOCK, desc),
               (ks, ps))
        for nruns, span in sort_ops.pair_levels(PAIR_N, BLOCK):
            lens = (nruns, PAIR_N, span)
            want = sort_ops.merge_pass_plain(ks, ps, lens, desc)
            record("K4", f"pairs n={PAIR_N} descending={desc} span={span}",
                   sort_ops.merge_pass(ks, ps, lens, desc), want)
            ks, ps = want
    # the tag-merge count's two merges: the two-run layout, both flag orders
    for r_flag, s_flag in ((0, 1), (1, 0)):
        k, p, lens = sort_ops.two_run_layout(rk, sk, PAIR_N, PAIR_N, r_flag,
                                             s_flag)
        record("K4", f"tag merge {PAIR_N} + {PAIR_N} flags R={r_flag} "
               f"S={s_flag}", sort_ops.merge_pass(k, p, lens),
               sort_ops.merge_pass_plain(k, p, lens))


def run_cli_full(argv: list[str]) -> tuple[int, str, str]:
    """Run the port's CLI in-process; echo its output; return
    (exit code, stdout, stderr)."""
    from avx_sort_merge_joins_tpu_torch import cli

    out, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        rc = cli.main(argv)
    for line in (errs.getvalue() + out.getvalue()).splitlines():
        log(f"[cli] {line}")
    return rc, out.getvalue(), errs.getvalue()


def run_cli(argv: list[str]) -> tuple[int, str]:
    """:func:`run_cli_full` without the stderr."""
    return run_cli_full(argv)[:2]


def results_of(stdout: str) -> int:
    m = re.search(r"^Results = (\d+)$", stdout, re.M)
    if m is None:
        raise AssertionError("no 'Results = N' line")
    return int(m.group(1))


def reset_launches() -> None:
    from avx_sort_merge_joins_tpu_torch.kernels import _build

    _build.reset_launches()


def launches() -> dict[str, int]:
    """Every kernel's launches since the last reset, by kernel id."""
    from avx_sort_merge_joins_tpu_torch.kernels import _build

    counts = _build.launches()
    return {k: counts[k] for k in KERNELS}


def check_launched(path: str, counts: dict, need) -> None:
    idle = [k for k in need if counts[k] <= 0]
    if idle:
        raise AssertionError(f"{path} never launched {idle}")


def check_roofline(path: str, stderr: str) -> None:
    """The ``[ROOFLINE]`` rows of a single-device CLI run: a denominator
    line (the card's measured copy rate) and a row a timed phase, each
    share at most 100% (above it the byte count would be wrong)."""
    head = re.search(r"^\[ROOFLINE\] denominator ([\d.]+) GB/s: (.*)$",
                     stderr, re.M)
    rows = re.findall(r"^\[ROOFLINE\] (\S+)\s+([\d.]+) GB/s \(\s*([\d.]+)% of",
                      stderr, re.M)
    if head is None or not rows:
        raise AssertionError(f"{path}: no [ROOFLINE] rows")
    log(f"[roofline] {path}: copy rate {head.group(1)} GB/s "
        f"({head.group(2)}); shares "
        + ", ".join(f"{ph} {pct}%" for ph, _, pct in rows))
    over = [(ph, pct) for ph, _, pct in rows if float(pct) > 100.0]
    if over:
        raise AssertionError(f"{path}: roofline shares above 100%: {over}")


def phase_path(path: str) -> dict[str, int]:
    flags, need = PATHS[path]
    argv = [*flags, "-r", str(MAIN_N), "-s", str(MAIN_N)]
    reset_launches()
    t0 = time.perf_counter()
    rc, stdout, stderr = run_cli_full(argv)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[{path}] cli.main({argv}) -> rc {rc} in "
        f"{time.perf_counter() - t0:.3f} s (data generation included); "
        f"launches {counts}")
    if rc != 0:
        raise AssertionError(f"{path} exit code {rc}")
    got = results_of(stdout)
    if got != MAIN_N:
        raise AssertionError(f"{path}: Results = {got} != {MAIN_N}")
    check_launched(path, counts, need)
    if path in ROOFLINE_PATHS:
        check_roofline(path, stderr)
    return counts


def phase_pair_sort(dev: torch.device) -> dict[str, int]:
    """``sort``/``sort_descending`` and the tag-merge count at 16M, with
    the launches of those calls alone."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    keys, pays, rk, sk = pair_inputs(dev)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    asc = sort_ops.sort(keys, pays)
    desc = sort_ops.sort_descending(keys, pays)
    stats = mergejoin.merge_join_count(rk, sk, PAIR_N, PAIR_N)
    tag_count = mergejoin.finish_count(stats)
    torch.cuda.synchronize()
    counts = launches()
    log(f"[pairs] sort + sort_descending of {PAIR_N} pairs and the "
        f"tag-merge count of {PAIR_N} x {PAIR_N}: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms, launches {counts}")
    check_launched("pair sort + tag merge", counts, ("K4", "K5"))

    want = sort_ops.sort_torch(keys, pays)
    if not all(torch.equal(g, w) for g, w in zip(asc, want)):
        raise AssertionError("sort != sort_torch")
    if not all(torch.equal(g, w.flip(0)) for g, w in zip(desc, want)):
        raise AssertionError("sort_descending != reversed sort_torch")
    k3 = mergejoin.finish_count_fused(mergejoin.merge_join_count_fused(
        rk, sk, PAIR_N, PAIR_N))
    base = int(mergejoin.merge_join_count_torch(rk, sk, PAIR_N, PAIR_N))
    log(f"[pairs] sort and sort_descending equal sort_torch; tag-merge "
        f"count {tag_count}, K3 count {k3}, torch.sort baseline {base}")
    if not tag_count == k3 == base:
        raise AssertionError("tag-merge count != K3 count / baseline")
    return counts


def phase_nonunique(dev: torch.device) -> None:
    """The count join and the materializing join of one pair of
    host-generated ``--non-unique`` relations (duplicate R keys)."""
    from avx_sort_merge_joins_tpu_torch import cli
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    args = cli.build_parser().parse_args(
        ["-a", "m-way", "-r", str(NONUNIQUE_N), "-s", str(NONUNIQUE_N),
         "--non-unique"])
    t0 = time.perf_counter()
    R, S = cli.make_relations(args, dev)
    log(f"[nonunique] host data generation {time.perf_counter() - t0:.1f} s")
    res = cli.run_join(args, R, S)
    rs = torch.sort(R.keys[:R.num_tuples]).values
    ss = torch.sort(S.keys[:S.num_tuples]).values
    want = int(mergejoin.merge_join_count_torch(rs, ss, R.num_tuples,
                                                S.num_tuples))
    log(f"[nonunique] {NONUNIQUE_N} x {NONUNIQUE_N}: Results = "
        f"{res.totalresults}, torch.sort "
        f"baseline {want}, phases "
        f"{ {k: round(v * 1e3, 3) for k, v in res.phases.items()} } ms")
    if res.totalresults != want:
        raise AssertionError("non-unique count != torch.sort baseline")

    args.materialize = True
    res = cli.run_join(args, R, S)
    out = res.resultlist[0].results
    # the plain route: S in (key, payload) order, each tuple once per R
    # tuple of its key, the multiplicities from the unique R keys' counts
    sks, sps = sort_ops.sort_torch(S.keys[:S.num_tuples],
                                   S.payloads[:S.num_tuples])
    ru, rc = torch.unique(rs, return_counts=True)
    at = torch.searchsorted(ru, sks).clamp(max=ru.numel() - 1)
    mult = torch.where(ru[at] == sks, rc[at], 0)
    ek = torch.repeat_interleave(sks, mult)
    ep = torch.repeat_interleave(sps, mult)
    log(f"[nonunique] materialize: Results = {res.totalresults}, "
        f"{out.num_tuples} output rows, plain route {ek.numel()} rows, "
        f"phases { {k: round(v * 1e3, 3) for k, v in res.phases.items()} } "
        f"ms")
    if not res.totalresults == out.num_tuples == want == ek.numel():
        raise AssertionError("non-unique materialize: row count != baseline")
    if not (torch.equal(out.keys, ek) and torch.equal(out.payloads, ep)):
        raise AssertionError("non-unique materialize: rows != plain route")


def wide_planes(n: int, gen: torch.Generator, dev: torch.device):
    """Sorted (hi, lo_biased) planes of n int64 keys drawn from 2^20 values
    spread over the int64 range, so that the hi plane varies and keys
    repeat; and the sorted int64 keys."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    pool = torch.randint(-(2**62), 2**62, (1 << 20,), generator=gen,
                         dtype=torch.int64, device=dev)
    keys = torch.sort(pool[torch.randint(0, 1 << 20, (n,), generator=gen,
                                         device=dev)]).values
    return (*sort_ops.unpack_pairs(keys), keys)


def phase_pair_merge_kernels(dev: torch.device, times: Timings) -> None:
    """Exactness of K6 and K7 against their plain versions; then their
    times at the main paths' shapes."""
    from avx_sort_merge_joins_tpu_torch.ops import join64, mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    rng = np.random.default_rng(20261018)
    for case, host in key_cases(CHECK_N, rng).items():
        k, p = (torch.from_numpy(a).to(dev)
                for a in seeded_pairs(CHECK_N, rng, host))
        n = CHECK_N
        for fanin in (2, 4, 16):
            # two levels; the last group of each has fewer than fanin runs
            rk, rp = sort_ops.sort_blocks_pairs_plain(k, p, n, BLOCK)
            span, nruns = BLOCK, sort_ops.cdiv(n, BLOCK)
            for _ in range(2):
                lens = (nruns, n, span)
                want = mw.multiway_merge_plain(rk, fanin, lens, rp)
                record("K6", f"{case} fanin={fanin} span={span}",
                       mw.multiway_merge(rk, fanin, lens, rp)[0], want)
                (rk, rp), span, nruns = (want, span * fanin,
                                         sort_ops.cdiv(nruns, fanin))

    gen = torch.Generator(device=dev).manual_seed(19)
    for n in (MAIN_N, MAIN_N // 4):
        timed = n == MAIN_N
        keys = torch.randint(1, n + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        pays = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        rk, rp = sort_ops.sort_blocks_pairs(keys, pays, n)
        del keys, pays
        for level in mw.merge_levels(n, BLOCK):
            _, span, nruns, w = level
            lens = (nruns, n, span)
            got = mw.multiway_merge(rk, w, lens, rp)[0]
            want = mw.multiway_merge_plain(rk, w, lens, rp)
            record("K6", f"n={n} level={level}", got, want)
            del got
            if timed:
                check_corank_rows("K6", rk, rp, n, level)
                lib_in = padded_rows(sort_ops.pack_pairs(rk, rp), n,
                                     w * span, 2**63 - 1)
                ms = time_ms(lambda: mw.multiway_merge(rk, w, lens, rp))
                parts = merge_parts_ms(rk, rp, n, level)
                plain = time_ms(lambda: mw.multiway_merge_plain(rk, w, lens,
                                                                rp))
                library = time_ms(lambda: lib_in.sort(dim=1))
                del lib_in
                times.add("K6", ms, plain, library, 16 * n, n * math.log2(w))
                log(f"[time] K6 level (stride, span, nruns, w)={level}: "
                    f"kernel {ms:.3f} ms (co-rank {parts['corank']:.3f}, "
                    f"of it coarse {parts['coarse']:.3f}, fine "
                    f"{parts['fine']:.3f}; merge {parts['merge']:.3f}), "
                    f"plain {plain:.3f} ms, library "
                    f"{library:.3f} ms, bound "
                    f"{bound_ms(16 * n, n * math.log2(w))[0]:.3f} ms")
            rk, rp = want
        del rk, rp, want
    log(f"[time] K6 all levels of an n={MAIN_N} pair sort: "
        f"{times.entry('K6')}")

    # K7: a varying hi plane, with the torch.sort count as a third opinion
    n = CHECK_N
    rhi, rlo, r64 = wide_planes(n, gen, dev)
    shi, slo, s64 = wide_planes(n // 2, gen, dev)
    # the two sides draw from different pools: make them share keys
    shi, slo, s64 = (torch.cat([a[:n // 4], b[:n // 2 - n // 4]])
                     for a, b in ((rhi, shi), (rlo, slo), (r64, s64)))
    s64, order = torch.sort(s64)
    shi, slo = shi[order].contiguous(), slo[order].contiguous()
    got = mergejoin.merge_join_count_fused64(rhi, rlo, shi, slo, n, n // 2)
    record("K7", "wide_keys", got, mergejoin.merge_join_count_fused64_plain(
        rhi, rlo, shi, slo, n, n // 2))
    base = int(join64.merge_join_count_torch64(r64, s64))
    if int(got) != base or base < n // 4:
        raise AssertionError(f"K7 wide keys: {int(got)} != baseline {base}")
    # each plane in turn a view at a 4-byte offset: the kernel's 16-byte
    # copies need all four planes 16-byte aligned, else it copies 4 bytes
    # at a time
    planes = [rhi, rlo, shi, slo]
    for q, what in enumerate(("R hi", "R lo", "S hi", "S lo")):
        moved = list(planes)
        moved[q] = torch.empty(planes[q].numel() + 1, dtype=torch.int32,
                               device=dev)[1:].copy_(planes[q])
        if moved[q].data_ptr() % 16 == 0:
            raise AssertionError("K7 offset view: still 16-byte aligned")
        got = mergejoin.merge_join_count_fused64(*moved, n, n // 2)
        record("K7", f"wide_keys, {what} at a 4-byte offset", got,
               mergejoin.merge_join_count_fused64_plain(*moved, n, n // 2))
        if int(got) != base:
            raise AssertionError(f"K7 {what} at a 4-byte offset: "
                                 f"{int(got)} != baseline {base}")
    del planes, moved
    # one 64-bit key 100,000 times in R and 200,000 times in S, between
    # other keys: its run crosses many of K7's CTAs (30,720 merged
    # elements each)
    hot = r64[n // 3].reshape(1)
    r64h = torch.sort(torch.cat([r64[:50_000], hot.expand(100_000)])).values
    s64h = torch.sort(torch.cat([r64[:70_000:2], hot.expand(200_000)])).values
    got = mergejoin.merge_join_count_fused64(
        *sort_ops.unpack_pairs(r64h), *sort_ops.unpack_pairs(s64h),
        r64h.numel(), s64h.numel())
    record("K7", "hot key over many CTAs", got,
           mergejoin.merge_join_count_fused64_plain(
               *sort_ops.unpack_pairs(r64h), *sort_ops.unpack_pairs(s64h),
               r64h.numel(), s64h.numel()))
    base = int(join64.merge_join_count_torch64(r64h, s64h))
    if int(got) != base or base < 100_000 * 200_000:
        raise AssertionError(f"K7 hot key over many CTAs: {int(got)} != "
                             f"baseline {base}")
    del r64h, s64h
    # equal hi planes with different lo planes never match, also where
    # the tiles have their edges
    even = torch.arange(0, 2 * n, 2, dtype=torch.int32, device=dev)
    same_hi = torch.full_like(even, -3)
    record("K7", "no_matches", mergejoin.merge_join_count_fused64(
        same_hi, even, same_hi, even + 1, n, n),
        mergejoin.merge_join_count_fused64_plain(same_hi, even, same_hi,
                                                 even + 1, n, n))
    hot = torch.full((1 << 16,), 7, dtype=torch.int32, device=dev)
    got = mergejoin.merge_join_count_fused64(hot, -hot, hot, -hot, 1 << 16,
                                             1 << 16)
    record("K7", "hot_key_2^32", got,
           mergejoin.merge_join_count_fused64_plain(hot, -hot, hot, -hot,
                                                    1 << 16, 1 << 16))
    if int(got) != 1 << 32:
        raise AssertionError(f"K7 hot key: {int(got)} != 2^32")
    del rhi, rlo, r64, shi, slo, s64, even, same_hi

    # 128M x 128M: the KEY_8B path's planes (int32 keys widened)
    rhi, rlo = join64.widen32(torch.arange(1, MAIN_N + 1, dtype=torch.int32,
                                           device=dev))
    shi, slo = join64.widen32(torch.sort(torch.randint(
        1, MAIN_N + 1, (MAIN_N,), generator=gen, dtype=torch.int32,
        device=dev)).values)
    got = mergejoin.merge_join_count_fused64(rhi, rlo, shi, slo, MAIN_N,
                                             MAIN_N)
    record("K7", "main_shape", got, mergejoin.merge_join_count_fused64_plain(
        rhi, rlo, shi, slo, MAIN_N, MAIN_N))
    if int(got) != MAIN_N:
        raise AssertionError(f"K7 main shape: {int(got)} != {MAIN_N}")
    # no one PyTorch call computes the count: no library yardstick
    times.add("K7",
              time_ms(lambda: mergejoin.merge_join_count_fused64(
                  rhi, rlo, shi, slo, MAIN_N, MAIN_N)),
              time_ms(lambda: mergejoin.merge_join_count_fused64_plain(
                  rhi, rlo, shi, slo, MAIN_N, MAIN_N)),
              None, 16 * MAIN_N + 8, 2 * MAIN_N)
    log(f"[time] K7 count {MAIN_N} x {MAIN_N}: {times.entry('K7')}")


def merge_check(case: str, keys: torch.Tensor, pays, fanin: int,
                uniform_lens=None, lens=None, stride=None,
                tile: int = MERGE_TILE) -> None:
    """Hold one K2 (``pays`` None) or K6 call, uniform or varlen, at merge
    tiles of ``tile`` outputs, against its plain version: every slot of
    the merged columns and, varlen, the group lengths."""
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw

    kid = "K2" if pays is None else "K6"
    if tile != MERGE_TILE:
        case = f"tile={tile} {case}"
    if lens is None:
        got = mw.multiway_merge(keys, fanin, uniform_lens, pays,
                                tile=tile)[0]
        want = mw.multiway_merge_plain(keys, fanin, uniform_lens, pays)
    else:
        got, glens = mw.multiway_merge(keys, fanin, payloads=pays, lens=lens,
                                       stride=stride, tile=tile)
        want, wlens = mw.multiway_merge_varlen_plain(keys, fanin, lens,
                                                     stride, pays)
        got = (*(got if pays is not None else (got,)), glens)
        want = (*(want if pays is not None else (want,)), wlens)
    record(kid, case, got, want)


def sorted_runs(keys: torch.Tensor, pays, n: int, span: int):
    """keys[:n] (with pays) as ascending runs of ``span``: a merge level's
    input."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    if pays is None:
        return sort_ops.sorted_groups(keys, n, span), None
    return sort_ops.unpack_pairs(sort_ops.sorted_groups(
        sort_ops.pack_pairs(keys, pays), n, span))


def strips(lens: list[int], stride: int, keys: torch.Tensor, pays):
    """A landing of len(lens) strips of ``stride`` slots: strip r holds
    the first lens[r] elements of its slice of keys (with pays), ascending,
    then pads; and lens as an int32 tensor."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    dev = keys.device
    nr = len(lens)
    tl = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = torch.arange(stride, device=dev) < tl[:, None]
    if pays is None:
        col = keys[:nr * stride].view(nr, stride)
        return (torch.where(live, col, KEY_INF).sort(dim=1).values
                .reshape(-1), None, tl)
    col = sort_ops.pack_pairs(keys[:nr * stride],
                              pays[:nr * stride]).view(nr, stride)
    k, p = sort_ops.unpack_pairs(torch.where(live, col, 2**63 - 1).sort(
        dim=1).values.reshape(-1))
    return k, p, tl


def edge_columns(n: int, case: str, gen: torch.Generator,
                 dev: torch.device):
    """n seeded keys and payloads: "uniform" over the whole key domain,
    or "domain_ends": keys at +-(2^31 - 2) and next to them, payloads
    equal to INT32_MAX and INT32_MIN."""
    if case == "uniform":
        k = torch.randint(-DOMAIN_MAX, DOMAIN_MAX + 1, (n,), generator=gen,
                          dtype=torch.int32, device=dev)
        p = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                          dtype=torch.int32, device=dev)
        return k, p
    pick = torch.randint(0, 4, (2, n), generator=gen, device=dev)
    k = torch.tensor([-DOMAIN_MAX, -DOMAIN_MAX + 1, DOMAIN_MAX - 1,
                      DOMAIN_MAX], dtype=torch.int32, device=dev)[pick[0]]
    p = torch.tensor([-2**31, -1, 0, KEY_INF], dtype=torch.int32,
                     device=dev)[pick[1]]
    return k, p


def phase_merge_edges(dev: torch.device) -> None:
    """K2 and K6 against their plain versions, exact, where the merge-path
    tiles have their edges: group totals of T - 1, T, T + 1 and 3T + 7
    (T = MERGE_TILE) at fan-in 2, 4, 8, 16, uniform and varlen, keys
    uniform or at the domain's ends; one hot key in every run over many
    tiles (keys, identical pairs, pairs that differ only in payload);
    the varlen K6 at dist_materialize's landing (8 strips of DIST_CAP)
    and at fan-in 2, 4, 16 with an odd stride."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(41)
    rng = np.random.default_rng(41)
    for case in ("uniform", "domain_ends"):
        for fanin in (2, 4, 8, 16):
            for per_group in EDGE_TOTALS:
                k, p = edge_columns(4 * fanin * per_group, case, gen, dev)
                # uniform: one full group of fanin runs of span, then one
                # of per_group keys in ragged runs
                span = -(-per_group // fanin)
                n = fanin * span + per_group
                for pays in (None, p):
                    rk, rp = sorted_runs(k, pays, n, span)
                    merge_check(f"{case} fanin={fanin} span={span} n={n}",
                                rk, rp, fanin,
                                uniform_lens=(-(-n // span), n, span))
                # varlen: two groups of per_group keys, ragged and empty
                lens = []
                for _ in range(2):
                    cut = np.sort(rng.integers(0, per_group + 1, fanin - 1))
                    lens += np.diff([0, *cut, per_group]).tolist()
                for pays in (None, p):
                    lk, lp, tl = strips(lens, per_group, k, pays)
                    merge_check(f"{case} varlen fanin={fanin} per group "
                                f"{per_group}", lk, lp, fanin, lens=tl,
                                stride=per_group)
    span = 8 * MERGE_TILE  # hot key: every boundary inside a tie
    for fanin in (2, 16):
        n = 2 * fanin * span
        k = torch.full((n,), 5, dtype=torch.int32, device=dev)
        variants = {"keys": None,
                    "same_pairs": torch.full_like(k, -7),
                    "payload_only": torch.randint(-3, 4, (n,), generator=gen,
                                                  dtype=torch.int32,
                                                  device=dev)}
        variants["payload_only"][::5] = KEY_INF
        variants["payload_only"][::7] = -2**31
        for name, pays in variants.items():
            for mixed in (False, True):
                kk = k.clone()
                if mixed:  # the hot key between others
                    kk[::3] = torch.randint(-9, 9, (kk[::3].numel(),),
                                            generator=gen, dtype=torch.int32,
                                            device=dev)
                rk, rp = sorted_runs(kk, pays, n - 11, span)
                merge_check(f"hot key {name} mixed={mixed} fanin={fanin}",
                            rk, rp, fanin,
                            uniform_lens=(2 * fanin, n - 11, span))
    # the varlen K6 at dist_materialize's landing, then odd strides
    for fanin, stride in ((DIST_SHARDS, DIST_CAP), (2, VARLEN_STRIDE),
                          (4, VARLEN_STRIDE), (16, VARLEN_STRIDE)):
        nr = fanin if stride == DIST_CAP else 2 * fanin
        lens = rng.integers(0, stride + 1, nr).tolist()
        lens[0], lens[-1], lens[nr // 2] = 0, stride, 1
        k = torch.randint(-50_000, 50_000, (nr * stride,), generator=gen,
                          dtype=torch.int32, device=dev)
        p = torch.randint(-2**31, 2**31 - 1, (nr * stride,), generator=gen,
                          dtype=torch.int32, device=dev)
        p[::97], p[::89] = KEY_INF, -2**31
        lk, lp, tl = strips(lens, stride, k, p)
        spare = torch.full((99,), KEY_INF, dtype=torch.int32, device=dev)
        merge_check(f"varlen fanin={fanin} stride={stride} lens={lens}",
                    torch.cat([lk, spare]), torch.cat([lp, spare]), fanin,
                    lens=tl, stride=stride)
        del k, p, lk, lp
    log(f"[edges] K2 and K6 at the tile edges, on a hot key and varlen: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_merge_tiles(dev: torch.device) -> None:
    """The keys-only K2 at each tile ``-m`` can name besides the default
    (NEW_MERGE_TILES), against its plain version, exact: group totals of
    T - 1, T, T + 1 and 3T + 7 at fan-in 2, 4, 8 and 16, uniform and
    varlen, keys uniform or at the domain's ends, and one hot key in every
    run over many tiles; then fan-in 2,048 (MAX_FANIN) at every tile,
    uniform and varlen.  Each tile's launches are counted apart; the four
    K2 levels of a 128M sort are timed at every tile."""
    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(43)
    rng = np.random.default_rng(43)
    before = _build.launches()
    for tile in NEW_MERGE_TILES:
        for case in ("uniform", "domain_ends"):
            for fanin in (2, 4, 8, 16):
                for per_group in (tile - 1, tile, tile + 1, 3 * tile + 7):
                    k, _ = edge_columns(4 * fanin * per_group, case, gen,
                                        dev)
                    span = -(-per_group // fanin)
                    n = fanin * span + per_group
                    rk, _ = sorted_runs(k, None, n, span)
                    merge_check(f"{case} fanin={fanin} span={span} n={n}",
                                rk, None, fanin,
                                uniform_lens=(-(-n // span), n, span),
                                tile=tile)
                    lens = []
                    for _ in range(2):
                        cut = np.sort(rng.integers(0, per_group + 1,
                                                   fanin - 1))
                        lens += np.diff([0, *cut, per_group]).tolist()
                    lk, _, tl = strips(lens, per_group, k, None)
                    merge_check(f"{case} varlen fanin={fanin} per group "
                                f"{per_group}", lk, None, fanin, lens=tl,
                                stride=per_group, tile=tile)
        span = 8 * tile  # hot key: every boundary inside a tie
        for fanin in (2, 16):
            n = 2 * fanin * span
            for mixed in (False, True):
                kk = torch.full((n,), 5, dtype=torch.int32, device=dev)
                if mixed:
                    kk[::3] = torch.randint(-9, 9, (kk[::3].numel(),),
                                            generator=gen, dtype=torch.int32,
                                            device=dev)
                rk, _ = sorted_runs(kk, None, n - 11, span)
                merge_check(f"hot key mixed={mixed} fanin={fanin}", rk, None,
                            fanin, uniform_lens=(2 * fanin, n - 11, span),
                            tile=tile)
    fanin = mw.MAX_FANIN
    for tile in mw.MERGE_TILES:
        span = 3
        n = fanin * span - 2
        k = torch.randint(-1000, 1000, (2 * n,), generator=gen,
                          dtype=torch.int32, device=dev)
        rk, _ = sorted_runs(k, None, n, span)
        merge_check(f"fanin={fanin} span={span} n={n}", rk, None, fanin,
                    uniform_lens=(-(-n // span), n, span), tile=tile)
        stride = 2 * tile + 3
        lens = rng.integers(0, stride + 1, fanin).tolist()
        lens[0], lens[-1] = 0, stride
        lk, _, tl = strips(lens, stride, torch.randint(
            -10**6, 10**6, (fanin * stride,), generator=gen,
            dtype=torch.int32, device=dev), None)
        merge_check(f"varlen fanin={fanin} stride={stride}", lk, None, fanin,
                    lens=tl, stride=stride, tile=tile)
    torch.cuda.synchronize()
    after = _build.launches()
    launched = {t: after[f"K2.tile{t}"] - before[f"K2.tile{t}"]
                for t in mw.MERGE_TILES}
    if min(launched.values()) <= 0:
        raise AssertionError(f"K2 tiles launched {launched}")
    # the K2 levels of a 128M sort's default plan at each tile
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    keys = torch.randint(-DOMAIN_MAX, DOMAIN_MAX + 1, (MAIN_N,),
                         generator=gen, dtype=torch.int32, device=dev)
    blocks = sort_ops.sort_blocks(keys, MAIN_N, BLOCK)
    levels = mw.merge_levels(MAIN_N, BLOCK)
    want = None
    for tile in mw.MERGE_TILES:
        def sort_levels(tile=tile):
            ks = blocks
            for level in levels:
                ks = mw.merge_level(ks, MAIN_N, level, tile=tile)
            return ks
        got = sort_levels()
        want = got if want is None else want
        if not torch.equal(got, want):
            raise AssertionError(f"K2 levels at tile {tile} differ")
        log(f"[time] K2 tile={tile} the {len(levels)} levels of a "
            f"{MAIN_N}-key sort: {time_ms(sort_levels):.3f} ms")
    log(f"[tiles] K2 at tiles {list(mw.MERGE_TILES)} (launches {launched}), "
        f"fan-in up to {fanin}: {time.perf_counter() - t0:.1f} s")


def phase_cli_m() -> dict[str, int]:
    """``-a m-way -m BYTES`` through the CLI at 128M for a budget that
    names each tile (MWAY_M_BUDGETS): ``Results = 128000000``, the tile
    line, and every K2 launch of the run at that tile."""
    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw

    total = {k: 0 for k in KERNELS}
    for tile, budget in MWAY_M_BUDGETS.items():
        if mw.merge_tile_for(budget, 16) != tile:
            raise AssertionError(f"-m {budget}: not tile {tile}")
        argv = ["-a", "m-way", "-m", str(budget), "-r", str(MAIN_N), "-s",
                str(MAIN_N)]
        reset_launches()
        t0 = time.perf_counter()
        rc, stdout, stderr = run_cli_full(argv)
        torch.cuda.synchronize()
        counts = launches()
        at = {t: _build.launches()[f"K2.tile{t}"] for t in mw.MERGE_TILES}
        rec = re.search(r"^\[STATS\] NUMTUPLES \d+, TOTAL-TIME-USECS "
                        r"([\d.]+)", stderr, re.M)
        log(f"[-m] cli.main({argv}) -> rc {rc} in "
            f"{time.perf_counter() - t0:.3f} s; join "
            f"{rec.group(1) if rec else '?'} us; K2 launches by tile {at}")
        if rc != 0 or results_of(stdout) != MAIN_N:
            raise AssertionError(f"-m {budget}: rc {rc}, {stdout!r}")
        if f"K2 merge tile {tile} outputs" not in stderr:
            raise AssertionError(f"-m {budget}: no tile line")
        if at[tile] != counts["K2"] or counts["K2"] <= 0:
            raise AssertionError(f"-m {budget}: K2 {counts['K2']}, by tile "
                                 f"{at}")
        check_launched(f"-m {budget}", counts, ("K1", "K2", "K3"))
        for k, v in counts.items():
            total[k] += v
    return total


def merge_pass_check(case: str, keys: torch.Tensor, pays,
                     descending: bool = False, uniform_lens=None,
                     lens=None, stride=None) -> None:
    """Hold one K4 call, uniform or varlen, against its plain version:
    every slot of the merged columns and, varlen, the new lens."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    if lens is None:
        got = sort_ops.merge_pass(keys, pays, uniform_lens, descending)
        want = sort_ops.merge_pass_plain(keys, pays, uniform_lens,
                                         descending)
    else:
        got = sort_ops.merge_pass(keys, pays, lens=lens, stride=stride)
        want = sort_ops.merge_pass_plain(keys, pays, lens=lens,
                                         stride=stride)
    record("K4", case, tuple(g for g in got if g is not None),
           tuple(w for w in want if w is not None))


def directed_runs(keys: torch.Tensor, pays, n: int, span: int,
                  descending: bool):
    """keys[:n] (with pays) as runs of ``span`` sorted in the pass's
    direction, pads after: a K4 pass's input."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    packed = sort_ops.pack_pairs(keys, torch.zeros_like(keys) if pays is None
                                 else pays)
    k, p = sort_ops.unpack_pairs(sort_ops.sorted_groups(packed, n, span,
                                                        descending))
    return k, (None if pays is None else p)


def phase_k4_edges(dev: torch.device) -> None:
    """K4 against its plain version, exact, where its tiles and CTAs have
    their edges: run A of 1, T - 1, T, T + 1, C - 1, C and C + 1 elements (T
    = K4_TILE, C = K4_CTA) against a B run that is empty, of 1, of T or as
    long as A, and an empty pass; keys over the whole domain or at its
    ends; one hot key over many tiles and CTAs (keys, identical pairs,
    pairs that differ only in payload, and between other keys); both
    directions, keys and pairs.  Then the varlen mode: random lens up to
    the stride with empty runs, a full run and a zero-length run that pads
    the run count to an even one (as dist_mpass pads a shard count), at
    strides of 1, T + 1, 100,003 and DIST_CAP, keys and pairs."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(43)
    rng = np.random.default_rng(43)
    for case in ("uniform", "domain_ends"):
        for span in K4_SPANS:
            for lb in sorted({0, 1, min(K4_TILE, span), span}):
                n = span + lb
                k, p = edge_columns(n, case, gen, dev)
                for pays in (None, p):
                    for desc in (False, True):
                        rk, rp = directed_runs(k, pays, n, span, desc)
                        merge_pass_check(
                            f"{case} A={span} B={lb} pairs={pays is not None}"
                            f" descending={desc}", rk, rp, desc,
                            uniform_lens=(-(-n // span), n, span))
    k, p = edge_columns(K4_TILE, "uniform", gen, dev)
    for desc in (False, True):
        merge_pass_check(f"no element descending={desc}", k, p, desc,
                         uniform_lens=(1, 0, K4_TILE))
    span = 3 * K4_CTA + 5  # hot key: every boundary inside a tie
    n = 4 * span - 7
    k = torch.full((n,), -4, dtype=torch.int32, device=dev)
    variants = {"keys": None, "same_pairs": torch.full_like(k, 9),
                "payload_only": torch.randint(-3, 4, (n,), generator=gen,
                                              dtype=torch.int32, device=dev)}
    variants["payload_only"][::5] = KEY_INF
    variants["payload_only"][::7] = -2**31
    for name, pays in variants.items():
        for mixed in (False, True):
            kk = k.clone()
            if mixed:  # the hot key between others
                kk[::3] = torch.randint(-9, 9, (kk[::3].numel(),),
                                        generator=gen, dtype=torch.int32,
                                        device=dev)
            for desc in (False, True):
                rk, rp = directed_runs(kk, pays, n, span, desc)
                merge_pass_check(f"hot key {name} mixed={mixed} "
                                 f"descending={desc}", rk, rp, desc,
                                 uniform_lens=(4, n, span))
    for stride in (1, K4_TILE + 1, 100_003, DIST_CAP):
        nr = DIST_SHARDS if stride == DIST_CAP else 10
        lens = rng.integers(0, stride + 1, nr).tolist()
        lens[1], lens[nr // 2], lens[nr - 2], lens[nr - 1] = 0, 0, stride, 0
        k, p = edge_columns(nr * stride, "uniform", gen, dev)
        for pays in (None, p):
            lk, lp, tl = strips(lens, stride, k, pays)
            merge_pass_check(f"varlen stride={stride} pairs={pays is not None}"
                             f" lens={lens}", lk, lp, lens=tl, stride=stride)
        del k, p, lk, lp
    log(f"[edges] K4 at the tile and CTA edges, on a hot key and varlen: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_k4_varlen_shape(dev: torch.device, buckets, cap: int) -> None:
    """The varlen K4 at the 8-shard 128M x 128M join's landing of R: every
    shard's received strips (DIST_SHARDS x DIST_SHARDS runs of ``cap``
    slots, 128M live keys) merged pairwise in one pass, the first pass
    dist_mpass would give it, exact against its plain version; timed
    beside a uniform pass over 128M keys in runs of K4_UNIFORM_SPAN."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(DIST_SHARDS, dev)
    bflat, rcounts = buckets[0]  # the counts each shard receives
    land = mesh.all_to_all(bflat).reshape(-1)
    lens = rcounts.reshape(-1).contiguous()
    live = int(lens.sum())
    merge_pass_check(f"varlen 8-shard landing: {lens.numel()} runs of {cap}, "
                     f"{live} keys", land, None, lens=lens, stride=cap)
    ms = time_ms(lambda: sort_ops.merge_pass(land, None, lens=lens,
                                             stride=cap))
    plain = time_ms(lambda: sort_ops.merge_pass_plain(land, None, lens=lens,
                                                      stride=cap))
    bound = bound_ms(4 * live + 4 * land.numel(), live)[0]
    log(f"[time] K4 varlen pass, {lens.numel()} runs of {cap} slots, {live} "
        f"keys: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound:.3f} "
        f"ms (live keys read, every slot written)")
    del land
    gen = torch.Generator(device=dev).manual_seed(47)
    runs = sort_ops.sorted_groups(torch.randint(
        1, MAIN_N + 1, (MAIN_N,), generator=gen, dtype=torch.int32,
        device=dev), MAIN_N, K4_UNIFORM_SPAN)
    ulens = (sort_ops.cdiv(MAIN_N, K4_UNIFORM_SPAN), MAIN_N, K4_UNIFORM_SPAN)
    merge_pass_check(f"uniform span={K4_UNIFORM_SPAN} n={MAIN_N}", runs, None,
                     uniform_lens=ulens)
    ms = time_ms(lambda: sort_ops.merge_pass(runs, None, ulens))
    log(f"[time] K4 uniform pass beside it, span {K4_UNIFORM_SPAN}, {MAIN_N} "
        f"keys: kernel {ms:.3f} ms, bound "
        f"{bound_ms(8 * MAIN_N, MAIN_N)[0]:.3f} ms")


def phase_materialize_in_process(dev: torch.device) -> dict[str, int]:
    """The 128M materializing join through ``sortmergejoin_multiway``: the
    output relation against the plain route's, row for row."""
    from avx_sort_merge_joins_tpu_torch import cli
    from avx_sort_merge_joins_tpu_torch.models.mway import \
        sortmergejoin_multiway
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.types import JoinConfig

    args = cli.build_parser().parse_args(["-r", str(MAIN_N), "-s",
                                          str(MAIN_N)])
    R, S = cli.make_relations(args, dev)
    torch.cuda.synchronize()
    reset_launches()
    res = sortmergejoin_multiway(R, S, JoinConfig(materialize=True))
    torch.cuda.synchronize()
    counts = launches()
    out = res.resultlist[0].results
    secs = res.phases["total"]
    log(f"[materialize] sortmergejoin_multiway(materialize=True) "
        f"{MAIN_N} x {MAIN_N}: {res.totalresults} results, "
        f"{out.num_tuples} output rows in {secs * 1e3:.3f} ms "
        f"({(2 * MAIN_N) / secs:.0f} tuples/s, "
        f"{out.num_tuples / secs:.0f} output rows/s); launches {counts}")
    check_launched("materialize (in process)", counts,
                   PATHS["materialize"][1])
    if not res.totalresults == out.num_tuples == MAIN_N:
        raise AssertionError(f"materialize: {res.totalresults} results, "
                             f"{out.num_tuples} rows != {MAIN_N}")
    del R
    # R is the primary key 1..|R|: every S tuple matches exactly once
    wk, wp = sort_ops.sort_torch(S.keys, S.payloads)
    if not (torch.equal(out.keys, wk) and torch.equal(out.payloads, wp)):
        raise AssertionError("materialize: output relation != plain route")
    log("[materialize] output relation equals sort_torch(S) row for row")
    return counts


def phase_persist(dev: torch.device) -> None:
    """``--materialize --persist`` at 1M x 1M: the three files, and Out.tbl
    read back against the output relation of the same join in process."""
    from avx_sort_merge_joins_tpu_torch import cli, datagen

    argv = ["-a", "m-way", "--materialize", "-r", str(PERSIST_N), "-s",
            str(PERSIST_N)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, stdout = run_cli([*argv, "--persist", tmp])
        secs = time.perf_counter() - t0
        if rc != 0 or results_of(stdout) != PERSIST_N:
            raise AssertionError(f"persist: rc {rc}, {stdout!r}")
        sizes = {}
        for name in ("R.tbl", "S.tbl", "Out.tbl"):
            path = os.path.join(tmp, name)
            if not os.path.isfile(path):
                raise AssertionError(f"persist: {name} missing")
            sizes[name] = os.path.getsize(path)
        back = datagen.read_relation(os.path.join(tmp, "Out.tbl"),
                                     device=dev)
    args = cli.build_parser().parse_args(argv)
    out = cli.run_join(args, *cli.make_relations(args, dev)) \
        .resultlist[0].results
    log(f"[persist] {PERSIST_N} x {PERSIST_N} in {secs:.3f} s (generation, "
        f"join and writes), bytes {sizes}; Out.tbl holds "
        f"{back.num_tuples} rows")
    if back.num_tuples != PERSIST_N or not (
            torch.equal(back.keys, out.keys)
            and torch.equal(back.payloads, out.payloads)):
        raise AssertionError("persist: Out.tbl != the output relation")


def phase_key8b_scalar() -> None:
    """``--key8b --scalarsort`` against the kernel route at 16M x 16M."""
    argv = ["--key8b", "-r", str(KEY8B_SCALAR_N), "-s", str(KEY8B_SCALAR_N)]
    counts = []
    for extra in ([], ["--scalarsort"]):
        rc, stdout = run_cli([*argv, *extra])
        if rc != 0:
            raise AssertionError(f"key8b {extra}: exit code {rc}")
        counts.append(results_of(stdout))
    log(f"[key8b] {KEY8B_SCALAR_N} x {KEY8B_SCALAR_N}: kernel route "
        f"{counts[0]}, --scalarsort {counts[1]}")
    if not counts[0] == counts[1] == KEY8B_SCALAR_N:
        raise AssertionError(f"key8b counts {counts} != {KEY8B_SCALAR_N}")


def domain_keys(n: int, rng: np.random.Generator) -> np.ndarray:
    """Keys over the whole domain with both of its ends among them."""
    keys = rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, n).astype(np.int32)
    keys[:4] = [-DOMAIN_MAX, -DOMAIN_MAX + 1, DOMAIN_MAX - 1, DOMAIN_MAX]
    return keys


def phase_hist_kernels(dev: torch.device, times: Timings) -> None:
    """Exactness of K8 (per tile and global) against its plain version at
    every fanout and shift, on a one-bin tile and at 128M keys, uniform and
    Zipf; the 128M calls timed beside the plain version and
    ``torch.bincount``."""
    from avx_sort_merge_joins_tpu_torch import datagen
    from avx_sort_merge_joins_tpu_torch.ops import partition as pt
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    def check(keys, bits, shift, case):
        want = pt.radix_hist_plain(keys, bits, shift)
        record("K8", f"{case} bits={bits} shift={shift} per tile + global",
               (pt.radix_hist(keys, bits, shift),
                pt.radix_hist_any(keys, bits, shift)),
               (want, want.sum(0, dtype=torch.int32)))

    keys = torch.from_numpy(domain_keys(
        HIST_CHECK_N, np.random.default_rng(20261019))).to(dev)
    for bits in range(1, 17):
        for shift in sorted({0, (31 - bits) // 2, 31 - bits}):
            check(keys, bits, shift, f"domain n={HIST_CHECK_N}")
    # 65,536 equal keys in one bin of one tile, then a ragged tile
    one_bin = torch.cat([torch.full((pt.HIST_TILE,), 12345, dtype=torch.int32,
                                    device=dev), keys[:777]])
    for bits in (1, 7, 16):
        check(one_bin, bits, 0, "one-bin tile")

    # 2^16 counts in 16-bit halves of 2^15 words: ids on both halves of
    # one word, on one low bin, on one high bin, so many that halves wrap
    # in every CTA of the global grid and in every one-bin tile
    gen = torch.Generator(device=dev).manual_seed(29)
    n = HIST_WRAP_N
    half = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    for case, k in (("one word's two bins", 1 + 2 * 777 + half),
                    ("one low bin", torch.full_like(half, 1 + 2 * 777)),
                    ("one high bin", torch.full_like(half, 2 + 2 * 777))):
        check(k, 16, 0, f"{case} n={n}")
    del half, k
    uniform = torch.randint(1, 2**26, (MAIN_N,), generator=gen,
                            dtype=torch.int32, device=dev)
    datagen.seed_generator(31)
    t0 = time.perf_counter()
    zipf = datagen.create_relation_zipf(MAIN_N, ZIPF_ALPHABET, 1.0,
                                        device=dev).keys
    log(f"[hist] host Zipf generation of {MAIN_N} keys over "
        f"{ZIPF_ALPHABET} values, z=1.0: {time.perf_counter() - t0:.1f} s")
    ntiles = sort_ops.cdiv(MAIN_N, pt.HIST_TILE)
    for dist, k in (("uniform", uniform), ("zipf", zipf)):
        for bits in HIST_BITS:
            check(k, bits, 0, f"{dist} n={MAIN_N}")
            fanout = 1 << bits
            tile_ms = time_ms(lambda: pt.radix_hist(k, bits))
            tile_plain = time_ms(lambda: pt.radix_hist_plain(k, bits))
            ms = time_ms(lambda: pt.radix_hist_any(k, bits))
            plain = time_ms(lambda: pt.radix_hist_plain(k, bits).sum(
                0, dtype=torch.int32))
            library = time_ms(lambda: torch.bincount(
                pt.partition_ids(k, bits), minlength=fanout))
            # the JSON row: the global histogram, summed over these calls
            times.add("K8", ms, plain, library, 4 * MAIN_N + 4 * fanout,
                      MAIN_N)
            tile_bound = bound_ms(4 * MAIN_N + 4 * ntiles * fanout, MAIN_N)
            log(f"[time] K8 {dist} n={MAIN_N} bits={bits}: per tile kernel "
                f"{tile_ms:.3f} ms, plain {tile_plain:.3f} ms, bound "
                f"{tile_bound[0]:.3f} ms; global kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, torch.bincount {library:.3f} ms, bound "
                f"{bound_ms(4 * MAIN_N + 4 * fanout, MAIN_N)[0]:.3f} ms")
    log(f"[time] K8 global histograms of {MAIN_N} keys, bits {HIST_BITS}, "
        f"uniform and Zipf, summed: {times.entry('K8')}")


def two_run_column(keys: torch.Tensor, span: int) -> torch.Tensor:
    """``keys`` as two ascending runs, ``[0, span)`` and ``[span, n)``."""
    return torch.cat([torch.sort(keys[:span]).values,
                      torch.sort(keys[span:]).values])


def phase_count2_kernel(dev: torch.device, times: Timings) -> None:
    """Exactness of K10 against its plain version at the 128M route's
    two-run shapes, with R's or S's run 1 empty, with S cut elsewhere than
    R, on runs of one key each, on keys at the domain's ends and on a hot
    key past 2^31; K10 timed there, beside four K3 launches over the same
    four run pairs and K3 on the same keys merged."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw

    levels, span, nruns = mw.merge_levels_2runs(MAIN_N, BLOCK, 16)
    log(f"[count2] merge_levels_2runs({MAIN_N}, {BLOCK}, 16): levels "
        f"{levels}, final span {span}, {nruns} runs")
    if nruns != 2 or span != COUNT2_SPAN:
        raise AssertionError(f"the {MAIN_N} schedule does not stop at two "
                             f"runs of span {COUNT2_SPAN}")
    gen = torch.Generator(device=dev).manual_seed(23)
    rk = two_run_column(torch.randperm(MAIN_N, generator=gen, device=dev)
                        .to(torch.int32) + 1, span)
    s_keys = torch.randint(1, MAIN_N + 1, (MAIN_N,), generator=gen,
                           dtype=torch.int32, device=dev)
    sk = two_run_column(s_keys, span)
    got = mergejoin.merge_join_count_fused2(rk, sk, MAIN_N, MAIN_N, span,
                                            span)
    record("K10", f"main_shape runs {span} + {MAIN_N - span}", got,
           mergejoin.merge_join_count_fused2_plain(rk, sk, MAIN_N, MAIN_N,
                                                   span, span))
    if int(got) != MAIN_N:
        raise AssertionError(f"K10 main shape: {int(got)} != {MAIN_N}")
    record("K10", f"R run 1 empty: {span} x {MAIN_N}",
           mergejoin.merge_join_count_fused2(rk, sk, span, MAIN_N, span,
                                             span),
           mergejoin.merge_join_count_fused2_plain(rk, sk, span, MAIN_N,
                                                   span, span))
    record("K10", f"S run 1 empty: {MAIN_N} x {span}",
           mergejoin.merge_join_count_fused2(rk, sk, MAIN_N, span, span,
                                             span),
           mergejoin.merge_join_count_fused2_plain(rk, sk, MAIN_N, span,
                                                   span, span))
    span_s = 64_000_000  # S cut elsewhere than R
    s_other = two_run_column(s_keys, span_s)
    record("K10", f"span_r {span} != span_s {span_s}: {MAIN_N} x {MAIN_N}",
           mergejoin.merge_join_count_fused2(rk, s_other, MAIN_N, MAIN_N,
                                             span, span_s),
           mergejoin.merge_join_count_fused2_plain(rk, s_other, MAIN_N,
                                                   MAIN_N, span, span_s))
    del s_other, s_keys
    # runs of one key: R's runs hold 5 and 6, S's 6 and 5 (2^43 matches)
    half = 1 << 21
    one = torch.cat([torch.full((half,), 5, dtype=torch.int32, device=dev),
                     torch.full((half,), 6, dtype=torch.int32, device=dev)])
    flip = one.flip(0).contiguous()
    got = mergejoin.merge_join_count_fused2(one, flip, 2 * half, 2 * half,
                                            half, half)
    record("K10", "runs of one key", got,
           mergejoin.merge_join_count_fused2_plain(one, flip, 2 * half,
                                                   2 * half, half, half))
    if int(got) != 2 * half * half:
        raise AssertionError(f"K10 runs of one key: {int(got)}")
    rng = np.random.default_rng(29)
    ends = [two_run_column(torch.from_numpy(rng.choice(
        [-DOMAIN_MAX, DOMAIN_MAX], n).astype(np.int32)).to(dev), sp)
        for n, sp in ((1_000_003, 600_000), (900_001, 500_000))]
    record("K10", "domain ends +-(2^31 - 2)",
           mergejoin.merge_join_count_fused2(*ends, 1_000_003, 900_001,
                                             600_000, 500_000),
           mergejoin.merge_join_count_fused2_plain(*ends, 1_000_003, 900_001,
                                                   600_000, 500_000))
    hot = torch.full((1 << 16,), 7, dtype=torch.int32, device=dev)
    got = mergejoin.merge_join_count_fused2(hot, hot, 1 << 16, 1 << 16,
                                            40_000, 1 << 15)
    record("K10", "hot_key_2^32", got,
           mergejoin.merge_join_count_fused2_plain(hot, hot, 1 << 16,
                                                   1 << 16, 40_000, 1 << 15))
    if int(got) != 1 << 32:
        raise AssertionError(f"K10 hot key: {int(got)} != 2^32")
    # no one PyTorch call computes the count: no library yardstick
    times.add("K10",
              time_ms(lambda: mergejoin.merge_join_count_fused2(
                  rk, sk, MAIN_N, MAIN_N, span, span)),
              time_ms(lambda: mergejoin.merge_join_count_fused2_plain(
                  rk, sk, MAIN_N, MAIN_N, span, span)),
              None, 8 * MAIN_N + 8, 4 * MAIN_N)
    pairs = [(r, s) for r in mergejoin._two_runs(rk, MAIN_N, span)
             for s in mergejoin._two_runs(sk, MAIN_N, span)]
    four = time_ms(lambda: [mergejoin.merge_join_count_fused(
        r, s, r.numel(), s.numel()) for r, s in pairs])
    del pairs
    rs, ss = torch.sort(rk).values, torch.sort(sk).values
    k3 = time_ms(lambda: mergejoin.merge_join_count_fused(rs, ss, MAIN_N,
                                                          MAIN_N))
    log(f"[time] K10 count {MAIN_N} x {MAIN_N} over two runs a side: "
        f"{times.entry('K10')}; four K3 launches over the same four run "
        f"pairs: {four:.3f} ms; K3 on the same keys merged: {k3:.3f} ms")


def phase_count2_route(dev: torch.device) -> dict[str, int]:
    """``_mway_count_device`` at 128M x 128M under SMJ_COUNT2=1 (K1 2, K2 6,
    K10 1, K3 0) and under SMJ_COUNT2=0 (K3 1, K10 0), each timed, then
    run once with the launch counts set to 0 just before it."""
    from avx_sort_merge_joins_tpu_torch import cli
    from avx_sort_merge_joins_tpu_torch.models import mway
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin

    args = cli.build_parser().parse_args(["-r", str(MAIN_N), "-s",
                                          str(MAIN_N)])
    R, S = cli.make_relations(args, dev)
    torch.cuda.synchronize()

    def join():
        return mway._mway_count_device(R.keys, S.keys, MAIN_N, MAIN_N, 16,
                                       BLOCK)

    want = {"1": {"K1": 2, "K2": 6, "K10": 1, "K3": 0},
            "0": {"K1": 2, "K2": 8, "K10": 0, "K3": 1}}
    total = {}
    before = os.environ.get("SMJ_COUNT2")
    try:
        for switch in ("1", "0"):
            os.environ["SMJ_COUNT2"] = switch
            ms = time_ms(join)
            reset_launches()
            count = mergejoin.finish_count_fused(join())
            torch.cuda.synchronize()
            counts = launches()
            log(f"[count2] _mway_count_device {MAIN_N} x {MAIN_N} "
                f"SMJ_COUNT2={switch}: {ms:.3f} ms (CUDA events, mean of "
                f"{REPS}), count {count}, launches {counts}")
            if count != MAIN_N:
                raise AssertionError(f"SMJ_COUNT2={switch}: {count} != "
                                     f"{MAIN_N}")
            bad = {k: counts[k] for k, v in want[switch].items()
                   if counts[k] != v}
            if bad:
                raise AssertionError(f"SMJ_COUNT2={switch}: launches {bad}, "
                                     f"want {want[switch]}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        if before is None:
            os.environ.pop("SMJ_COUNT2", None)
        else:
            os.environ["SMJ_COUNT2"] = before
    return total


def run_module(module: str, argv: list[str]) -> str:
    """Run ``avx_sort_merge_joins_tpu_torch.bench.<module>.main(argv)`` in
    the process; echo its output; raise unless it returns 0; return its
    stdout."""
    import importlib

    main_ = importlib.import_module(
        f"avx_sort_merge_joins_tpu_torch.bench.{module}").main
    out, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        rc = main_(argv)
    for line in (errs.getvalue() + out.getvalue()).splitlines():
        log(f"[{module}] {line}")
    if rc != 0:
        raise AssertionError(f"{module} {argv}: exit code {rc}")
    return out.getvalue()


def phase_partitioning() -> dict[str, int]:
    """The partitioning grid: every variant at 8,388,608 tuples for bits
    2..16, and ``hist`` at 128M for bits 7 and 14; each row's histogram is
    checked inside the bench against ``radix_hist_torch`` and the
    partition against ``radix_cluster_numpy``."""
    reset_launches()
    t0 = time.perf_counter()
    for bits in PART_BITS:
        rows = run_module("partitioningbench", [str(PART_N), "all",
                                                str(bits)]).split("\n")
        if len([r for r in rows if r.strip()]) != 5:
            raise AssertionError(f"partitioningbench bits={bits}: {rows}")
    for bits in PART_BIG_BITS:
        run_module("partitioningbench", [str(MAIN_N), "hist", str(bits)])
    torch.cuda.synchronize()
    counts = launches()
    log(f"[partitioning] grid in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    check_launched("partitioning grid", counts, ("K8",))
    return counts


def phase_benches() -> dict[str, int]:
    """The other micro-benchmarks once each at their JAX defaults; each
    checks its own output and prints its record line."""
    reset_launches()
    t0 = time.perf_counter()
    for module, argv in BENCHES:
        if not run_module(module, argv).strip():
            raise AssertionError(f"{module} {argv}: no record line")
    torch.cuda.synchronize()
    counts = launches()
    log(f"[benches] {len(BENCHES)} runs in {time.perf_counter() - t0:.1f} "
        f"s; launches {counts}")
    check_launched("benches", counts, ("K1", "K2", "K3", "K4", "K5", "K6"))
    return counts


def phase_zipf(dev: torch.device) -> None:
    """``-z 1.0`` at 16M x 16M: ``-a m-way`` through the CLI, and the m-way
    and mpsm joins of the CLI's relations, against the torch.sort
    baseline."""
    from avx_sort_merge_joins_tpu_torch import cli
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin

    argv = ["-r", str(ZIPF_N), "-s", str(ZIPF_N), "-z", "1.0"]
    rc, stdout = run_cli(["-a", "m-way", *argv])
    if rc != 0:
        raise AssertionError(f"-z 1.0: exit code {rc}")
    counts = {"cli m-way": results_of(stdout)}
    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    R, S = cli.make_relations(args, dev)
    torch.cuda.synchronize()
    log(f"[zipf] relations of {ZIPF_N} x {ZIPF_N}, S Zipf z=1.0 over "
        f"{ZIPF_N} values: {time.perf_counter() - t0:.1f} s on the host")
    for algo in ("m-way", "mpsm"):
        args.algo = algo
        res = cli.run_join(args, R, S)
        counts[algo] = res.totalresults
        log(f"[zipf] {algo}: Results = {res.totalresults}, phases "
            f"{ {k: round(v * 1e3, 3) for k, v in res.phases.items()} } ms")
    base = int(mergejoin.merge_join_count_torch(
        torch.sort(R.keys).values, torch.sort(S.keys).values, ZIPF_N,
        ZIPF_N))
    log(f"[zipf] counts {counts}, torch.sort baseline {base}")
    if any(c != base for c in counts.values()) or base != ZIPF_N:
        raise AssertionError(f"-z 1.0: counts {counts} != baseline {base}")


def dist_landings(dev: torch.device):
    """Shard 0's received runs of R and S in the 128M x 128M distributed
    m-way join over 8 shards (the CLI's relations, made on the card): the
    landing buffers and lens that K9 and the varlen K2 get on that path;
    shard 0's 16M-key R shard before its sort; and every shard's buckets
    of R and S with their received counts, what K11 gets on the "dma"
    path."""
    from avx_sort_merge_joins_tpu_torch import cli
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import exchange as ex
    from avx_sort_merge_joins_tpu_torch.parallel import mesh as pm

    args = cli.build_parser().parse_args(
        ["-n", str(DIST_SHARDS), "-r", str(MAIN_N), "-s", str(MAIN_N)])
    R, S = cli.make_relations(args, dev)
    mesh = pm.make_mesh(DIST_SHARDS, dev)
    shard = MAIN_N // DIST_SHARDS
    nv = ex.valid_counts(MAIN_N, shard, DIST_SHARDS)
    cap = ex.bucket_cap(shard, DIST_SHARDS, 2.0, dm.TILE_ELEMS)
    stacks = [dm._stage(k, MAIN_N, shard, mesh, False)
              for k in (R.keys, S.keys)]
    del R, S
    first_shard = stacks[0][0].clone()
    sorted_ = [[dm._local_sorted(st[me], BLOCK, 16, True)
                for me in range(DIST_SHARDS)] for st in stacks]
    del stacks
    bounds = dm._equidepth_bounds(mesh, *sorted_, nv, nv)
    out, buckets = [], []
    for ks in sorted_:
        bflat, _, counts, _ = dm._cut_all(mesh, ks, nv, bounds, cap)
        recv = mesh.all_to_all(bflat)
        counts = mesh.all_to_all(counts)
        out.append((recv[0].clone(), counts[0].clone()))
        buckets.append((bflat, counts))
        del recv
    return out, cap, first_shard, buckets


def gate_schedules(W: int, nch: int) -> dict:
    """The four arrival tables of tests/test_remote_fifo.py, at W strips of
    nch chunks: everything at round 0, the push schedule at rates 1 and 3,
    and one strip arriving whole at round 9 and another one chunk every 5
    rounds."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf

    late = np.zeros((W, nch), np.int32)
    late[W // 2] = 9
    late[-1] = 5 * np.arange(nch)
    return {"bulk": np.zeros((W, nch), np.int32),
            "push-next": rf.arrival_schedule(W, nch, 1),
            "slow": rf.arrival_schedule(W, nch, 3), "late-leaf": late}


def sorted_strips(W: int, stride: int, gen: torch.Generator,
                  dev: torch.device):
    """W ascending strips of ``stride`` keys with many duplicates across
    strips, and int32 lens with strip 0 empty and the last one full."""
    keys = torch.randint(-5000, 5000, (W, stride), generator=gen,
                         dtype=torch.int32, device=dev).sort(dim=1).values
    lens = torch.randint(0, stride + 1, (W,), generator=gen,
                         dtype=torch.int32, device=dev)
    lens[0], lens[-1] = 0, stride
    return keys.reshape(-1).contiguous(), lens


def phase_dist_kernels(dev: torch.device, times: Timings) -> None:
    """Exactness of K9 and the varlen K2 against their plain versions at the
    128M x 128M distributed join's shapes (8 strips of 4,014,080 slots,
    81,920-key chunks) under the four schedules, then K9 at W = 2, 4, 16
    and the varlen K2 at fan-in 2, 4, 16 with ragged and empty runs; K1,
    K2 and K3 at one shard's 16M shapes.  K9, its plain version and
    torch.sort of the landing column timed, and the ungated varlen K2 on
    the same landing buffer.  Returns every shard's buckets of R and S
    with their received counts, and the bucket cap."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf

    t0 = time.perf_counter()
    landings, cap, shard, buckets = dist_landings(dev)
    (land_r, lens_r), (land_s, lens_s) = landings
    del landings
    W = DIST_SHARDS
    chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, W)
    nch = cap // chunk
    log(f"[dist] shard 0's landing of {MAIN_N} x {MAIN_N} over {W} shards "
        f"in {time.perf_counter() - t0:.1f} s: cap {cap}, chunk {chunk} "
        f"({nch} a strip), R lens {lens_r.tolist()}, S lens "
        f"{lens_s.tolist()}")
    if (cap, chunk) != (DIST_CAP, DIST_CHUNK):
        raise AssertionError(f"cap {cap} / chunk {chunk} != {DIST_CAP} / "
                             f"{DIST_CHUNK}")
    merged = {}
    for side, land, lens in (("R", land_r, lens_r), ("S", land_s, lens_s)):
        host = lens.tolist()
        live = torch.cat([land[r * cap:r * cap + n]
                          for r, n in enumerate(host)])
        for case, arrive in gate_schedules(W, nch).items():
            got = rf.chunk_gated_merge(land, lens, cap, chunk, arrive)
            record("K9", f"{side} W={W} {case}", got,
                   rf.chunk_gated_merge_plain(land, lens, cap, chunk,
                                              arrive))
            if got[1].tolist() != [-(-n // chunk) for n in host] \
                    or int(got[2]) != 0:
                raise AssertionError(f"K9 {case}: waited {got[1].tolist()}"
                                     f", violation {int(got[2])}")
        if not torch.equal(got[0][:live.numel()], torch.sort(live).values):
            raise AssertionError("K9 merged prefix != torch.sort")
        merged[side] = (got[0], live.numel())
        got = mw.multiway_merge(land, W, lens=lens, stride=cap)
        record("K2", f"varlen {side} fanin={W} stride={cap}", got,
               mw.multiway_merge_varlen_plain(land, W, lens, cap))
    (mr, tr), (ms, ts) = merged["R"], merged["S"]
    record("K3", f"dist shard 0: {tr} x {ts}",
           mergejoin.merge_join_count_fused(mr, ms, tr, ts),
           mergejoin.merge_join_count_fused_plain(mr, ms, tr, ts))
    log_k3_time("a shard of -n 8", mr, ms, tr, ts)
    del merged, mr, ms

    gen = torch.Generator(device=dev).manual_seed(37)
    for w in (2, 4, 16):  # chunk = a whole strip, one strip empty
        land, lens = sorted_strips(w, cap, gen, dev)
        for arrive in (np.zeros((w, 1), np.int32),
                       rf.arrival_schedule(w, 1, 1)):
            record("K9", f"W={w} chunk=strip={cap} rounds "
                   f"{arrive.max()}", rf.chunk_gated_merge(
                       land, lens, cap, cap, arrive),
                   rf.chunk_gated_merge_plain(land, lens, cap, cap, arrive))
    # W = 32, 64, 1,024 at a small stride (above 32 strips the co-rank
    # windows lie in shared memory), a landing longer than the W strips,
    # and strips that all hold one key, so that ties to the lower strip
    # decide every co-rank and the waits at every tile
    stride, small_chunk = 2 * MERGE_TILE, MERGE_TILE // 4
    for w in (32, 64, 1024):
        land, lens = sorted_strips(w, stride, gen, dev)
        land = torch.cat([land, torch.full((3 * MERGE_TILE + 5,), KEY_INF,
                                           dtype=torch.int32, device=dev)])
        for keys in ("ragged", "one key"):
            if keys == "one key":
                land = torch.full_like(land, 7)
            for case, arrive in gate_schedules(
                    w, stride // small_chunk).items():
                got = rf.chunk_gated_merge(land, lens, stride, small_chunk,
                                           arrive)
                record("K9", f"W={w} stride={stride} cap={land.numel()} "
                       f"{keys} {case}", got,
                       rf.chunk_gated_merge_plain(land, lens, stride,
                                                  small_chunk, arrive))
                if got[1].tolist() != [-(-n // small_chunk)
                                       for n in lens.tolist()] \
                        or int(got[2]) != 0:
                    raise AssertionError(f"K9 W={w} {keys} {case}: waited "
                                         f"{got[1].tolist()}, violation "
                                         f"{int(got[2])}")
    same = torch.full_like(land_r, 7)
    for case, arrive in gate_schedules(W, nch).items():
        record("K9", f"R W={W} one key {case}",
               rf.chunk_gated_merge(same, lens_r, cap, chunk, arrive),
               rf.chunk_gated_merge_plain(same, lens_r, cap, chunk, arrive))
    del same
    for fanin in (2, 4, 16):  # two groups of ragged and empty runs
        land, lens = sorted_strips(2 * fanin, VARLEN_STRIDE, gen, dev)
        lens[fanin] = 0
        record("K2", f"varlen fanin={fanin} stride={VARLEN_STRIDE}",
               mw.multiway_merge(land, fanin, lens=lens,
                                 stride=VARLEN_STRIDE),
               mw.multiway_merge_varlen_plain(land, fanin, lens,
                                              VARLEN_STRIDE))
    del land, lens

    # one shard's local sort at its 16M shape
    n = shard.numel()
    runs = sort_ops.sort_blocks_plain(shard, n)
    record("K1", f"dist shard n={n}", sort_ops.sort_blocks(shard, n), runs)
    for level in mw.merge_levels(n, BLOCK, 16):
        _, span, nruns, w = level
        lens3 = (nruns, n, span)
        want = mw.multiway_merge_plain(runs, w, lens3)
        record("K2", f"dist shard level={level}",
               mw.multiway_merge(runs, w, lens3)[0], want)
        runs = want
    del runs, want, shard

    # times at the main path's shape: shard 0's R landing, push schedule
    total = int(lens_r.sum())
    arrive = rf.arrival_schedule(W, nch, 1)
    ms = time_ms(lambda: rf.chunk_gated_merge(land_r, lens_r, cap, chunk,
                                              arrive))
    plain = time_ms(lambda: rf.chunk_gated_merge_plain(land_r, lens_r, cap,
                                                       chunk, arrive))
    library = time_ms(lambda: torch.sort(land_r))
    # live keys read once, every slot of the merged column written once
    times.add("K9", ms, plain, library,
              4 * total + 4 * land_r.numel() + 4 * W * (nch + 2),
              total * math.log2(W))
    varlen = time_ms(lambda: mw.multiway_merge(land_r, W, lens=lens_r,
                                               stride=cap))
    vbound = bound_ms(4 * total + 4 * land_r.numel(), total * math.log2(W))
    parts = gated_parts_ms(land_r, lens_r, cap, chunk, arrive)
    log(f"[time] K9 {W} strips of {cap} ({total} live keys), chunk {chunk}, "
        f"push schedule: {times.entry('K9')}; in parts: co-ranks "
        f"{parts['corank']:.3f} ms, gate {parts['gate']:.3f} ms, merge "
        f"{parts['merge']:.3f} ms (whole {parts['all']:.3f} ms); the ungated "
        f"varlen K2 (fan-in {W}) on the same landing: {varlen:.3f} ms "
        f"(bound {vbound[0]:.3f} ms)")
    return buckets, cap


def phase_dist_cli(path: str, flags: list[str], n: int) -> dict[str, int]:
    """A ``-n 8`` path of ``DIST_PATHS`` through the CLI: ``Results = |S|``
    (unique R, foreign-key or Zipf S), its kernels launched (at 128M
    exactly as often as ``DIST_PATHS`` says), its phase times printed."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mpsm

    path_flags, need, phases, at_main = DIST_PATHS[path]
    argv = [*path_flags, "-n", str(DIST_SHARDS), *flags, "-r", str(n),
            "-s", str(n)]
    ring, real = [], dist_mpsm._ring_count

    def spy(*args):  # times mpsm's S ring: its rounds of K3 launches
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        ring.append(time.perf_counter() - t0)
        return out

    dist_mpsm._ring_count = spy
    reset_launches()
    t0 = time.perf_counter()
    try:
        rc, stdout, stderr = run_cli_full(argv)
        torch.cuda.synchronize()
    finally:
        dist_mpsm._ring_count = real
    counts = launches()
    log(f"[dist] cli.main({argv}) -> rc {rc} in "
        f"{time.perf_counter() - t0:.3f} s (data generation included); "
        f"launches {counts}" + (f"; the S ring (its {counts['K3']} K3 "
                                f"launches) {ring[0] * 1e3:.3f} ms on the "
                                "host clock" if ring else ""))
    if rc != 0 or results_of(stdout) != n:
        raise AssertionError(f"dist {argv}: rc {rc}, {stdout!r}")
    for ph in phases:
        m = re.search(rf"^\[STATS\] {ph}\s+([\d.]+) usecs", stderr, re.M)
        if m is None or float(m.group(1)) <= 0:
            raise AssertionError(f"dist {argv}: no {ph} phase time")
    check_launched(f"dist {argv}", counts, need)
    if n == MAIN_N and at_main and any(counts[k] != v
                                       for k, v in at_main.items()):
        raise AssertionError(f"dist {argv}: launches {counts}, want "
                             f"{at_main}")
    return counts


def dist_relations(n: int, dev: torch.device, flags=()):
    from avx_sort_merge_joins_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["-n", str(DIST_SHARDS), "-r", str(n), "-s", str(n), *flags])
    R, S = cli.make_relations(args, dev)
    torch.cuda.synchronize()
    return R, S


def phase_dist_emulate(dev: torch.device) -> dict[str, int]:
    """``dist_mway_join_count(..., remote_pull="emulate")`` at 128M x 128M
    over 8 shards, pull rates 1 and 3: count 128,000,000, K9 launched 16
    times a run (8 shards x 2 relations), each call waiting ceil(len /
    81,920) chunks a strip with no violation."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    R, S = dist_relations(MAIN_N, dev)
    mesh = make_mesh(DIST_SHARDS, dev)
    real, calls = rf.chunk_gated_merge, []

    def spy(landing, lens, stride, chunk, arrive):
        out = real(landing, lens, stride, chunk, arrive)
        calls.append((lens, chunk, out[1], out[2]))  # read after the run
        return out

    total = {}
    rf.chunk_gated_merge = spy
    try:
        for rate in (1, 3):
            calls.clear()
            reset_launches()
            t0 = time.perf_counter()
            count, ov = dm.dist_mway_join_count(
                R.keys, S.keys, MAIN_N, MAIN_N, mesh, remote_pull="emulate",
                pull_rate=rate)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launches()
            waits = [(c[0].tolist(), c[1], c[2].tolist(), int(c[3]))
                     for c in calls]
            log(f"[dist] remote_pull=emulate pull_rate={rate} {MAIN_N} x "
                f"{MAIN_N} over {DIST_SHARDS} shards: count {count}, "
                f"overflow {ov}, {secs:.3f} s on the host clock (staging "
                f"included), launches {counts}; waits of the first call "
                f"{waits[0][2]} for lens {waits[0][0]}")
            if (count, ov) != (MAIN_N, 0) or counts["K9"] != 16 \
                    or len(waits) != 16:
                raise AssertionError(f"emulate rate {rate}: {count}, {ov}, "
                                     f"K9 {counts['K9']}")
            for lens, chunk, waited, viol in waits:
                if chunk != DIST_CHUNK or viol != 0 or \
                        waited != [-(-n // chunk) for n in lens]:
                    raise AssertionError(f"emulate rate {rate}: chunk "
                                         f"{chunk}, waited {waited}, lens "
                                         f"{lens}, violation {viol}")
            check_launched("dist emulate", counts, ("K1", "K2", "K3", "K9"))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        rf.chunk_gated_merge = real
    return total


K11_MAX_REGS = 40  # 65,536 registers over 6 CTAs of 256, allocated by 8


def phase_k11_sass() -> None:
    """K11 reads the landing while other CTAs write it: none of its loads
    may take the non-coherent read-only path.  cuobjdump's SASS of the
    built library must show no LDG.E...CONSTANT in K11, and its acquire
    loads followed by L1 invalidations (CCTL.IVALL).  Its resource usage
    must show at most K11_MAX_REGS registers: its merge tiles are
    latency-bound, and without its launch bounds ptxas took 57 (4 CTAs
    an SM instead of 6) and K11 ran slower."""
    import ctypes

    from avx_sort_merge_joins_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    found = re.search(r"Function [^\n]*remote_pull_kernel[^\n]*\n([^\n]*)",
                      res_usage())
    res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", found.group(1))) \
        if found else {}
    ctas = {}
    for n in (2, DIST_SHARDS, 64, 256):
        c = ctypes.c_int(0)
        _build.check("smj_remote_pull_occupancy",
                     _build.library().smj_remote_pull_occupancy(
                         n, ctypes.byref(c)))
        ctas[n] = c.value
    log(f"[sass] K11 resource usage: {res}; CTAs an SM by shards {ctas}")
    if "REG" not in res or int(res["REG"]) > K11_MAX_REGS:
        raise AssertionError(f"K11 uses {res.get('REG')} registers, over "
                             f"{K11_MAX_REGS}: {found and found.group(0)}")
    sass = subprocess.run([tool, "-sass", _build.build()],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    k11 = [f for f in funcs if f.split("\n", 1)[0].find("remote_pull") >= 0]
    if len(k11) != 1:
        raise AssertionError(f"SASS: {len(k11)} functions named remote_pull")
    ops = re.findall(r"\b(LDG\.[A-Z0-9.]+|CCTL\.IVALL)", k11[0])
    kinds = {k: ops.count(k) for k in sorted(set(ops))}
    log(f"[sass] K11 ({k11[0].split(chr(10), 1)[0].strip()}): {kinds}")
    if any("CONSTANT" in k for k in kinds) or not kinds.get("CCTL.IVALL"):
        raise AssertionError(f"K11 SASS: non-coherent loads or no L1 "
                             f"invalidation after acquire: {kinds}")


def res_usage() -> str:
    """cuobjdump -res-usage of the built library."""
    from avx_sort_merge_joins_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-res-usage", _build.build()],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def phase_merge_resources() -> None:
    """Registers, stack and static shared memory of K2's and K6's kernels
    (cuobjdump -res-usage of the built library, the recipe of phase 19);
    the tile merge's buffers and the co-rank windows are dynamic shared
    memory on top.  The tile merges' CTAs an SM (at fan-in 16); a tile
    merge or a sampled co-rank with local memory or stack fails the run.  K1's registers, local memory and stack, and the CTAs
    an SM it keeps at each block size: its keys live in registers, and a
    key array in local memory (LOCAL or STACK above 0) fails the run.  The
    same for K5, whose packed pairs live in registers too, and for K4's,
    K8's, K3's, K7's, K10's and K9's gate's kernels."""
    import ctypes

    from avx_sort_merge_joins_tpu_torch.kernels import _build
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    usage = res_usage()
    found = [(name, line) for name, line in re.findall(
        r"Function ([^\s:]+):?\n([^\n]*)", usage)
        if "multiway_merge_cu" in name
        and re.search(r"(corank|merge)_kernelI[ix]", name)]
    # co-rank searches with the windows in registers (fan-in <= 32) or in
    # shared memory, the sampled fine co-ranks, and the tile merge: keys
    # at the three tiles, pairs at one
    if len(found) != 16:
        raise AssertionError(f"cuobjdump: {len(found)} K2/K6 kernels")
    for name, line in found:
        res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
        kernel, elem = re.search(r"(corank_kernel|merge_kernel)I([ix])",
                                 name).groups()
        sampled = "SampledPass" in name
        if sampled:
            kernel += " (fine, sampled, finished in shared memory)"
        elif kernel == "corank_kernel":
            kernel += (" (windows in registers)" if "Lb1E" in name
                       else " (windows in shared memory)")
        tile = re.search(r"Li(\d+)E", name).group(1)
        ctas = ""
        if kernel == "merge_kernel":  # its rounds' heads live in registers
            c = ctypes.c_int(0)
            _build.check("smj_multiway_merge_occupancy",
                         _build.library().smj_multiway_merge_occupancy(
                             int(tile), int(elem == "x"), ctypes.byref(c)))
            ctas = f"; {c.value} CTAs an SM"
        log(f"[sass] {'K6' if elem == 'x' else 'K2'} {kernel} tile {tile}: "
            f"REG {res.get('REG')}, STACK {res.get('STACK')}, SHARED "
            f"{res.get('SHARED')}, LOCAL {res.get('LOCAL')}{ctas}")
        if (sampled or kernel == "merge_kernel") and (
                "REG" not in res or int(res.get("LOCAL", 1)) or
                int(res.get("STACK", 1))):
            raise AssertionError(f"{kernel} uses local memory: {res}")
    k1 = {int(b): dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
          for b, line in re.findall(
              r"Function [^\n]*block_sort_kernelILi(\d+)E[^\n]*\n([^\n]*)",
              usage)}
    for block in sort_ops.SUPPORTED_BLOCKS:
        res = k1.get(block, {})
        c = ctypes.c_int(0)
        _build.check("smj_block_sort_occupancy",
                     _build.library().smj_block_sort_occupancy(
                         block, ctypes.byref(c)))
        log(f"[sass] K1 block_sort_kernel<{block}>: REG {res.get('REG')}, "
            f"LOCAL {res.get('LOCAL')}, STACK {res.get('STACK')}, SHARED "
            f"{res.get('SHARED')}; {c.value} CTAs an SM")
        if "REG" not in res or int(res.get("LOCAL", 1)) or \
                int(res.get("STACK", 1)):
            raise AssertionError(f"K1 at block {block} keeps keys in local "
                                 f"memory: {res}")
    k5 = {int(b): dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
          for b, line in re.findall(
              r"Function [^\n]*block_sort_pairs_kernelILi(\d+)E[^\n]*\n"
              r"([^\n]*)", usage)}
    for block in sort_ops.SUPPORTED_BLOCKS:
        res = k5.get(block, {})
        c = ctypes.c_int(0)
        _build.check("smj_block_sort_pairs_occupancy",
                     _build.library().smj_block_sort_pairs_occupancy(
                         block, ctypes.byref(c)))
        log(f"[sass] K5 block_sort_pairs_kernel<{block}>: REG "
            f"{res.get('REG')}, LOCAL {res.get('LOCAL')}, STACK "
            f"{res.get('STACK')}, SHARED {res.get('SHARED')}; {c.value} "
            f"CTAs an SM")
        if "REG" not in res or int(res.get("LOCAL", 1)) or \
                int(res.get("STACK", 1)):
            raise AssertionError(f"K5 at block {block} keeps pairs in local "
                                 f"memory: {res}")
    # K4 (keys or pairs; uniform ascending or descending, or varlen) and K8
    found = re.findall(r"Function ([^\s:]*(?:merge_pass|radix_hist)_kernel"
                       r"[^\s:]*):?\n([^\n]*)", usage)
    if len([f for f, _ in found if "merge_pass" in f]) != 6 or \
            len([f for f, _ in found if "radix_hist" in f]) != 1:
        raise AssertionError(f"cuobjdump: K4/K8 kernels "
                             f"{[f for f, _ in found]}")
    for name, line in found:
        res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
        kernel = "K8 radix_hist_kernel" if "radix_hist" in name else (
            "K4 merge_pass_kernel<"
            f"{'pairs' if 'kernelIx' in name else 'keys'}, "
            f"{'descending' if 'Lb1E' in name else 'ascending'}, "
            f"{'varlen' if 'Varlen' in name else 'uniform'}>")
        log(f"[sass] {kernel}: REG {res.get('REG')}, LOCAL "
            f"{res.get('LOCAL')}, STACK {res.get('STACK')}, SHARED "
            f"{res.get('SHARED')}")
        if "REG" not in res or int(res.get("LOCAL", 1)) or \
                int(res.get("STACK", 1)):
            raise AssertionError(f"{kernel} uses local memory: {res}")
    # K3, K7 and K10 (one CTA body) and K9's gate; K9's co-ranks and
    # merge are K2's kernels, above
    found = re.findall(r"Function ([^\s:]*(?:merge_join_count(?:2|64)?_"
                       r"kernel|gate_kernel)[^\s:]*):?\n([^\n]*)", usage)
    if sorted(re.search(r"(merge_join_count(?:2|64)?_kernel|gate_kernel)",
                        f).group(1) for f, _ in found) != [
            "gate_kernel", "merge_join_count2_kernel",
            "merge_join_count64_kernel", "merge_join_count_kernel"]:
        raise AssertionError(f"cuobjdump: K3/K7/K9/K10 kernels "
                             f"{[f for f, _ in found]}")
    for name, line in found:
        res = dict(re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line))
        kernel = ("K9 gate_kernel" if "gate_kernel" in name else
                  "K10 merge_join_count2_kernel" if "count2" in name else
                  "K7 merge_join_count64_kernel" if "count64" in name else
                  "K3 merge_join_count_kernel")
        log(f"[sass] {kernel}: REG {res.get('REG')}, LOCAL "
            f"{res.get('LOCAL')}, STACK {res.get('STACK')}, SHARED "
            f"{res.get('SHARED')}")
        if "REG" not in res or int(res.get("LOCAL", 1)) or \
                int(res.get("STACK", 1)):
            raise AssertionError(f"{kernel} uses local memory: {res}")
    for pairs in (0, 1):
        c = ctypes.c_int(0)
        _build.check("smj_merge_pass_occupancy",
                     _build.library().smj_merge_pass_occupancy(
                         pairs, ctypes.byref(c)))
        log(f"[sass] K4 {'pairs' if pairs else 'keys'}: {c.value} CTAs an SM")
    per_bits = []
    for bits in range(1, 17):
        c = ctypes.c_int(0)
        _build.check("smj_radix_hist_occupancy",
                     _build.library().smj_radix_hist_occupancy(
                         bits, ctypes.byref(c)))
        per_bits.append(f"2^{bits}: {c.value}")
    log(f"[sass] K8 CTAs an SM: {', '.join(per_bits)}")


def pull_buckets(n: int, cap: int, case: str, gen: torch.Generator,
                 dev: torch.device, lens=None):
    """(bflat, counts) of one relation on n shards, made on the card:
    shard me's bucket d holds counts[me, d] ascending keys at [me, d*cap],
    pads after.  "empty": half the buckets and every bucket for shard 0
    empty; "hot": every bucket for the last shard full of one key;
    "hot_all": every bucket full of one key; "hot_between": half the keys
    of every bucket one key, between uniform ones; "domain_ends": keys at
    both ends of the key domain.  ``lens``: the counts drawn from these
    lengths instead."""
    counts = torch.randint(0, cap + 1, (n, n), generator=gen, device=dev)
    if lens is not None:
        pick = torch.tensor(lens, device=dev)
        counts = pick[torch.randint(0, len(lens), (n, n), generator=gen,
                                    device=dev)]
    if case == "empty":
        counts[torch.rand((n, n), generator=gen, device=dev) < 0.5] = 0
        counts[:, 0] = 0
    elif case == "hot":
        counts.zero_()
        counts[:, -1] = cap
    elif case == "hot_all":
        counts.fill_(cap)
    if case in ("hot", "hot_all"):
        keys = torch.full((n, n, cap), 7, dtype=torch.int32, device=dev)
    elif case == "domain_ends":
        ends = torch.tensor([-DOMAIN_MAX, -DOMAIN_MAX + 1, 0, DOMAIN_MAX - 1,
                             DOMAIN_MAX], dtype=torch.int32, device=dev)
        keys = ends[torch.randint(0, 5, (n, n, cap), generator=gen,
                                  device=dev)]
    else:
        keys = torch.randint(-DOMAIN_MAX, DOMAIN_MAX + 1, (n, n, cap),
                             generator=gen, device=dev).to(torch.int32)
        if case == "hot_between":
            hot = torch.rand((n, n, cap), generator=gen, device=dev) < 0.5
            keys = torch.where(hot, 7, keys).to(torch.int32)
    lane = torch.arange(cap, device=dev)
    keys = torch.where(lane < counts[..., None], keys, KEY_INF)
    return (keys.sort(dim=2).values.reshape(n, n * cap).contiguous(),
            counts.to(torch.int32))


def check_pull(case: str, mesh, bflat, rcounts, cap: int, chunk: int,
               windows) -> None:
    """K11 against its plain version at each send window, exactly: the
    landing (the whole all-to-all), the merged columns, the waits
    (ceil(count / chunk)) and the flags.  One line a case."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf

    want = rf.remote_pull_exchange_merge_plain(mesh, bflat, rcounts, cap,
                                               chunk)
    if not torch.equal(want[3], mesh.all_to_all(bflat)):
        raise AssertionError(f"K11 plain {case}: landing != all-to-all")
    waits = (rcounts + chunk - 1) // chunk
    e = 0
    for w in windows:
        got = rf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk,
                                            window=w)
        e = max(e, *(max_abs_err(g, x) for g, x in zip(got, want)))
        if e or not all(torch.equal(g, x) for g, x in zip(got, want)) \
                or not torch.equal(got[1], waits) or int(got[2].sum()):
            raise AssertionError(f"K11 {case} window {w}: kernel != plain "
                                 f"(max_abs_err {e})")
    log(f"[check] K11 {case} windows {list(windows)}: max_abs_err {e}")
    ERR["K11"] = max(ERR["K11"], e)


def phase_pull_kernels(dev: torch.device, times: Timings, buckets,
                       cap: int) -> None:
    """Exactness of K11 against its plain version, the JAX module's test
    plan on one card: n = 2, 4, 8, 16 shards, chunk = a whole strip (step
    1) and 16K, 32K, 64K keys (step 2), uniform keys, empty buckets and
    shards, a hot key over every strip, the domain's ends, at windows 1,
    4, 8, 32 and every push in flight (step 6); then the 128M x 128M join's
    buckets over 8 shards (8 x 8 strips of 4,014,080 slots, 81,920-key
    chunks) for R and S; an undersized strip raises (step 5).  Then K11
    timed at those shapes beside its plain version, torch.sort of the
    landing, and the bulk composite (all-to-all, then K9 a shard), and the
    one-card copy/merge overlap (step 4 on one card: no interconnect)."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device=dev).manual_seed(11)
    for n in (2, 4, 8, 16):
        mesh = make_mesh(n, dev)
        for chunk in PULL_CHUNKS:
            for case in ("uniform", "empty", "hot", "domain_ends"):
                bflat, counts = pull_buckets(n, PULL_CAP, case, gen, dev)
                rcounts = mesh.all_to_all(counts)
                total = n * (PULL_CAP // chunk)
                check_pull(f"n={n} cap={PULL_CAP} chunk={chunk} {case}",
                           mesh, bflat, rcounts, PULL_CAP, chunk,
                           (*PULL_WINDOWS, total))
    # the merge tile's edges: strips of 4,095, 4,096, 4,097 and 12,295
    # keys (each alone, and mixed); hot keys over many tiles and every
    # strip; n = 32 and 64 shards (a warp's lanes cover 1 and 2 strips)
    for n, pcap, pchunk, case, lens in (
            *((8, PULL_EDGE_CAP, 4096, "uniform", [ln])
              for ln in PULL_EDGE_LENS),
            (8, PULL_EDGE_CAP, 1024, "uniform", list(PULL_EDGE_LENS)),
            (16, PULL_EDGE_CAP, 4096, "domain_ends", list(PULL_EDGE_LENS)),
            (8, PULL_EDGE_CAP, 4096, "hot_all", None),
            (8, PULL_EDGE_CAP, 2048, "hot_between", None),
            (32, 4096, 1024, "uniform", None),
            (64, 4096, 1024, "uniform", None),
            (64, 4096, 2048, "hot_between", None),
            (64, 2048, 2048, "hot_all", None)):
        mesh = make_mesh(n, dev)
        bflat, counts = pull_buckets(n, pcap, case, gen, dev, lens)
        rcounts = mesh.all_to_all(counts)
        check_pull(f"n={n} cap={pcap} chunk={pchunk} {case}"
                   f"{f' lens {lens}' if lens else ''}", mesh, bflat,
                   rcounts, pcap, pchunk, (1, 8, n * (pcap // pchunk)))
    del bflat, counts, rcounts

    W = DIST_SHARDS
    mesh = make_mesh(W, dev)
    chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, W)
    total_pushes = W * (cap // chunk)
    for side, (bflat, rcounts) in zip("RS", buckets):
        check_pull(f"{side} {MAIN_N} x {MAIN_N} over {W} shards cap={cap} "
                   f"chunk={chunk}", mesh, bflat, rcounts, cap, chunk,
                   (1, 8, None, total_pushes))
    wrong = rcounts.clone()
    wrong[3, 5] = cap + 1
    try:
        rf.remote_pull_exchange_merge(mesh, bflat, wrong, cap, chunk)
    except ValueError as e:
        log(f"[check] K11 undersized strip (count {cap + 1} > cap {cap}) "
            f"raises: {e}")
    else:
        raise AssertionError("K11 took a count above its strip")

    bflat, rcounts = buckets[0]
    live = int(rcounts.sum())
    slots = bflat.numel()
    ms = time_ms(lambda: rf.remote_pull_exchange_merge(mesh, bflat, rcounts,
                                                       cap, chunk))
    plain = time_ms(lambda: rf.remote_pull_exchange_merge_plain(
        mesh, bflat, rcounts, cap, chunk))
    landing = mesh.all_to_all(bflat)
    library = time_ms(lambda: torch.sort(landing, dim=1))
    # the merge alone: every flag set before the launch, no push
    K = rf._checked_pull(mesh, bflat, rcounts, cap, chunk, None)
    full = rf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk)
    only = rf._pull_launch(mesh, bflat, rcounts, cap, chunk, K,
                           landing=full[3])
    if not all(torch.equal(a, b) for a, b in zip(only, full)):
        raise AssertionError("K11 merge-only launch != full launch")
    merge_ms = time_ms(lambda: rf._pull_launch(mesh, bflat, rcounts, cap,
                                               chunk, K, landing=full[3]))
    del full, only
    arrive = np.zeros((W, cap // chunk), np.int32)
    t_a2a = time_ms(lambda: mesh.all_to_all(bflat))
    t_merge = time_ms(lambda: [rf.chunk_gated_merge(
        landing[d], rcounts[d], cap, chunk, arrive) for d in range(W)])
    # every bucket slot read once, every landing and merged slot written
    # once (a tile merges the live keys as they land: no second read), the
    # counts read, the flags, waits and violation flags written
    times.add("K11", ms, plain, library,
              4 * 3 * slots + 4 * (W * W * (cap // chunk + 2) + W),
              live * math.log2(W))
    log(f"[time] K11 R over {W} shards ({W} x {W} strips of {cap}, {live} "
        f"live keys, chunk {chunk}, window {rf.push_window()}): "
        f"{times.entry('K11')}; of it the merge alone (flags set, no "
        f"push) {merge_ms:.3f} ms, the pushes and their waits "
        f"{ms - merge_ms:.3f} ms; bulk composite: all-to-all {t_a2a:.3f} ms + "
        f"K9 x {W} {t_merge:.3f} ms = {t_a2a + t_merge:.3f} ms; one-card "
        f"copy/merge overlap (t_a2a + t_merge - t_K11) / t_a2a = "
        f"{(t_a2a + t_merge - ms) / t_a2a:.3f} (one card, no interconnect)")


def phase_dist_dma(dev: torch.device) -> dict[str, int]:
    """``dist_mway_join_count(..., remote_pull="dma")`` over 8 shards: at
    128M x 128M (count 128,000,000, K11 launched twice, K9 never, every
    shard waiting ceil(len / 81,920) chunks a strip, no flag); at 16M with
    -z 1.0 against the torch.sort baseline; at 16M with SMJ_REMOTE_WINDOW
    4, 8, 32 and every push in flight."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import exchange as ex
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(DIST_SHARDS, dev)
    real, calls = rf.remote_pull_exchange_merge, []

    def spy(mesh, bflat, rcounts, cap, chunk, window=None):
        out = real(mesh, bflat, rcounts, cap, chunk, window)
        calls.append((rcounts, chunk, out[1], out[2]))  # read after the run
        return out

    def run(R, S, n, what):
        calls.clear()
        reset_launches()
        t0 = time.perf_counter()
        count, ov = dm.dist_mway_join_count(R.keys, S.keys, n, n, mesh,
                                            remote_pull="dma")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        log(f"[dist] remote_pull=dma {what} {n} x {n} over {DIST_SHARDS} "
            f"shards: count {count}, overflow {ov}, {secs * 1e3:.3f} ms on "
            f"the host clock (staging included), launches {counts}")
        if ov != 0 or counts["K11"] != 2 or counts["K9"] != 0 \
                or len(calls) != 2:
            raise AssertionError(f"dma {what}: overflow {ov}, K11 "
                                 f"{counts['K11']}, K9 {counts['K9']}")
        for rc, chunk, waited, viol in calls:
            if not torch.equal(waited, (rc + chunk - 1) // chunk) \
                    or int(viol.sum()) != 0:
                raise AssertionError(f"dma {what}: waited {waited.tolist()}"
                                     f" for counts {rc.tolist()}")
        check_launched(f"dist dma {what}", counts, ("K1", "K2", "K3", "K11"))
        return count, counts

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    rf.remote_pull_exchange_merge = spy
    window_env = os.environ.get("SMJ_REMOTE_WINDOW")
    try:
        R, S = dist_relations(MAIN_N, dev)
        count, counts = run(R, S, MAIN_N, "default window")
        if count != MAIN_N or calls[0][1] != DIST_CHUNK:
            raise AssertionError(f"dma: count {count}, chunk {calls[0][1]}")
        log(f"[dist] dma waits of shard 0, R: {calls[0][2][0].tolist()} for "
            f"counts {calls[0][0][0].tolist()}")
        add(counts)
        del R, S

        n = DIST_SMALL_N
        R, S = dist_relations(n, dev, ["-z", "1.0"])
        count, counts = run(R, S, n, "-z 1.0")
        base = int(mergejoin.merge_join_count_torch(
            torch.sort(R.keys).values, torch.sort(S.keys).values, n, n))
        log(f"[dist] dma -z 1.0: count {count}, torch.sort baseline {base}")
        if count != base:
            raise AssertionError(f"dma -z 1.0: {count} != baseline {base}")
        add(counts)
        del R, S

        R, S = dist_relations(n, dev)
        cap = ex.bucket_cap(n // DIST_SHARDS, DIST_SHARDS, 2.0,
                            dm.TILE_ELEMS)
        pushes = DIST_SHARDS * (cap // rf.pick_chunk_elems(
            cap, dm.TILE_ELEMS, DIST_SHARDS))
        for w in (4, 8, 32, pushes):
            os.environ["SMJ_REMOTE_WINDOW"] = str(w)
            count, counts = run(R, S, n, f"window {w}")
            if count != n:
                raise AssertionError(f"dma window {w}: {count} != {n}")
            add(counts)
    finally:
        rf.remote_pull_exchange_merge = real
        if window_env is None:
            os.environ.pop("SMJ_REMOTE_WINDOW", None)
        else:
            os.environ["SMJ_REMOTE_WINDOW"] = window_env
    return total


MESH_ROUTES = {  # route of the 128M -n 8 join -> dist_mway_join_count kwargs
    "bulk": {},
    "-S RING": {"numa_strategy": "RING"},
    "emulate": {"remote_pull": "emulate"},
    "dma": {"remote_pull": "dma"},
}
MESH_ROUTE_KERNELS = {"bulk": ("K1", "K2", "K3"), "-S RING": ("K1", "K2", "K3"),
                      "emulate": ("K1", "K2", "K3", "K9"),
                      "dma": ("K1", "K2", "K3", "K11")}


def mesh_join_ms(R, S, mesh, kw: dict) -> tuple[int, float]:
    """One warm run of the 128M -n 8 m-way join on ``mesh``, then one timed
    on the host clock (staging included, a sync after): (count, ms)."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm

    dm.dist_mway_join_count(R.keys, S.keys, MAIN_N, MAIN_N, mesh, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count, ov = dm.dist_mway_join_count(R.keys, S.keys, MAIN_N, MAIN_N, mesh,
                                        **kw)
    torch.cuda.synchronize()
    if ov != 0:
        raise AssertionError(f"mesh join {kw}: overflow {ov}")
    return count, (time.perf_counter() - t0) * 1e3


def mesh_routes(R, S, devices: list, label: str,
                routes=tuple(MESH_ROUTES)) -> dict[str, int]:
    """The 128M -n 8 join on each route of ``MESH_ROUTES`` through the
    device-a-shard layout on ``devices``, beside the one-device mesh of
    cuda:0: both exact; the per-shard run's launches (counts set to 0 just
    before it, read just after) returned, summed over the routes."""
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    one = make_mesh(DIST_SHARDS, torch.device("cuda", 0))
    cards = make_mesh(DIST_SHARDS, devices=devices)
    total = {}
    for route in routes:
        kw = MESH_ROUTES[route]
        want, one_ms = mesh_join_ms(R, S, one, kw)
        reset_launches()
        got, ms = mesh_join_ms(R, S, cards, kw)
        counts = launches()
        log(f"[mesh] {label} {route}: count {got} in {ms:.3f} ms (one-device "
            f"mesh: {want} in {one_ms:.3f} ms); launches of the two runs "
            f"{counts}")
        if got != want or got != MAIN_N:
            raise AssertionError(f"mesh {label} {route}: {got} != {want}")
        check_launched(f"mesh {label} {route}", counts,
                       MESH_ROUTE_KERNELS[route])
        if route == "dma" and counts["K11"] != 4 * len(cards.cards):
            raise AssertionError(f"mesh {label} dma: K11 {counts['K11']}, "
                                 f"want 2 launches a card a run")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def check_pull_cards(buckets, cap: int, devices: list, label: str) -> None:
    """K11's per-card launch on the 128M join's buckets (the dist dma
    phase's shape), shard me's rows on ``devices[me]``: equal to its plain
    version and to the one-device launch, shard for shard, and timed beside
    the one-device launch."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    W = DIST_SHARDS
    one = make_mesh(W, torch.device("cuda", 0))
    cards = make_mesh(W, devices=devices)
    chunk = rf.pick_chunk_elems(cap, dm.TILE_ELEMS, W)
    e = 0
    for side, (bflat, rcounts) in zip("RS", buckets):
        rows = [bflat[me].to(devices[me]) for me in range(W)]
        rc = [rcounts[me].to(devices[me]) for me in range(W)]
        want = rf.remote_pull_exchange_merge(one, bflat, rcounts, cap, chunk)
        got = rf.remote_pull_exchange_merge(cards, rows, rc, cap, chunk)
        plain = rf.remote_pull_exchange_merge_plain(cards, rows, rc, cap,
                                                    chunk)
        for name, a, b, c in zip(("merged", "waited", "violation",
                                  "landing"), got, plain, want):
            for me in range(W):
                e = max(e, max_abs_err(a[me], b[me]),
                        max_abs_err(a[me].to("cuda:0"), c[me]))
                if not (torch.equal(a[me], b[me])
                        and torch.equal(a[me].to("cuda:0"), c[me])):
                    raise AssertionError(f"K11 {label} {side} shard {me} "
                                         f"{name}: per-card launch != plain "
                                         "or one-device launch")
        del want, got, plain
        ms = time_ms(lambda: rf.remote_pull_exchange_merge(cards, rows, rc,
                                                           cap, chunk))
        one_ms = time_ms(lambda: rf.remote_pull_exchange_merge(
            one, bflat, rcounts, cap, chunk))
        log(f"[mesh] K11 {label} {side} ({W} x {W} strips of {cap}, chunk "
            f"{chunk}, {len(cards.cards)} launch(es)): equal to its plain "
            f"version and to the one-device launch (max_abs_err {e}); "
            f"{ms:.3f} ms against {one_ms:.3f} ms for one launch on the "
            "one-device mesh")
    ERR["K11"] = max(ERR["K11"], e)


def phase_mesh_cards(dev: torch.device) -> dict[str, int]:
    """The mesh of cards: the card count and the peer-access matrix; the
    128M -n 8 join through the device-a-shard layout with all eight shards
    on cuda:0 (bulk, -S RING, emulate, dma), each exact and equal to the
    one-device mesh's; K11's per-card launch against its plain version at
    the dist dma phase's shape; the CLI with --mapping-file on a file of
    eight 0s; where the machine has two or more cards, the join and the
    K11 check again with shard me on cuda:(me mod count)."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as rf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(count) for j in range(count) if i != j}
    log(f"[mesh] torch.cuda.device_count() = {count}; "
        f"can_device_access_peer: {peers or 'no pair (one card)'}")
    R, S = dist_relations(MAIN_N, dev)
    on_one = [dev] * DIST_SHARDS
    total = mesh_routes(R, S, on_one, "8 shards on cuda:0")
    del R, S
    _, cap, _, buckets = dist_landings(dev)
    check_pull_cards(buckets, cap, on_one, "8 shards on cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mapping.txt")
        with open(path, "w") as f:
            f.write(f"{DIST_SHARDS} {' '.join(['0'] * DIST_SHARDS)}\n")
        argv = ["-a", "m-way", "-n", str(DIST_SHARDS), "-r", str(MAIN_N),
                "-s", str(MAIN_N), "--mapping-file", path]
        reset_launches()
        rc, stdout = run_cli(argv)
        torch.cuda.synchronize()
        counts = launches()
    log(f"[mesh] cli.main({argv[:-1]} <{DIST_SHARDS} 0s>) -> rc {rc}, "
        f"launches {counts}")
    if rc != 0 or results_of(stdout) != MAIN_N:
        raise AssertionError(f"--mapping-file: rc {rc}, {stdout!r}")
    check_launched("--mapping-file", counts, ("K1", "K2", "K3"))
    for k, v in counts.items():
        total[k] += v
    if count < 2:
        log("[mesh] the cross-card legs did not run: this machine has one "
            "card, and they need a second")
        return total
    spread = [torch.device("cuda", me % count) for me in range(DIST_SHARDS)]
    label = f"8 shards over {count} cards"
    mesh = make_mesh(DIST_SHARDS, devices=spread)
    missing = rf.peer_pairs_missing(mesh)
    R, S = dist_relations(MAIN_N, dev)
    routes = [r for r in MESH_ROUTES if not (missing and r == "dma")]
    for k, v in mesh_routes(R, S, spread, label, routes).items():
        total[k] += v
    if missing:  # K11 pushes by peer writes: it refuses, never reroutes
        from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
        try:
            dm.dist_mway_join_count(R.keys, S.keys, MAIN_N, MAIN_N, mesh,
                                    remote_pull="dma")
        except ValueError as e:
            log(f"[mesh] {label}: pairs without peer access {missing}; dma "
                f"refuses: {e}")
        else:
            raise AssertionError(f"dma ran without peer access {missing}")
    del R, S
    if not missing:
        check_pull_cards(buckets, cap, spread, label)
    return total


def phase_dist_small(dev: torch.device) -> dict[str, int]:
    """At 16M x 16M: a 2 x 4 ``make_mesh2d`` run and ``overlap=True`` on 8
    shards (counted), and ``dist_join_count`` against the torch.sort
    baseline."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.parallel import dist_join, dist_mway
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import (make_mesh,
                                                              make_mesh2d)

    n = DIST_SMALL_N
    R, S = dist_relations(n, dev)
    total = {}
    for name, mesh, kw in (("2x4 mesh", make_mesh2d(2, 4, dev), {}),
                           ("overlap", make_mesh(DIST_SHARDS, dev),
                            {"overlap": True})):
        reset_launches()
        t0 = time.perf_counter()
        got = dist_mway.dist_mway_join_count(R.keys, S.keys, n, n, mesh,
                                             **kw)
        torch.cuda.synchronize()
        counts = launches()
        log(f"[dist] {name} {n} x {n}: {got} in "
            f"{time.perf_counter() - t0:.3f} s, launches {counts}")
        if got != (n, 0):
            raise AssertionError(f"dist {name}: {got}")
        check_launched(f"dist {name}", counts, ("K1", "K2", "K3"))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    t0 = time.perf_counter()
    got = dist_join.dist_join_count(R.keys, R.payloads, S.keys, S.payloads,
                                    n, n, make_mesh(DIST_SHARDS, dev))
    secs = time.perf_counter() - t0
    base = int(mergejoin.merge_join_count_torch(
        torch.sort(R.keys).values, torch.sort(S.keys).values, n, n))
    log(f"[dist] dist_join_count {n} x {n}: {got} in {secs:.3f} s; "
        f"torch.sort baseline {base}")
    if got != (base, 0) or base != n:
        raise AssertionError(f"dist_join_count {got} != baseline {base}")
    return total


def packed_sorted(keys: torch.Tensor, pays: torch.Tensor) -> torch.Tensor:
    """Rows as a multiset: their packed (key, payload) pairs sorted."""
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

    return torch.sort(sort_ops.pack_pairs(keys, pays)).values


def phase_dist_small_joins(dev: torch.device) -> dict[str, int]:
    """At 16M x 16M (unique R, foreign-key S): ``dist_mpass_join_count``
    with ``overlap=True`` on 8 shards and on a 2 x 4 mesh, and
    ``dist_join_materialize`` on the 2 x 4 mesh, whose rows must be S's
    (every S tuple matches once), each with its launches counted."""
    from avx_sort_merge_joins_tpu_torch.parallel import (dist_materialize,
                                                         dist_mpass)
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import (make_mesh,
                                                              make_mesh2d)

    n = DIST_SMALL_N
    R, S = dist_relations(n, dev)
    want = packed_sorted(S.keys, S.payloads)
    total = {}
    for name, need in (("m-pass overlap", ("K1", "K2", "K3", "K4")),
                       ("m-pass 2x4", ("K1", "K2", "K3", "K4")),
                       ("materialize 2x4", ("K1", "K2", "K5", "K6"))):
        mesh = make_mesh2d(2, 4, dev) if "2x4" in name else \
            make_mesh(DIST_SHARDS, dev)
        reset_launches()
        t0 = time.perf_counter()
        if name.startswith("m-pass"):
            got = dist_mpass.dist_mpass_join_count(
                R.keys, S.keys, n, n, mesh, overlap=name.endswith("overlap"))
        else:
            k, p, *got = dist_materialize.dist_join_materialize(
                R.keys, R.payloads, S.keys, S.payloads, n, n, mesh)
            got = tuple(got)
        torch.cuda.synchronize()
        counts = launches()
        log(f"[dist] {name} {n} x {n}: {got} in "
            f"{time.perf_counter() - t0:.3f} s, launches {counts}")
        if got != (n, 0):
            raise AssertionError(f"dist {name}: {got}")
        if name.startswith("materialize") and \
                not torch.equal(packed_sorted(k, p), want):
            raise AssertionError(f"dist {name}: rows != S's")
        check_launched(f"dist {name}", counts, need)
        if name.endswith("overlap") and counts["K4"] != 96:
            raise AssertionError(f"dist {name}: K4 {counts['K4']} != 96 "
                                 "(8 shards x 2 relations x (4 pair "
                                 "merges + 2 halving passes))")
        for k_, v in counts.items():
            total[k_] = total.get(k_, 0) + v
    return total


def phase_dist_materialize(dev: torch.device) -> dict[str, int]:
    """128M x 128M: ``dist_join_materialize`` over 8 shards against the
    one-device materializing join of the same relations; the rows must be
    equal as a multiset (a ``torch.sort`` of the packed pairs on the
    card).  Returns the distributed join's launches."""
    from avx_sort_merge_joins_tpu_torch.models.mway import \
        sortmergejoin_multiway
    from avx_sort_merge_joins_tpu_torch.parallel import dist_materialize
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh
    from avx_sort_merge_joins_tpu_torch.types import JoinConfig

    R, S = dist_relations(MAIN_N, dev)
    reset_launches()
    t0 = time.perf_counter()
    k, p, count, ov = dist_materialize.dist_join_materialize(
        R.keys, R.payloads, S.keys, S.payloads, MAIN_N, MAIN_N,
        make_mesh(DIST_SHARDS, dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    one = sortmergejoin_multiway(R, S, JoinConfig(materialize=True)) \
        .resultlist[0].results
    del R, S
    got = packed_sorted(k, p)
    del k, p
    same = torch.equal(got, packed_sorted(one.keys, one.payloads))
    log(f"[dist] dist_join_materialize {MAIN_N} x {MAIN_N} over "
        f"{DIST_SHARDS} shards: count {count}, overflow {ov}, {secs:.3f} s on "
        f"the host clock (staging included), launches {counts}; rows equal "
        f"the one-device join's ({one.num_tuples}) as a multiset: {same}")
    if (count, ov) != (MAIN_N, 0) or one.num_tuples != MAIN_N or not same:
        raise AssertionError(f"dist materialize: {count}, {ov}, {same}")
    check_launched("dist materialize", counts, DIST_PATHS["materialize"][1])
    return counts


def phase_dist_persist(dev: torch.device) -> dict[str, int]:
    """``-n 8 --materialize --persist`` at 1M x 1M: R.tbl, S.tbl and the
    streamed Out.tbl, which must equal the one-device materializing join
    of the same relations as a multiset (the payloads of ``-n 8``'s
    relations are numbered per shard, so ``-n 1``'s file holds other
    rows)."""
    from avx_sort_merge_joins_tpu_torch import cli, datagen
    from avx_sort_merge_joins_tpu_torch.models.mway import \
        sortmergejoin_multiway
    from avx_sort_merge_joins_tpu_torch.types import JoinConfig

    argv = ["-n", str(DIST_SHARDS), "--materialize", "-r", str(PERSIST_N),
            "-s", str(PERSIST_N)]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        rc, stdout = run_cli([*argv, "--persist", tmp])
        secs = time.perf_counter() - t0
        counts = launches()
        if rc != 0 or results_of(stdout) != PERSIST_N:
            raise AssertionError(f"dist persist: rc {rc}, {stdout!r}")
        sizes = {name: os.path.getsize(os.path.join(tmp, name))
                 for name in ("R.tbl", "S.tbl", "Out.tbl")}
        back = datagen.read_relation(os.path.join(tmp, "Out.tbl"),
                                     device=dev)
        back_s = datagen.read_relation(os.path.join(tmp, "S.tbl"),
                                       device=dev)
    R, S = cli.make_relations(cli.build_parser().parse_args(argv), dev)
    one = sortmergejoin_multiway(R, S, JoinConfig(materialize=True)) \
        .resultlist[0].results
    same = back.num_tuples == one.num_tuples == PERSIST_N and torch.equal(
        packed_sorted(back.keys, back.payloads),
        packed_sorted(one.keys, one.payloads))
    log(f"[dist persist] {PERSIST_N} x {PERSIST_N} in {secs:.3f} s "
        f"(generation, join and writes), bytes {sizes}, launches {counts}; "
        f"Out.tbl ({back.num_tuples} rows) equals the one-device join's "
        f"rows as a multiset: {same}")
    if not same or not torch.equal(back_s.keys, S.keys):
        raise AssertionError("dist persist: Out.tbl != the one-device rows")
    check_launched("dist persist", counts, DIST_PATHS["materialize"][1])
    return counts


def scale_launches() -> dict[str, int]:
    """The launches of one workload-A run (8 shards of 200,000,000 keys a
    relation), from the schedules the join runs: K1 once a shard and
    relation, K2 once a uniform level of each local sort and once a
    varlen level of each shard's received runs, K3 once a shard."""
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm

    n, shard = DIST_SHARDS, SCALE_N // DIST_SHARDS
    uniform = len(mw.merge_levels(shard, BLOCK, dm.FANIN_DEFAULT))
    varlen, nruns = 0, dm._pow2_runs(n)
    while nruns > 1:  # dm._merge_levels_varlen's levels
        nruns = -(-nruns // min(mw.greedy_fanin(dm.FANIN_DEFAULT), nruns))
        varlen += 1
    return {"K1": 2 * n, "K2": 2 * n * (uniform + varlen), "K3": n}


def phase_scale_kernels(dev: torch.device) -> None:
    """K1, each uniform K2 level, the varlen K2 and K3 at the 1.6B tier's
    shapes, exact against their plain versions: shard 0 of R and S (200M
    keys each, made by the tier's generator) through the local sort, then
    shard 0's received landings of the real exchange (8 runs at the
    bucket stride of slack 2, 50,003,968) through the varlen K2, and K3
    of the two merged landings.  These launches are comparisons and are
    not counted."""
    from avx_sort_merge_joins_tpu_torch.ops import mergejoin
    from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
    from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as dm
    from avx_sort_merge_joins_tpu_torch.parallel import exchange as ex
    from avx_sort_merge_joins_tpu_torch.parallel import scale
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    n, shard = DIST_SHARDS, SCALE_N // DIST_SHARDS
    mesh = make_mesh(n, dev)
    stacks = scale.make_workload_a_sharded(SCALE_N, SCALE_N, mesh)
    for name, col in (("R", stacks[0][0]), ("S", stacks[1][0])):
        runs = sort_ops.sort_blocks_plain(col, shard, BLOCK)
        record("K1", f"scale shard 0 of {name}, n={shard}",
               sort_ops.sort_blocks(col, shard, BLOCK), runs)
        for level in mw.merge_levels(shard, BLOCK, dm.FANIN_DEFAULT):
            _, span, nruns, w = level
            lens = (nruns, shard, span)
            want = mw.multiway_merge_plain(runs, w, lens)
            record("K2", f"scale shard 0 of {name} level={level}",
                   mw.multiway_merge(runs, w, lens)[0], want)
            runs = want
        del runs, want
    nv = ex.valid_counts(SCALE_N, shard, n)
    cap = ex.bucket_cap(shard, n, 2.0, dm.TILE_ELEMS)
    sorted_ = [[dm._local_sorted(st[me], BLOCK, dm.FANIN_DEFAULT, True)
                for me in range(n)] for st in stacks]
    del stacks
    bounds = dm._equidepth_bounds(mesh, *sorted_, nv, nv)
    merged = []
    for name, ks in zip("RS", sorted_):
        bflat, _, counts, ov = dm._cut_all(mesh, ks, nv, bounds, cap)
        recv, rcounts = mesh.all_to_all(bflat), mesh.all_to_all(counts)
        del bflat
        land, lens = recv[0].clone(), rcounts[0].clone()
        del recv
        total = int(lens.sum())
        log(f"[scale kernels] shard 0's landing of {name}: {n} runs of "
            f"stride {cap}, {total} live keys, lens {lens.tolist()}, "
            f"overflow {int(ov)}")
        want, wlens = mw.multiway_merge_varlen_plain(land, n, lens, cap)
        got, glens = mw.multiway_merge(land, n, lens=lens, stride=cap)
        record("K2", f"scale varlen landing of {name} ({n} x {cap})", got,
               want)
        if not torch.equal(glens, wlens):
            raise AssertionError("scale varlen K2: group lengths differ")
        merged.append((want, total))
        del land, got
    (mr, nr), (ms, ns) = merged
    record("K3", f"scale shard 0 {nr} x {ns}",
           mergejoin.merge_join_count_fused(mr, ms, nr, ns),
           mergejoin.merge_join_count_fused_plain(mr, ms, nr, ns))
    log_k3_time("a 1.6B-tier shard", mr, ms, nr, ns)


def phase_scale(env: dict, flags: list[str]) -> dict[str, int]:
    """Workload A through the CLI at 1.6B x 1.6B on 8 shards of the card,
    with ``env`` set: after ``empty_cache`` and a reset of the peak memory
    statistics, ``Results = 1600000000``, overflow 0, the scale tier's
    line, a ``[RECORD] m-way 8 1600000000 1600000000`` row (phased: with
    sort, merge1 and mergejoin columns) and exactly the launches of
    :func:`scale_launches`.  Prints the peak memory, the generation time
    and the slack the run ended at."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = [*SCALE_ARGV, *flags]
    reset_launches()
    t0 = time.perf_counter()
    try:
        rc, stdout, stderr = run_cli_full(argv)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    gen = re.search(r"relations ready in ([\d.]+) s", stderr)
    lut = re.search(r"Zipf quantile table of \d+ keys, z=[\d.]+: ([\d.]+) s",
                    stderr)
    tier = re.search(r"scale tier: slack ([\d.]+), overflow (\d+)", stderr)
    log(f"[scale] cli.main({argv}) {env} -> rc {rc} in "
        f"{time.perf_counter() - t0:.3f} s; generation "
        f"{gen.group(1) if gen else '?'} s"
        + (f" (the host's Zipf table {lut.group(1)} s)" if lut else "")
        + f"; peak device memory {peak:.3f} GB of {total:.3f}; slack "
        f"{tier.group(1) if tier else '?'}; launches {counts}")
    if rc != 0 or results_of(stdout) != SCALE_N:
        raise AssertionError(f"scale {argv} {env}: rc {rc}, {stdout!r}")
    if "[INFO ] scale tier: sharded on-device generation" not in stderr \
            or tier is None or tier.group(2) != "0":
        raise AssertionError(f"scale {argv}: not the scale tier, or overflow")
    rec = re.search(rf"^\[RECORD\] m-way {DIST_SHARDS} {SCALE_N} {SCALE_N} "
                    r"(.*)$", stderr, re.M)
    if rec is None:
        raise AssertionError(f"scale {argv}: no [RECORD] row")
    cols = [float(c) for c in rec.group(1).split()[:-1]]  # less the device
    # run part sort merge1 mergerest mergejoin ntuples total tput
    phased = env.get("SMJ_SCALE_PHASED", "1") == "1"
    if cols[7] <= 0 or (phased and min(cols[2], cols[3], cols[5]) <= 0):
        raise AssertionError(f"scale {argv}: [RECORD] columns {cols}")
    want = scale_launches()
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"scale {argv}: launches {counts}, want {want}")
    return counts


def phase_scalebench() -> dict[str, int]:
    """``scalebench`` at 134,217,728 keys on 1, 2, 4, 8 shards and a 2 x 4
    mesh, and with ``--algo m-pass`` and ``--algo mpsm`` at 16M (mpsm
    skips its 2 x 4 row); every count is checked inside against numpy."""
    reset_launches()
    t0 = time.perf_counter()
    for n, extra in ((SCALEBENCH_N, []),
                     (SCALEBENCH_SMALL_N, ["--algo", "m-pass"]),
                     (SCALEBENCH_SMALL_N, ["--algo", "mpsm"])):
        rows = [r for r in run_module("scalebench", [
            str(n), "--devices", "1,2,4,8,2x4", *extra]).splitlines()
            if r.strip()]
        if len(rows) != (4 if "mpsm" in extra else 5):
            raise AssertionError(f"scalebench {n} {extra}: rows {rows}")
    torch.cuda.synchronize()
    counts = launches()
    log(f"[scalebench] in {time.perf_counter() - t0:.1f} s; launches "
        f"{counts}")
    check_launched("scalebench", counts, ("K1", "K2", "K3", "K4"))
    return counts


def phase_numa() -> dict[str, int]:
    """``tputbench --mode numa`` at 2^25 keys a shard on 8 shards: the
    all-to-all and the aggregation rows, the aggregate checked inside
    against numpy."""
    out = run_module("tputbench", ["--mode", "numa", "-n", str(NUMA_N)])
    if len(out.split()) != 4:
        raise AssertionError(f"tputbench numa: {out!r}")
    return {}


def phase_trace() -> dict[str, int]:
    """``-a m-way -r 16000000 -s 16000000 -o DIR``: the trace file, K1's,
    K2's and K3's kernels in it, and the device's busy share of the join's
    span (the CLI's ``join`` annotation: kernel time inside it over its
    length)."""
    argv = ["-a", "m-way", "-r", str(TRACE_N), "-s", str(TRACE_N)]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        rc, stdout = run_cli([*argv, "-o", tmp])
        counts = launches()
        path = os.path.join(tmp, "trace.json")
        if rc != 0 or results_of(stdout) != TRACE_N \
                or not os.path.isfile(path):
            raise AssertionError(f"-o: rc {rc}, {stdout!r}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {k: sum(1 for e in kernels if re.search(pat, e["name"]))
             for k, pat in (("K1", r"block_sort_kernel"),
                            ("K2", r"\bmerge_kernel|corank_kernel"),
                            ("K3", r"merge_join_count_kernel"))}
    join = [e for e in events if e.get("name") == "join"
            and e.get("cat") == "user_annotation"]
    if not join:
        raise AssertionError("-o: no join span in the trace")
    a, b = join[0]["ts"], join[0]["ts"] + join[0]["dur"]
    busy = sum(e["dur"] for e in kernels if a <= e["ts"] and
               e["ts"] + e["dur"] <= b)
    log(f"[trace] cli.main({argv} -o DIR): {size} bytes, {len(kernels)} "
        f"kernel events, by kernel {names}; the join's span "
        f"{(b - a) / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / (b - a):.1f}%); launches {counts}")
    if min(names.values()) == 0:
        raise AssertionError(f"-o: the trace lacks a kernel: {names}")
    return counts


def profile_breakdown(label: str, fn) -> None:
    """One run of ``fn`` under torch.profiler: the device time of each
    kernel name (the eight largest), the device's busy time over the span
    from its first kernel's start to its last's end, and the host wall
    time, the profiler's own cost included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError(f"{label}: the profiler saw no device time")
    busy = sum(e.device_time_total for e in events) / 1e3
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    by_name = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0]
        by_name[name] = by_name.get(name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {label}: device busy {busy:.3f} ms of a {span:.3f} ms "
        f"span ({100 * busy / span:.1f}%), {len(events)} device events, "
        f"wall {wall * 1e3:.3f} ms under the profiler; by kernel (ms): "
        + ", ".join(f"{k.strip()} {v:.3f}" for k, v in top))


def phase_dist_profiles(dev: torch.device) -> None:
    """Each 8-shard join at 128M x 128M once more under torch.profiler
    (:func:`profile_breakdown`), its count exact: where its device time
    goes and how busy the card is."""
    from avx_sort_merge_joins_tpu_torch.parallel import (dist_materialize,
                                                         dist_mpass,
                                                         dist_mpsm,
                                                         dist_mway)
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    R, S = dist_relations(MAIN_N, dev)
    mesh = make_mesh(DIST_SHARDS, dev)
    args = (R.keys, S.keys, MAIN_N, MAIN_N, mesh)
    for name, run in (
            ("m-way", lambda: dist_mway.dist_mway_join_count(*args)),
            ("m-pass", lambda: dist_mpass.dist_mpass_join_count(*args)),
            ("mpsm", lambda: dist_mpsm.dist_mpsm_join_count(*args)),
            ("materialize", lambda: dist_materialize.dist_join_materialize(
                R.keys, R.payloads, S.keys, S.payloads, MAIN_N, MAIN_N,
                mesh)[2:])):
        got = []
        profile_breakdown(f"-n 8 {name} {MAIN_N} x {MAIN_N}",
                          lambda: got.append(run()))
        if tuple(got[0]) != (MAIN_N, 0):
            raise AssertionError(f"profiled {name}: {got[0]}")


def phase_graft_entry(dev: torch.device) -> dict[str, int]:
    """``graft_entry.entry()``'s forward on the card: count 65,536, K1 2,
    K2 2, K3 1 launches."""
    from avx_sort_merge_joins_tpu_torch import graft_entry

    forward, inputs = graft_entry.entry(dev)
    reset_launches()
    t0 = time.perf_counter()
    cnt = int(forward(*inputs))
    counts = launches()
    log(f"[entry] {graft_entry.ENTRY_N} x {graft_entry.ENTRY_N}: count "
        f"{cnt} in {(time.perf_counter() - t0) * 1e3:.3f} ms; launches "
        f"{counts}")
    want = {"K1": 2, "K2": 2, "K3": 1}
    if cnt != graft_entry.ENTRY_N or any(counts[k] != v
                                         for k, v in want.items()):
        raise AssertionError(f"entry: count {cnt}, launches {counts}")
    return counts


def phase_dryrun(dev: torch.device) -> dict[str, int]:
    """``dryrun_multichip(n)`` for n = 2, 4, 8 on the card: every leg
    exact and launching its kernels (checked inside); each leg's launches
    printed."""
    from avx_sort_merge_joins_tpu_torch import graft_entry

    reset_launches()
    for n in (2, 4, 8):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            legs = graft_entry.dryrun_multichip(n, dev)
        log(out.getvalue().strip())
        for name, leg in legs.items():
            log(f"[dryrun] n={n} {name}: count {leg['count']}, launches "
                f"{leg['launches']}")
        if len(legs) != (8 if n == 2 else 9):
            raise AssertionError(f"dryrun {n}: legs {list(legs)}")
        log(f"[dryrun] n={n}: {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    return launches()


def phase_results_grid(dev: torch.device) -> dict[str, int]:
    """The port's results grid at its full sizes into a temporary
    ``SMJ_GRID_OUT``: 25 exact rows, then the renderer over them."""
    from avx_sort_merge_joins_tpu_torch.scripts import make_results_md as mr
    from avx_sort_merge_joins_tpu_torch.scripts import run_results_grid as rg

    torch.cuda.empty_cache()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "results_grid_torch.jsonl")
        saved = os.environ.get("SMJ_GRID_OUT")
        os.environ["SMJ_GRID_OUT"] = path
        try:
            if rg.main([]) != 0:
                raise AssertionError("results grid: exit code not 0")
        finally:
            if saved is None:
                os.environ.pop("SMJ_GRID_OUT")
            else:
                os.environ["SMJ_GRID_OUT"] = saved
        torch.cuda.synchronize()
        counts = launches()
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        for r in rows:
            log(f"[grid row] {json.dumps(r)}")
        keys = {r["key"] for r in rows}
        if len(rows) != GRID_ROWS or len(keys) != GRID_ROWS \
                or not all(r["exact"] for r in rows):
            raise AssertionError(f"results grid: {len(rows)} rows")
        big = f"scale/m-way/{GRID_SCALE_MAX}/cuda"
        if big not in keys:
            raise AssertionError(f"results grid: no {big} row")
        md = os.path.join(tmp, "RESULTS_TORCH.md")
        if mr.main(["--src", path, "--out", md]) != 0:
            raise AssertionError("make_results_md: exit code not 0")
        with open(md) as f:
            table = [line for line in f if line.startswith("| ")
                     and not line.startswith(("| algo |", "| n/side",
                                              "| z |", "| R |"))]
        if len(table) != GRID_ROWS:
            raise AssertionError(f"RESULTS_TORCH.md: {len(table)} rows")
    log(f"[grid] {len(rows)} rows, every one exact; launches {counts}")
    check_launched("results grid", counts,
                   ("K1", "K2", "K3", "K4", "K5", "K6", "K7"))
    return counts


def run_twin(name: str, env: dict, args=(), cwd=None):
    """Start the port's twin of a JAX experiment script (bash, this
    interpreter first on PATH) in ``cwd`` with the knobs of ``env``."""
    e = dict(os.environ)
    e["PATH"] = os.path.dirname(sys.executable) + os.pathsep + e["PATH"]
    e.update(env)
    return subprocess.Popen(
        ["bash", os.path.join(TWINS, name), *args], cwd=cwd, env=e,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_script_twins() -> None:
    """Each twin once with small knobs, side by side (their own timings
    are not kept), then ``workload-a.sh`` at full size alone: every exit
    code 0 and every output checked."""
    checks = {  # script -> (knobs, check of (its OUT text, its log text))
        "sort-bench.sh": ({"SIZES": "1 64"}, lambda o, _: len(
            o.splitlines()) == 16),
        "multiwaymerge-bench.sh": ({"FANINS": "4 2048"}, lambda o, _: len(
            o.splitlines()) == 18),
        "partitioning-bench.sh": ({"BITS": "2 16"}, lambda o, _: len(
            o.splitlines()) == 10),
        "cardinality.sh": ({"NR": "16000000", "REPS": "1"}, lambda o, _:
                           re.findall(r"^Results = (\d+)$", o, re.M) ==
                           [str(16_000_000 * r) for r in (1, 2, 4, 8, 16)]),
        "scalesize.sh": ({"SIZES": "1"}, lambda o, lg: o.strip() ==
                         f"Results = {32 << 20}" and
                         "peak device memory" in lg),
        "tput-scalability.sh": ({"NR": "16000000", "CHIPS": "1 8",
                                 "REPS": "1"}, lambda o, _: len(
            re.findall(r"^\[RECORD\] ", o, re.M)) == 12),
    }
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (env, _) in checks.items():
            os.makedirs(os.path.join(tmp, name))
            procs[name] = run_twin(name, env, cwd=os.path.join(tmp, name))
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=900)
            stem = os.path.join(tmp, name, name.replace(".sh", ""))
            with open(stem + ".txt") as f:
                out = f.read()
            with open(stem + ".log") as f:
                lg = f.read()
            for line in (out + lg).splitlines():
                log(f"[{name}] {line}")
            if proc.returncode != 0 or not checks[name][1](out, lg) \
                    or "Traceback" in lg + err:
                raise AssertionError(f"{name}: exit {proc.returncode}; "
                                     f"{err[-2000:]}")
            log(f"[twins] {name}: exit 0 at {time.perf_counter() - t0:.1f} "
                "s")
        torch.cuda.empty_cache()
        proc = run_twin("workload-a.sh", {}, cwd=tmp)
        out, err = proc.communicate(timeout=900)
    for line in (err + out).splitlines():
        log(f"[workload-a.sh] {line}")
    if proc.returncode != 0 or f"[workload-a] PASS: count == |S| == " \
            f"{SCALE_N} over {DIST_SHARDS} shards" not in out:
        raise AssertionError(f"workload-a.sh: exit {proc.returncode}")
    log(f"[twins] 7 scripts in {time.perf_counter() - t0:.1f} s")


def timed(name: str, fn, *args):
    """fn(*args), its wall time printed as a [phase] line."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    times = Timings()
    timed("kernels", phase_kernels, dev, times)
    timed("pair kernels", phase_pair_kernels, dev, times)
    timed("path shapes", phase_path_shapes, dev)
    timed("pair merge kernels", phase_pair_merge_kernels, dev, times)
    timed("merge edges", phase_merge_edges, dev)
    timed("k4 edges", phase_k4_edges, dev)
    timed("hist kernels", phase_hist_kernels, dev, times)
    timed("count2 kernel", phase_count2_kernel, dev, times)
    buckets, cap = timed("dist kernels", phase_dist_kernels, dev, times)
    timed("k11 sass", phase_k11_sass)
    timed("resources", phase_merge_resources)
    timed("pull kernels", phase_pull_kernels, dev, times, buckets, cap)
    timed("k4 varlen shape", phase_k4_varlen_shape, dev, buckets, cap)
    del buckets
    total = {k: 0 for k in KERNELS}
    for name, fn, *args in [
            *((p, phase_path, p) for p in PATHS),
            ("pair sort", phase_pair_sort, dev),
            ("materialize in process", phase_materialize_in_process, dev),
            ("count2 route", phase_count2_route, dev),
            ("partitioning", phase_partitioning),
            ("benches", phase_benches),
            ("-n 8", phase_dist_cli, "m-way", [], MAIN_N),
            ("-n 8 -S RING", phase_dist_cli, "m-way", ["-S", "RING"],
             DIST_SMALL_N),
            ("-n 8 -S RANDOM", phase_dist_cli, "m-way", ["-S", "RANDOM"],
             DIST_SMALL_N),
            ("dist emulate", phase_dist_emulate, dev),
            ("dist dma", phase_dist_dma, dev),
            ("mesh of cards", phase_mesh_cards, dev),
            ("dist small", phase_dist_small, dev),
            ("-n 8 -z 1.0", phase_dist_cli, "m-way", ["-z", "1.0"],
             DIST_SMALL_N),
            *((f"-n 8 {p}", phase_dist_cli, p, [], MAIN_N)
              for p in ("m-pass", "mpsm", "materialize")),
            ("dist small joins", phase_dist_small_joins, dev),
            ("-n 8 mpsm -z 1.0", phase_dist_cli, "mpsm", ["-z", "1.0"],
             DIST_SMALL_N),
            ("dist materialize", phase_dist_materialize, dev),
            ("dist persist", phase_dist_persist, dev),
            ("scalebench", phase_scalebench),
            ("tputbench numa", phase_numa),
            ("-o trace", phase_trace)]:
        for k, v in timed(name, fn, *args).items():
            total[k] += v
    torch.cuda.empty_cache()
    timed("scale kernels", phase_scale_kernels, dev)
    for name, env, flags in (
            ("scale", {"SMJ_SCALE_PHASED": "1"}, []),
            ("scale fused", {"SMJ_SCALE_PHASED": "0"}, []),
            ("scale -z 1.0", {"SMJ_SCALE_PHASED": "1"}, ["-z", "1.0"])):
        for k, v in timed(name, phase_scale, env, flags).items():
            total[k] += v
    timed("dist profiles", phase_dist_profiles, dev)
    timed("persist", phase_persist, dev)
    timed("key8b scalarsort", phase_key8b_scalar)
    timed("non-unique", phase_nonunique, dev)
    timed("zipf", phase_zipf, dev)
    for name, fn, *args in [("graft entry", phase_graft_entry, dev),
                            ("dryrun", phase_dryrun, dev)]:
        for k, v in timed(name, fn, *args).items():
            total[k] += v
    timed("merge tiles", phase_merge_tiles, dev)
    for name, fn, *args in [("-m", phase_cli_m),
                            ("results grid", phase_results_grid, dev)]:
        for k, v in timed(name, fn, *args).items():
            total[k] += v
    timed("script twins", phase_script_twins)
    src = "avx_sort_merge_joins_tpu_torch/csrc/"
    ref = "avx_sort_merge_joins_tpu/"
    kernels = [{"name": name, "route": "cuda", "source": src + f,
                "replaces": ref + line, "launches": total[k],
                "max_abs_err": ERR[k], **times.entry(k)}
               for k, (name, f, line) in KERNELS.items()]
    log(f"[done] smoke run {time.perf_counter() - t_start:.1f} s")
    log(card)  # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
