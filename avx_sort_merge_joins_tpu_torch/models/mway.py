"""m-way sort-merge join on one device, counting or materializing
(counterpart of ``avx_sort_merge_joins_tpu/models/mway.py:35-148,197-310``;
reference: src/joins/sortmergejoin_multiway.c).

The phases of the reference's record structure, each timed on the card
between CUDA events at its boundaries (on the CPU on the host clock), and
each a span ``smj.phase.<name>`` (``models/common.run_phases``); the join
is the span ``smj.join``:

  "sort"      -- K1 block sort of R and S (the in-cache sort of
                 partitions, :388-460),
  "merge1"    -- the first K2 k-way merge level of each relation,
  "mergerest" -- the remaining K2 levels (avx_multiway_merge, :463-556),
  "mergejoin" -- the K3 match count (merge_join, joincommon.c:239-312).

Inside the sort and merge phases each relation's work is a span of its
own, ``smj.mway.sort.r`` and ``smj.mway.sort.s`` (its K1 block sort, its
first K2 level, its other K2 levels: one span a phase that sorts or merges
it), and the counter ``smj.k2.levels`` adds the K2 levels launched
(``multiwaymerge.merge_level`` counts them, in every multiway sort).

Without a named ``fanin`` each relation merges in the default plan of its
run count (``multiwaymerge.plan_fanins``: workload B's 7,813 runs at 32,
16, 16); a named one merges greedily at it, as the JAX package does.

Both relations sort ascending: the TPU package sorts S negated so that its
count kernel can read S back to front; the port drops that layout.
``--scalarsort`` swaps K1+K2 for ``torch.sort``; ``--scalarmerge`` swaps the
whole pipeline for ``torch.sort`` and the tagged prefix-sum count.
``_mway_count_device`` under ``SMJ_COUNT2=1`` stops both sorts at two runs
and counts with K10; the phased join ignores the switch, as the JAX one
does.

With ``JoinConfig.materialize`` the join runs as one "sortmerge" phase: R
keys through K1 + K2, S tuples through K5 + K6 (the payload-carrying
multiway sort), then the matched S tuples ``<S-key, S-RID>``, replicated
per match pair when some R key repeats (``ops/materialize.py``).

``JoinConfig.mwaybufsize_bytes`` (``-m``; 0, the default, derives it) sizes
the K2 merge tile of the count's and the materializing join's keys-only
sorts (``multiwaymerge.merge_tile_for``), as the JAX m-way sizes its FIFO
tile from it; K6 keeps its tile.  The result is the same at every size.
"""

from __future__ import annotations

import os

import torch

from ..ops import materialize, mergejoin, multiwaymerge as mw
from ..params import BLOCKSIZE_DEFAULT
from ..types import JoinConfig, JoinResult, Relation, ThreadResult
from ..utils import profiling
from . import common

FANIN_DEFAULT = mw.FANIN_DEFAULT
BLOCK_MWAY = BLOCKSIZE_DEFAULT
SORT_SPAN_R, SORT_SPAN_S = "smj.mway.sort.r", "smj.mway.sort.s"
K2_LEVELS = mw.K2_LEVELS  # the counter of K2 levels launched


def _sort_to_two_runs(keys: torch.Tensor, n: int, block: int, levels):
    """The block sort and the merge levels of ``merge_levels_2runs``: the
    keys as two ascending runs."""
    ks = mw.sort_blocks_phase(keys, n, block)
    for level in levels:
        ks = mw.merge_level(ks, n, level)
    return ks


def _merge_levels(span: str, keys: torch.Tensor, n: int, levels,
                  tile: int) -> torch.Tensor:
    """One relation's K2 ``levels`` in the span ``span``; no span opens
    when there are none."""
    if not levels:
        return keys
    with profiling.span(span):
        for level in levels:
            keys = mw.merge_level(keys, n, level, tile=tile)
    return keys


def _mway_count_device(rk: torch.Tensor, sk: torch.Tensor, nR: int, nS: int,
                       fanin: int | None, block: int,
                       scalar_sort: bool = False,
                       scalar_merge: bool = False) -> torch.Tensor:
    """Count-only m-way join in one go: keys-only sorts and the fused count
    (an int64 0-d tensor).  ``scalar_sort``/``scalar_merge`` swap in the
    ``torch.sort`` baselines (the reference's --scalarsort/--scalarmerge,
    main.c:727-728).

    With ``SMJ_COUNT2=1`` in the environment (the JAX package's own switch,
    read at call time) both sorts stop at two runs
    (``merge_levels_2runs``) and the two-run count K10 takes the place of
    the last merge level; when either side ends at one run, both take the
    normal route (models/mway.py:97-116 of the JAX package)."""
    if scalar_merge or scalar_sort:
        rks = torch.sort(rk[:nR]).values
        sks = torch.sort(sk[:nS]).values
        if scalar_merge:
            return mergejoin.merge_join_count_torch(rks, sks, nR, nS)
        return mergejoin.merge_join_count_fused(rks, sks, nR, nS)
    if os.environ.get("SMJ_COUNT2", "0") == "1":
        levels_r, span_r, nruns_r = mw.merge_levels_2runs(nR, block, fanin)
        levels_s, span_s, nruns_s = mw.merge_levels_2runs(nS, block, fanin)
        if nruns_r == 2 and nruns_s == 2:
            return mergejoin.merge_join_count_fused2(
                _sort_to_two_runs(rk, nR, block, levels_r),
                _sort_to_two_runs(sk, nS, block, levels_s), nR, nS, span_r,
                span_s)
    rks = mw.multiway_sort(rk, nR, block, fanin)
    sks = mw.multiway_sort(sk, nS, block, fanin)
    return mergejoin.merge_join_count_fused(rks, sks, nR, nS)


def _mway_materialize_device(rk: torch.Tensor, sk: torch.Tensor,
                             sp: torch.Tensor, nR: int, nS: int,
                             fanin: int | None, block: int,
                             tile: int = mw.MERGE_TILE):
    """Materializing m-way join: sort R keys (K2 at merge tiles of
    ``tile``), sort S tuples, emit matched S tuples (<S-key, S-RID>,
    joincommon.c:272-284)."""
    rks = mw.multiway_sort(rk, nR, block, fanin, tile=tile)
    sks, sps = mw.multiway_sort(sk, nS, block, fanin, payloads=sp)
    return materialize.materialize_matches(rks, nR, sks, sps, nS)


def sortmergejoin_multiway(R: Relation, S: Relation,
                           config: JoinConfig | None = None,
                           fanin: int | None = FANIN_DEFAULT,
                           block: int = BLOCK_MWAY) -> JoinResult:
    with profiling.span("smj.join"):
        return _sortmergejoin_multiway(R, S, config or JoinConfig(), fanin,
                                       block)


def _sortmergejoin_multiway(R: Relation, S: Relation, config: JoinConfig,
                            fanin: int | None, block: int) -> JoinResult:
    nR, nS = R.num_tuples, S.num_tuples
    dev = R.keys.device
    tile = mw.merge_tile_for(config.mwaybufsize_bytes, fanin)

    if config.materialize:
        def pipeline(_):
            return _mway_materialize_device(R.keys, S.keys, S.payloads, nR,
                                            nS, fanin, block, tile)

        (ok, op, om, nm), timings = common.run_phases({"sortmerge": pipeline},
                                                      dev)
        with profiling.sync("matches"):
            matches = int(om.sum(dtype=torch.int64))
        if matches != nm:
            # some R key repeats: one output tuple per match pair
            # (joincommon.c:266-289 nested duplicate loops)
            ok, op, _ = materialize.expand_matches(ok, op, om, nm)
        result = common.make_result(matches, nR, nS, timings)
        result.resultlist = [ThreadResult(
            nresults=matches, shard_id=0,
            results=materialize.materialized_relation(ok, op, matches))]
        return result

    if config.scalar_merge or config.scalar_sort:
        def pipeline(_):
            return _mway_count_device(R.keys, S.keys, nR, nS, fanin, block,
                                      config.scalar_sort,
                                      config.scalar_merge)

        stats, timings = common.run_phases({"sortmerge": pipeline}, dev)
        return common.make_result(mergejoin.finish_count_fused(stats),
                                  nR, nS, timings)

    # phase-split run in the reference's record structure (PART SORT
    # MERGE1 MERGEREST MJOIN, joincommon.c:175-196); the partition phase
    # has no single-device analog and reports 0
    levels_r = mw.merge_levels(nR, block, fanin)
    levels_s = mw.merge_levels(nS, block, fanin)

    def sort_phase(_):
        with profiling.span(SORT_SPAN_R):
            rks = mw.sort_blocks_phase(R.keys, nR, block)
        with profiling.span(SORT_SPAN_S):
            sks = mw.sort_blocks_phase(S.keys, nS, block)
        return rks, sks

    def merge1_phase(pair):
        rks, sks = pair
        return (_merge_levels(SORT_SPAN_R, rks, nR, levels_r[:1], tile),
                _merge_levels(SORT_SPAN_S, sks, nS, levels_s[:1], tile))

    def mergerest_phase(pair):
        rks, sks = pair
        return (_merge_levels(SORT_SPAN_R, rks, nR, levels_r[1:], tile),
                _merge_levels(SORT_SPAN_S, sks, nS, levels_s[1:], tile))

    def join_phase(pair):
        return mergejoin.merge_join_count_fused(*pair, nR, nS)

    stats, timings = common.run_phases({"sort": sort_phase,
                                        "merge1": merge1_phase,
                                        "mergerest": mergerest_phase,
                                        "mergejoin": join_phase}, dev)
    result = common.make_result(mergejoin.finish_count_fused(stats), nR, nS,
                                timings)
    # read + write bytes per phase (keys only = 4 B per tuple)
    nt = nR + nS
    result.bytes_moved = {
        "sort": 2 * 4 * nt,
        "merge1": 2 * 4 * nt if (levels_r or levels_s) else 0,
        "mergerest": 2 * 4 * (nR * max(0, len(levels_r) - 1) +
                              nS * max(0, len(levels_s) - 1)),
        "mergejoin": 4 * nt,  # read-only count
    }
    return result
