"""m-pass sort-merge join on one device, count only (counterpart of
``avx_sort_merge_joins_tpu/models/mpass.py:44-193``; reference:
src/joins/sortmergejoin_multipass.c).

The phases of the reference's record structure, each timed on the host
clock after a device sync:

  "sort"      -- K1 block sort of R and S (the in-cache sort of
                 partitions),
  "merge1"    -- the first K4 pairwise merge pass of each relation,
  "mergerest" -- the other log2(#blocks) - 1 passes
                 (mpass_fullmultipassmerge_phase's halving loop, :621-708),
  "mergejoin" -- the K3 match count (merge_join, joincommon.c:239-312).

Keys only, as m-way: the count never reads the payloads.  Both relations
sort ascending: the TPU package sorts S negated for its count kernel, and
the port drops that layout.  The block is the port's 16,384 keys, not the
TPU's 65,536 (a VMEM size, ``mpass.py:41``), so 128M keys take 13 passes,
not 11.  ``--scalarsort``/``--scalarmerge`` swap the pipeline for m-way's
``torch.sort`` baselines under one "sortmerge" phase, as the JAX package
does.
"""

from __future__ import annotations

from ..ops import mergejoin, sort as sort_ops
from ..params import BLOCKSIZE_DEFAULT
from ..types import JoinConfig, JoinResult, Relation
from . import common, mway

BLOCK_MPASS = BLOCKSIZE_DEFAULT


def merge_level(keys, n: int, level):
    """One keys-only ascending K4 pass, ``level = (nruns, span)``."""
    nruns, span = level
    return sort_ops.merge_pass(keys, None, (nruns, n, span))[0]


def merge_levels(keys, n: int, levels):
    """The K4 passes of ``levels`` one after another."""
    for level in levels:
        keys = merge_level(keys, n, level)
    return keys


def _mpass_count_device(rk, sk, nR: int, nS: int, block: int = BLOCK_MPASS,
                        scalar_sort: bool = False,
                        scalar_merge: bool = False):
    """Count-only m-pass join in one go, the phased join's pipeline
    without its syncs: K1 blocks, every K4 pass, the K3 count (an int64
    0-d tensor).  ``scalar_sort``/``scalar_merge`` take m-way's
    ``torch.sort`` baselines, as the phased join does."""
    if scalar_merge or scalar_sort:
        return mway._mway_count_device(rk, sk, nR, nS, mway.FANIN_DEFAULT,
                                       block, scalar_sort, scalar_merge)
    rks = merge_levels(sort_ops.sort_blocks(rk, nR, block), nR,
                       sort_ops.pair_levels(nR, block))
    sks = merge_levels(sort_ops.sort_blocks(sk, nS, block), nS,
                       sort_ops.pair_levels(nS, block))
    return mergejoin.merge_join_count_fused(rks, sks, nR, nS)


def sortmergejoin_multipass(R: Relation, S: Relation,
                            config: JoinConfig | None = None,
                            block: int = BLOCK_MPASS) -> JoinResult:
    config = config or JoinConfig()
    if config.materialize:
        raise NotImplementedError(
            "--materialize: the JAX package materializes on m-way only")
    nR, nS = R.num_tuples, S.num_tuples

    if config.scalar_merge or config.scalar_sort:
        def pipeline(_):
            return _mpass_count_device(R.keys, S.keys, nR, nS, block,
                                       config.scalar_sort,
                                       config.scalar_merge)

        stats, timings = common.run_phases({"sortmerge": pipeline},
                                           R.keys.device)
        return common.make_result(mergejoin.finish_count_fused(stats),
                                  nR, nS, timings)

    levels_r = sort_ops.pair_levels(nR, block)
    levels_s = sort_ops.pair_levels(nS, block)

    def sort_phase(_):
        return (sort_ops.sort_blocks(R.keys, nR, block),
                sort_ops.sort_blocks(S.keys, nS, block))

    def merge1_phase(pair):
        rks, sks = pair
        if levels_r:
            rks = merge_level(rks, nR, levels_r[0])
        if levels_s:
            sks = merge_level(sks, nS, levels_s[0])
        return rks, sks

    def mergerest_phase(pair):
        rks, sks = pair
        return (merge_levels(rks, nR, levels_r[1:]),
                merge_levels(sks, nS, levels_s[1:]))

    def join_phase(pair):
        return mergejoin.merge_join_count_fused(*pair, nR, nS)

    stats, timings = common.run_phases({"sort": sort_phase,
                                        "merge1": merge1_phase,
                                        "mergerest": mergerest_phase,
                                        "mergejoin": join_phase},
                                       R.keys.device)
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
