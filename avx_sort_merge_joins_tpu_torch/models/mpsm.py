"""mpsm join on one device, count only (counterpart of
``avx_sort_merge_joins_tpu/models/mpsm.py:44-203``; Albutiu et al.,
PVLDB'12, "Massively Parallel Sort-Merge joins in main memory multi-core
database systems").  The reference registers mpsm but ships only a stub
(src/joins/sortmergejoin_mpsm.c:38-45); this follows the JAX package.

  "sort"      -- R is multiway-sorted once (K1 + K2); S is cut into
                 ``nchunks`` chunks and each chunk is sorted on its own,
                 never merged globally (mpsm's trade: no S shuffle),
  "mergejoin" -- one K3 count of all of R against each sorted S chunk,
                 summed on the device and read once.

This is the paper's basic variant (B-MPSM): every private S run is joined
against the whole of R, so R is read once a chunk.  Its P-MPSM
range-partitions the private input and searches each public run for the
matching range, reading about |R| + |S| in all; the JAX package, and so
the port, does not.

The join is the span ``smj.join``; R's sort is the span ``smj.mpsm.sort.r``
and the sorts of all the S chunks one span ``smj.mpsm.sort.s``; the counter
``smj.mpsm.runs`` adds the live S chunks a join.  They record only under a
profiler session (``utils/profiling.py``).

Keys only and ascending: the TPU package sorts the S chunks negated for
its count kernel, and the port drops that layout.  ``--scalarsort`` swaps
the sorts for ``torch.sort`` and keeps K3; ``--scalarmerge`` also swaps
the counts for the ``torch.sort`` count baseline.  Both keep the chunked
shape.
"""

from __future__ import annotations

import torch

from ..ops import mergejoin, multiwaymerge as mw
from ..params import BLOCKSIZE_DEFAULT
from ..types import JoinConfig, JoinResult, Relation
from ..utils import profiling
from . import common

NCHUNKS_DEFAULT = 4
FANIN_DEFAULT = 16
BLOCK_MPSM = BLOCKSIZE_DEFAULT
SORT_SPAN_R, SORT_SPAN_S = "smj.mpsm.sort.r", "smj.mpsm.sort.s"
RUNS = "smj.mpsm.runs"  # the counter of live S chunks


def _chunks(nS: int, nchunks: int):
    """``(start, length)`` of each non-empty S chunk of ``cdiv(nS,
    nchunks)`` keys; the chunks stop at the first empty one."""
    chunk = -(-nS // nchunks)
    out = []
    for c in range(nchunks):
        ln = min(chunk, nS - c * chunk)
        if ln <= 0:
            break
        out.append((c * chunk, ln))
    return out


def _sort_chunks(rk, sk, nR: int, chunks, fanin: int, block: int,
                 scalar: bool):
    """R sorted once and each S chunk of ``chunks`` on its own: K1 + K2,
    or ``torch.sort`` when ``scalar``.  R's sort is the span
    ``SORT_SPAN_R``, the chunks' sorts together the span ``SORT_SPAN_S``."""
    def sort(keys, n):
        if scalar:
            return torch.sort(keys[:n]).values
        return mw.multiway_sort(keys, n, block, fanin)

    with profiling.span(SORT_SPAN_R):
        rks = sort(rk, nR)
    with profiling.span(SORT_SPAN_S):
        sks = [sort(sk[lo:lo + ln], ln) for lo, ln in chunks]
    return rks, sks


def _count_chunks(sorted_, nR: int, chunks, scalar_merge: bool):
    """One count of all of sorted R against each sorted S chunk (K3, or
    the ``torch.sort`` count baseline), summed on the device: an int64 0-d
    tensor, so that the host reads the count once whatever the chunks."""
    rks, schunks = sorted_
    count = (mergejoin.merge_join_count_torch if scalar_merge
             else mergejoin.merge_join_count_fused)
    counts = [count(rks, sks, nR, ln) for sks, (_, ln) in zip(schunks, chunks)]
    if not counts:
        return torch.zeros((), dtype=torch.int64, device=rks.device)
    return torch.stack(counts).sum()


def _mpsm_count_device(rk, sk, nR: int, nS: int,
                       nchunks: int = NCHUNKS_DEFAULT,
                       fanin: int = FANIN_DEFAULT, block: int = BLOCK_MPSM,
                       scalar_sort: bool = False,
                       scalar_merge: bool = False):
    """Count-only mpsm join in one go, the phased join's pipeline without
    its syncs: the chunks' counts summed on the device, an int64 0-d
    tensor."""
    chunks = _chunks(nS, nchunks)
    return _count_chunks(
        _sort_chunks(rk, sk, nR, chunks, fanin, block,
                     scalar_sort or scalar_merge), nR, chunks, scalar_merge)


def sortmergejoin_mpsm(R: Relation, S: Relation,
                       config: JoinConfig | None = None,
                       nchunks: int = NCHUNKS_DEFAULT,
                       fanin: int = FANIN_DEFAULT,
                       block: int = BLOCK_MPSM) -> JoinResult:
    config = config or JoinConfig()
    if config.materialize:
        raise NotImplementedError(
            "--materialize: the JAX package materializes on m-way only")
    if nchunks < 1:
        raise ValueError(f"mpsm: nchunks {nchunks} < 1")
    with profiling.span("smj.join"):
        return _sortmergejoin_mpsm(R, S, config, nchunks, fanin, block)


def _sortmergejoin_mpsm(R: Relation, S: Relation, config: JoinConfig,
                        nchunks: int, fanin: int, block: int) -> JoinResult:
    nR, nS = R.num_tuples, S.num_tuples
    chunks = _chunks(nS, nchunks)
    profiling.count(RUNS, len(chunks))
    scalar = config.scalar_sort or config.scalar_merge

    def sort_phase(_):
        return _sort_chunks(R.keys, S.keys, nR, chunks, fanin, block, scalar)

    def join_phase(sorted_):
        return _count_chunks(sorted_, nR, chunks, config.scalar_merge)

    count, timings = common.run_phases({"sort": sort_phase,
                                        "mergejoin": join_phase},
                                       R.keys.device)
    result = common.make_result(mergejoin.finish_count_fused(count), nR, nS,
                                timings)
    chunk = -(-nS // nchunks)
    levels = len(mw.merge_levels(nR, block, fanin)) + 1
    levels_s = len(mw.merge_levels(chunk, block, fanin)) + 1
    result.bytes_moved = {
        "sort": 2 * 4 * (nR * levels + nS * levels_s),
        # every S chunk's count re-reads all of R (B-MPSM's scan of all runs)
        "mergejoin": 4 * (nR * len(chunks) + nS),
    }
    return result
