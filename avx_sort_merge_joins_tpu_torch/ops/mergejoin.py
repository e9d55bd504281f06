"""Merge-join match count: kernels K3, K7 and K10, their combine, the
tag-merge count and oracles (counterpart of
``avx_sort_merge_joins_tpu/ops/mergejoin.py``, lines 41-100, 432-530,
692-745 and 973-1101).

``merge_join_count_fused`` returns sum_k cntR(k) * cntS(k) over two
ascending key columns as an int64 0-d tensor.  On a CUDA tensor it
launches ``csrc/merge_join_count.cu``; on a CPU tensor it takes the plain
version ``merge_join_count_fused_plain``.  ``merge_join_count`` is the
second, independent exact count: two K4 pair-mode merges of R and S with
a source flag in the payload.  ``merge_join_count_fused64`` is the same
count over 64-bit keys given as two int32 planes per side (K7, in the same
source), with ``merge_join_count_fused64_plain`` beside it.
``merge_join_count_fused2`` is the count where each side holds two
ascending runs, the output of a multiway sort stopped one level early (K10,
in the same source), with ``merge_join_count_fused2_plain`` beside it.

TPU workarounds dropped: the ``(rows, 128)`` tiles, the front guard and
spare window rows, the negated-S and NOT-plane layouts (S is passed
ascending), and the base-2^30 count limbs
with their ``CountLimbOverflow`` flag -- the count is int64 throughout, so
a hot key with cntR * cntS >= 2^29 needs no recount.  K10 also drops the
4-way tagged select, the double-buffered windows and the ``ensure_rows``
spare rows: it runs K3's count over each (R run, S run) pair, all four in
one launch, and merges no run with another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from ..utils import profiling
from . import sort as sort_ops


def merge_join_count_fused_plain(rk: torch.Tensor, sk: torch.Tensor,
                                 nR: int, nS: int) -> torch.Tensor:
    """Plain version of K3: two ``torch.searchsorted`` per R key."""
    r, s = rk[:nR], sk[:nS]
    return (torch.searchsorted(s, r, right=True)
            - torch.searchsorted(s, r)).sum(dtype=torch.int64)


def merge_join_count_fused(rk: torch.Tensor, sk: torch.Tensor,
                           nR: int, nS: int) -> torch.Tensor:
    """Exact match count of ascending ``rk[:nR]`` and ``sk[:nS]`` in one
    read-only pass; returns an int64 0-d tensor on their device."""
    sort_ops._check_keys(rk, nR, "merge_join_count_fused")
    sort_ops._check_keys(sk, nS, "merge_join_count_fused")
    if rk.device != sk.device:
        raise ValueError(f"merge_join_count_fused: R on {rk.device}, "
                         f"S on {sk.device}")
    if rk.device.type == "cpu":
        return merge_join_count_fused_plain(rk, sk, nR, nS)
    out = torch.zeros((), dtype=torch.int64, device=rk.device)
    if nR == 0 or nS == 0:
        return out
    _build.launch("K3", "smj_merge_join_count", rk, rk.data_ptr(), nR,
                  sk.data_ptr(), nS, out.data_ptr())
    return out


def merge_join_count_fused64_plain(rhi: torch.Tensor, rlo: torch.Tensor,
                                   shi: torch.Tensor, slo: torch.Tensor,
                                   nR: int, nS: int) -> torch.Tensor:
    """Plain version of K7: two ``torch.searchsorted`` per R key over the
    packed int64 keys (``pack_pairs`` of (hi, lo_biased) is the key)."""
    return merge_join_count_fused_plain(
        sort_ops.pack_pairs(rhi[:nR], rlo[:nR]),
        sort_ops.pack_pairs(shi[:nS], slo[:nS]), nR, nS)


def merge_join_count_fused64(rhi: torch.Tensor, rlo: torch.Tensor,
                             shi: torch.Tensor, slo: torch.Tensor,
                             nR: int, nS: int) -> torch.Tensor:
    """Exact match count over 64-bit keys: R and S each as two int32
    planes (hi, lo with its sign bit flipped), ascending in lexicographic
    order, which is the int64 order.  Returns an int64 0-d tensor on their
    device."""
    name = "merge_join_count_fused64"
    sort_ops._check_keys(rhi, nR, name)
    sort_ops._check_payloads(rhi, rlo, nR, name)
    sort_ops._check_keys(shi, nS, name)
    sort_ops._check_payloads(shi, slo, nS, name)
    if rhi.device != shi.device:
        raise ValueError(f"{name}: R on {rhi.device}, S on {shi.device}")
    if rhi.device.type == "cpu":
        return merge_join_count_fused64_plain(rhi, rlo, shi, slo, nR, nS)
    out = torch.zeros((), dtype=torch.int64, device=rhi.device)
    if nR == 0 or nS == 0:
        return out
    _build.launch("K7", "smj_merge_join_count64", rhi, rhi.data_ptr(),
                  rlo.data_ptr(), nR, shi.data_ptr(), slo.data_ptr(), nS,
                  out.data_ptr())
    return out


def _two_runs(col: torch.Tensor, n: int, span: int):
    """The two runs of a two-run column: ``[0, min(n, span))`` and
    ``[span, n)`` (empty when ``n <= span``)."""
    cut = min(n, span)
    return col[:cut], col[cut:n]


def merge_join_count_fused2_plain(rk: torch.Tensor, sk: torch.Tensor,
                                  nR: int, nS: int, span_r: int,
                                  span_s: int) -> torch.Tensor:
    """Plain version of K10: :func:`merge_join_count_fused_plain` of each R
    run against each S run, summed."""
    out = torch.zeros((), dtype=torch.int64, device=rk.device)
    for r in _two_runs(rk, nR, span_r):
        for s in _two_runs(sk, nS, span_s):
            out += merge_join_count_fused_plain(r, s, r.numel(), s.numel())
    return out


def merge_join_count_fused2(rk: torch.Tensor, sk: torch.Tensor, nR: int,
                            nS: int, span_r: int,
                            span_s: int) -> torch.Tensor:
    """Exact match count where each side holds TWO ascending runs: run 0
    at ``[0, min(n, span))`` and run 1 at ``[span, n)``, the layout a
    multiway sort leaves when it stops at two runs
    (``multiwaymerge.merge_levels_2runs``; ``span`` is that side's final
    span).  Returns an int64 0-d tensor on their device, which
    :func:`finish_count_fused` takes as it takes K3's."""
    name = "merge_join_count_fused2"
    sort_ops._check_keys(rk, nR, name)
    sort_ops._check_keys(sk, nS, name)
    for n, span, side in ((nR, span_r, "R"), (nS, span_s, "S")):
        if span < 1 or n > 2 * span:
            raise ValueError(f"{name}: {side} has {n} keys, more than two "
                             f"runs of span {span}")
    if rk.device != sk.device:
        raise ValueError(f"{name}: R on {rk.device}, S on {sk.device}")
    if rk.device.type == "cpu":
        return merge_join_count_fused2_plain(rk, sk, nR, nS, span_r, span_s)
    out = torch.zeros((), dtype=torch.int64, device=rk.device)
    if nR == 0 or nS == 0:
        return out
    _build.launch("K10", "smj_merge_join_count2", rk, rk.data_ptr(), nR,
                  sk.data_ptr(), nS, span_r, span_s, out.data_ptr())
    return out


def finish_count_fused(out: torch.Tensor) -> int:
    """The combine step: the count as a Python int.  The TPU package joins
    two base-2^30 limbs here and raises on limb overflow; the port's count
    is already an exact int64."""
    with profiling.sync("count"):
        return int(out.item())


def _tag_merge(rk: torch.Tensor, sk: torch.Tensor, nR: int, nS: int,
               r_flag: int, s_flag: int) -> torch.Tensor:
    """The source flags of the merge of ascending R and S keys, each key
    tagged with its side's flag in the payload, so that the flags break
    ties (K4 in pair mode over the two-run layout)."""
    keys, flags, lens = sort_ops.two_run_layout(rk, sk, nR, nS, r_flag,
                                                s_flag)
    return sort_ops.merge_pass(keys, flags, lens)[1][:nR + nS]


def _position_sum(flags: torch.Tensor, flag: int) -> torch.Tensor:
    """Sum of the positions that hold ``flag``, in int64."""
    pos = torch.arange(flags.numel(), dtype=torch.int64, device=flags.device)
    return torch.where(flags == flag, pos, 0).sum()


def merge_join_count(rk_sorted: torch.Tensor, sk_sorted: torch.Tensor,
                     nR: int, nS: int):
    """The tag-merge count (counterpart of the JAX ``merge_join_count``,
    mergejoin.py:41-100): an exact match count independent of K3.

    Let M merge R and S with ties ordering R first (flags R=0, S=1) and M'
    with S first (R=1, S=0).  An R key's position in M' minus its position
    in M is its number of S matches, so the count is the sum of R's
    positions in M' minus the sum in M.  Both keys ascending (the TPU's
    descending S layout is dropped); the sums are int64 0-d tensors
    (no per-tile int32 pieces).  Combine with :func:`finish_count`.
    """
    sort_ops._check_keys(rk_sorted, nR, "merge_join_count")
    sort_ops._check_keys(sk_sorted, nS, "merge_join_count")
    if rk_sorted.device != sk_sorted.device:
        raise ValueError(f"merge_join_count: R on {rk_sorted.device}, "
                         f"S on {sk_sorted.device}")
    r_first = _position_sum(_tag_merge(rk_sorted, sk_sorted, nR, nS, 0, 1),
                            0)
    s_first = _position_sum(_tag_merge(rk_sorted, sk_sorted, nR, nS, 1, 0),
                            1)
    return r_first, s_first


def finish_count(stats) -> int:
    """The count from :func:`merge_join_count`'s two position sums."""
    r_first, s_first = stats
    return int(s_first) - int(r_first)


def merge_join_count_torch(rk_sorted: torch.Tensor, sk_sorted: torch.Tensor,
                           nR: int, nS: int) -> torch.Tensor:
    """The ``torch.sort`` join baseline (the port of
    ``merge_join_count_xla``): one sort of tagged keys and a prefix sum per
    tie order, all in int64 so the count never wraps at 2^31.

    A key k tagged with 0 for R and 1 for S sorts as ``2k + tag``; the
    prefix count of S before each R key is then ``#S < k``.  With the tags
    swapped it is ``#S <= k``; the difference summed over R is the count.
    """
    keys = torch.cat([rk_sorted[:nR], sk_sorted[:nS]]).to(torch.int64)
    is_s = torch.cat([torch.zeros(nR, dtype=torch.int64, device=keys.device),
                      torch.ones(nS, dtype=torch.int64, device=keys.device)])

    def s_before_r(s_tag: int) -> torch.Tensor:
        # sum over R keys of the S keys sorted before them, S tagged s_tag
        tags = is_s if s_tag == 1 else 1 - is_s
        s_flag = (torch.sort(2 * keys + tags).values & 1) == s_tag
        return torch.cumsum(s_flag, 0)[~s_flag].sum()

    return s_before_r(0) - s_before_r(1)


def merge_join_count_numpy(rkeys: np.ndarray, skeys: np.ndarray) -> int:
    """NumPy reference oracle: sum_k cntR(k)*cntS(k)."""
    rk, rc = np.unique(rkeys, return_counts=True)
    sk, sc = np.unique(skeys, return_counts=True)
    inter, ri, si = np.intersect1d(rk, sk, assume_unique=True,
                                   return_indices=True)
    return int(np.sum(rc[ri].astype(np.int64) * sc[si].astype(np.int64)))
