"""The star-schema ratio on the phased m-way count route: R fixed and S at
|S| = ratio * |R| for the reference's cardinality sweep (ratio 1 to 16),
counted exactly against a plain histogram count; the level schedule at
the 128M x 2,048M deployment; and the per-relation spans and the K2 level
counter, on under a profiler session only.  CPU; the full size on the
card is ``tests/test_torch_card16_gpu.py``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import mway
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

N_R = 12_345  # not a multiple of a block
BLOCK = 1024  # the smallest block K1 takes: several levels at this size
SPANS = (mway.SORT_SPAN_R, mway.SORT_SPAN_S)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _relations(n_r, ratio, zipf, seed):
    """R the keys 1..n_r shuffled; S ratio * n_r foreign keys over R: each
    key ratio times, shuffled (pk-fk), or Zipf(1.0) draws over R's keys."""
    g = torch.Generator().manual_seed(seed)
    n_s = ratio * n_r
    rk = torch.randperm(n_r, generator=g).to(torch.int32) + 1
    if zipf:
        weights = 1.0 / torch.arange(1, n_r + 1, dtype=torch.float64)
        sk = rk[torch.multinomial(weights, n_s, replacement=True,
                                  generator=g)]
    else:
        sk = (torch.arange(n_s) % n_r + 1).to(torch.int32)
        sk = sk[torch.randperm(n_s, generator=g)]
    return (Relation(rk, torch.arange(n_r, dtype=torch.int32), n_r),
            Relation(sk, torch.arange(n_s, dtype=torch.int32), n_s))


def _histogram_count(rk, sk):
    """sum over k of cntR(k) * cntS(k): R's histogram gathered at S."""
    hist = torch.bincount(rk.long(), minlength=int(sk.max()) + 1)
    return int(hist[sk.long()].sum())


@pytest.mark.parametrize("zipf", [False, True], ids=["pkfk", "zipf1"])
@pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
def test_phased_count_at_each_ratio_is_the_histogram_count(ratio, zipf):
    R, S = _relations(N_R, ratio, zipf, seed=100 + ratio)
    res = mway.sortmergejoin_multiway(R, S, JoinConfig(), block=BLOCK)
    want = _histogram_count(R.keys, S.keys)
    assert res.totalresults == want
    if not zipf:
        assert want == ratio * N_R
    assert list(res.phases) == ["sort", "merge1", "mergerest", "mergejoin",
                                "total"]


@pytest.mark.parametrize("n,fanins,runs", [
    (2_048_000_000, [32, 16, 16, 16], [125_000, 3_907, 245, 16]),
    (128_000_000, [32, 16, 16], [7_813, 245, 16])],
    ids=["S", "R"])
def test_schedule_of_the_card16_deployment(n, fanins, runs):
    levels = mw.merge_levels(n, mway.BLOCK_MWAY, mway.FANIN_DEFAULT)
    assert [w for _, _, _, w in levels] == fanins
    assert [nruns for _, _, nruns, _ in levels] == runs
    stride, span, _, w = levels[-1]
    # the last level's region, W runs of span, covers every key; at
    # |S| = 2,048M it is 2^31 slots, past a 32-bit offset
    assert span * w >= n and stride == span
    if n > 2**30:
        assert span * w == 2**31


def test_k2_levels_a_join_read_9_here_and_8_at_workload_b():
    """9 and 8 at the JAX package's fan-in of 16; the default plan takes
    one level fewer a sort, 7 and 6."""
    def levels(n, fanin):
        return len(mw.merge_levels(n, mway.BLOCK_MWAY, fanin))

    for fanin, here, wlb in ((16, 9, 8), (mway.FANIN_DEFAULT, 7, 6)):
        assert levels(128_000_000, fanin) + levels(2_048_000_000,
                                                   fanin) == here
        assert 2 * levels(128_000_000, fanin) == wlb


@pytest.mark.parametrize("n_r,ratio,calls_r,calls_s,levels", [
    (N_R, 16, 2, 3, 3),  # R one level (sort, merge1), S two (and mergerest)
    (900, 16, 1, 2, 1),  # R one block: its sort alone
    (3_000, 1, 2, 2, 2),
    (900, 1, 1, 1, 0)])  # one block each: no level, no count
def test_spans_open_once_a_phase_that_sorts_or_merges(n_r, ratio, calls_r,
                                                      calls_s, levels):
    assert len(mw.merge_levels(n_r, BLOCK, mway.FANIN_DEFAULT)) + len(
        mw.merge_levels(ratio * n_r, BLOCK, mway.FANIN_DEFAULT)) == levels
    R, S = _relations(n_r, ratio, False, seed=7)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            mway.sortmergejoin_multiway(R, S, block=BLOCK)
    tot = profiling.span_totals()
    assert tot[mway.SORT_SPAN_R].calls == 2 * calls_r
    assert tot[mway.SORT_SPAN_S].calls == 2 * calls_s
    if levels:
        assert tot[mway.K2_LEVELS].calls == 2 * levels
    else:
        assert mway.K2_LEVELS not in tot
    # nested inside the phases: no more time than the sort and merges
    inside = sum(tot[s].host_s for s in SPANS)
    phases = sum(tot[f"smj.phase.{p}"].host_s
                 for p in ("sort", "merge1", "mergerest"))
    assert 0 < inside <= phases


def test_no_session_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction {name!r} while off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    R, S = _relations(N_R, 16, False, seed=11)
    res = mway.sortmergejoin_multiway(R, S, block=BLOCK)
    assert res.totalresults == 16 * N_R
    assert profiling.span_totals() == {}
