"""The mpsm count route at many private S runs, as the benchmark's
``wlB_128M.mpsm_count`` drives it (T = 64): the count against a plain
histogram count on seeded random relations at T = 1, 3, 64 and past |S|,
and the route's spans and counters, on under a profiler session only.  CPU,
no JAX; the full size on the card is ``tests/test_torch_mpsm_gpu.py``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import mpsm
from avx_sort_merge_joins_tpu_torch.ops import mergejoin
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

N_R = 5_000
BLOCK = 1024  # the smallest block K1 takes: R merges in a K2 level
SPANS = ("smj.join", mpsm.SORT_SPAN_R, mpsm.SORT_SPAN_S)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _relations(kind, n_s, seed):
    """R the keys 1..N_R shuffled, or (``non_unique``) N_R draws of 500
    keys; S n_s foreign keys over R: R's keys tiled and shuffled (pk-fk),
    Zipf(1.0) draws over them, or draws of the same 500 keys."""
    g = torch.Generator().manual_seed(seed)
    if kind == "non_unique":
        rk = torch.randint(1, 501, (N_R,), generator=g, dtype=torch.int32)
        sk = torch.randint(1, 501, (n_s,), generator=g, dtype=torch.int32)
    else:
        rk = torch.randperm(N_R, generator=g).to(torch.int32) + 1
        if kind == "zipf":
            weights = 1.0 / torch.arange(1, N_R + 1, dtype=torch.float64)
            sk = rk[torch.multinomial(weights, n_s, replacement=True,
                                      generator=g)]
        else:
            sk = (torch.arange(n_s) % N_R + 1).to(torch.int32)
            sk = sk[torch.randperm(n_s, generator=g)]
    return Relation(rk, None, N_R), Relation(sk, None, n_s)


def _histogram_count(rk, sk):
    """sum over k of cntR(k) * cntS(k): R's histogram gathered at S."""
    hist = torch.bincount(rk.long(), minlength=int(sk.max()) + 1)
    return int(hist[sk.long()].sum())


# (|S|, T, live runs): |S| not a multiple of T; past |S| the runs are one
# key each, and at |S| = 100, T = 64 runs of two keys stop after 50
RUNS = [(7_001, 1, 1), (7_001, 3, 3), (7_001, 64, 64), (50, 64, 50),
        (100, 64, 50)]


@pytest.mark.parametrize("kind", ["pk_fk", "zipf", "non_unique"])
@pytest.mark.parametrize("n_s,runs,live", RUNS,
                         ids=[f"S{n}-T{t}" for n, t, _ in RUNS])
def test_count_is_the_histogram_count(kind, n_s, runs, live):
    R, S = _relations(kind, n_s, seed=n_s + runs)
    assert len(mpsm._chunks(n_s, runs)) == live
    res = mpsm.sortmergejoin_mpsm(R, S, JoinConfig(), nchunks=runs,
                                  block=BLOCK)
    want = _histogram_count(R.keys, S.keys)
    if kind == "pk_fk":
        assert want == n_s
    assert res.totalresults == want
    assert res.bytes_moved["mergejoin"] == 4 * (N_R * live + n_s)
    # the results grid's one-go route: the count summed on the device
    out = mpsm._mpsm_count_device(R.keys, S.keys, N_R, n_s, runs,
                                  block=BLOCK)
    assert out.dim() == 0 and out.dtype == torch.int64
    assert mergejoin.finish_count_fused(out) == want


@pytest.mark.parametrize("swap", ["scalar_sort", "scalar_merge"])
def test_scalar_swaps_at_64_runs(swap):
    R, S = _relations("non_unique", 7_001, seed=11)
    res = mpsm.sortmergejoin_mpsm(R, S, JoinConfig(**{swap: True}),
                                  nchunks=64, block=BLOCK)
    assert res.totalresults == _histogram_count(R.keys, S.keys)


@pytest.mark.parametrize("n_s,runs,live", [(7_001, 1, 1), (7_001, 64, 64),
                                            (100, 128, 100)],
                         ids=["T1", "T64", "T-past-S"])
def test_spans_counter_and_one_count_read_a_join(n_s, runs, live):
    R, S = _relations("pk_fk", n_s, seed=5)
    joins = 2
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(joins):
            assert mpsm.sortmergejoin_mpsm(
                R, S, nchunks=runs, block=BLOCK).totalresults == n_s
    tot = profiling.span_totals()
    for name in SPANS + ("smj.phase.sort", "smj.phase.mergejoin"):
        assert tot[name].calls == joins, name
        assert tot[name].device_s > 0, name
    assert tot[mpsm.RUNS].calls == live * joins
    # the chunks' counts are summed on the device and read once a join
    assert tot["smj.sync.count"].calls == joins
    assert tot[profiling.HOST_SYNCS].calls == joins  # no card to wait for
    sort_s = tot[mpsm.SORT_SPAN_R].host_s + tot[mpsm.SORT_SPAN_S].host_s
    assert sort_s <= tot["smj.phase.sort"].host_s


def test_nothing_is_recorded_without_a_session():
    R, S = _relations("pk_fk", 7_001, seed=6)
    assert mpsm.sortmergejoin_mpsm(R, S, nchunks=64,
                                   block=BLOCK).totalresults == 7_001
    assert profiling.span_totals() == {}
