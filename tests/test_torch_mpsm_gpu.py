"""The 128M x 128M mpsm count at T = 64 private S runs on the card (marker
``gpu``; skips without a CUDA device).  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_mpsm_gpu.py -q

* the phased mpsm count route (``sortmergejoin_mpsm(R, S, JoinConfig(),
  nchunks=64)``: R's K1 + K2 sort, 64 runs of 2,000,000 S keys sorted
  apart, 64 K3 counts each over all of R) equals a histogram count of the
  same relations, with 64 K3 launches a join;
* each of the 64 runs' K3 counts equals the histogram count of that run,
  over an S in which a fifth of the keys miss R, so that runs count
  differently and no wrong run can be offset by another;
* under a profiler session the spans ``smj.mpsm.sort.r`` and ``.s`` have
  positive device times that sum to at most the sort phase's, the counts
  lie inside ``smj.phase.mergejoin``, ``smj.mpsm.runs`` reads 64 and the
  host waits twice a join (the phases' sync and the count's read).

About 4-5 GB of the card at its peak.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.models import mpsm
from avx_sort_merge_joins_tpu_torch.ops import mergejoin
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N = 128_000_000
RUNS = 64


@pytest.fixture(scope="module")
def wl_b():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(64)
    rk = torch.randperm(N, generator=g, device=dev).to(torch.int32) + 1
    sk = torch.randperm(N, generator=g, device=dev).to(torch.int32) + 1
    yield Relation(rk, None, N), Relation(sk, None, N)
    profiling.reset()
    torch.cuda.empty_cache()


def _histogram_count(rk, sk):
    hist = torch.bincount(rk.long(), minlength=N + 1).to(torch.int32)
    return int(hist[sk.long()].sum(dtype=torch.int64))


def test_count_at_64_runs_is_the_histogram_count(wl_b):
    R, S = wl_b
    _build.reset_launches()
    res = mpsm.sortmergejoin_mpsm(R, S, JoinConfig(), nchunks=RUNS)
    assert _build.launches()["K3"] == RUNS
    want = _histogram_count(R.keys, S.keys)
    assert want == N
    assert res.totalresults == want


def test_each_run_count_is_its_histogram_count(wl_b):
    R, _ = wl_b
    dev = R.keys.device
    g = torch.Generator(device=dev).manual_seed(65)
    sk = torch.randint(1, N + N // 4 + 1, (N,), generator=g,
                       dtype=torch.int32, device=dev)
    chunks = mpsm._chunks(N, RUNS)
    assert len(chunks) == RUNS
    rks, sks = mpsm._sort_chunks(R.keys, sk, N, chunks, mpsm.FANIN_DEFAULT,
                                 mpsm.BLOCK_MPSM, False)
    hist = torch.bincount(R.keys.long(), minlength=N + N // 4 + 1).to(
        torch.int32)
    got = torch.stack([mergejoin.merge_join_count_fused(rks, run, N, ln)
                       for run, (_, ln) in zip(sks, chunks)]).tolist()
    want = [int(hist[sk[lo:lo + ln].long()].sum(dtype=torch.int64))
            for lo, ln in chunks]
    assert len(set(want)) > 1
    assert got == want
    res = mpsm.sortmergejoin_mpsm(R, Relation(sk, None, N), JoinConfig(),
                                  nchunks=RUNS)
    assert res.totalresults == sum(want)


def test_run_spans_lie_inside_the_phases(wl_b):
    R, S = wl_b
    mpsm.sortmergejoin_mpsm(R, S, JoinConfig(), nchunks=RUNS)  # warm
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = mpsm.sortmergejoin_mpsm(R, S, JoinConfig(), nchunks=RUNS)
    assert res.totalresults == N
    tot = profiling.span_totals()
    r, s = tot[mpsm.SORT_SPAN_R], tot[mpsm.SORT_SPAN_S]
    assert (r.calls, s.calls, tot["smj.join"].calls) == (1, 1, 1)
    assert r.device_s > 0 and s.device_s > 0
    assert r.device_s + s.device_s <= tot["smj.phase.sort"].device_s
    merge = tot["smj.phase.mergejoin"].device_s
    assert 0 < merge <= tot["smj.join"].device_s
    assert tot[mpsm.RUNS].calls == RUNS
    assert tot[profiling.HOST_SYNCS].calls == 2
    assert tot["smj.sync.count"].calls == 1
