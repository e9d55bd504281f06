"""The 128M x 2,048M count on the card (marker ``gpu``; skips without a
CUDA device).  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_card16_gpu.py -q

* the phased m-way count route (``sortmergejoin_multiway``, K1, the K2
  levels, K3) over |R| + |S| = 2,176,000,000 merge-path positions, past
  2^31, equals a histogram count of the same relations;
* under a profiler session the spans ``smj.mway.sort.r`` and ``.s`` have
  positive device times that sum to at most those of the sort and merge
  phases, and ``smj.k2.levels`` reads 7 (R in 3 levels, S in 4).

About 43 GB of the card at its peak.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import mway
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N_R, N_S = 128_000_000, 2_048_000_000
CHUNK = 1 << 26
# odd and prime to 5: i -> i * MUL mod |S| permutes [0, |S|), |S| = 2^17 5^6
MUL = 2_654_435_761


@pytest.fixture(scope="module")
def card16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(16)
    rk = torch.randperm(N_R, generator=g, device=dev).to(torch.int32) + 1
    # S: the keys 1..|R| tiled 16 times, in the order of a multiplicative
    # permutation of the row ids: every key 16 times, spread over S
    sk = torch.empty(N_S, dtype=torch.int32, device=dev)
    for lo in range(0, N_S, CHUNK):
        i = torch.arange(lo, min(N_S, lo + CHUNK), dtype=torch.int64,
                         device=dev)
        sk[lo:lo + i.numel()] = (i * MUL % N_S) % N_R + 1
    del i
    yield Relation(rk, None, N_R), Relation(sk, None, N_S)
    profiling.reset()
    torch.cuda.empty_cache()


def _histogram_count(rk, sk):
    hist = torch.bincount(rk.long(), minlength=N_R + 1).to(torch.int32)
    total = 0
    for lo in range(0, sk.numel(), CHUNK):
        total += int(hist[sk[lo:lo + CHUNK].long()].sum(dtype=torch.int64))
    return total


def test_count_past_2_31_positions_is_the_histogram_count(card16):
    R, S = card16
    assert N_R + N_S > 2**31
    res = mway.sortmergejoin_multiway(R, S, JoinConfig())
    want = _histogram_count(R.keys, S.keys)
    assert want == N_S
    assert res.totalresults == want


def test_relation_spans_lie_inside_the_phases(card16):
    R, S = card16
    mway.sortmergejoin_multiway(R, S, JoinConfig())  # warm
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = mway.sortmergejoin_multiway(R, S, JoinConfig())
    assert res.totalresults == N_S
    tot = profiling.span_totals()
    r, s = tot[mway.SORT_SPAN_R], tot[mway.SORT_SPAN_S]
    assert (r.calls, s.calls) == (3, 3)
    assert r.device_s > 0 and s.device_s > 0
    phases = sum(tot[f"smj.phase.{p}"].device_s
                 for p in ("sort", "merge1", "mergerest"))
    assert r.device_s + s.device_s <= phases
    # S is 16 times R, and sorts in one more level
    assert s.device_s > 8 * r.device_s
    assert tot[mway.K2_LEVELS].calls == 7
    assert tot["smj.phase.mergejoin"].device_s > 0
