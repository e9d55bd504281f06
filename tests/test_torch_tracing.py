"""The port's spans and counters (``utils/profiling.py``): off outside a
profiler session, recorded under one, and the host syncs a join makes on
each route the benchmark drives, on the CPU.  The card's counts and the
CUDA phase timers: ``tests/test_torch_tracing_gpu.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import common, mway
from avx_sort_merge_joins_tpu_torch.ops import materialize
from avx_sort_merge_joins_tpu_torch.ops.mergejoin import \
    merge_join_count_numpy
from avx_sort_merge_joins_tpu_torch.parallel import dist_mway, scale
from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

SYNCS = profiling.HOST_SYNCS


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _relations(n, seed, dup=False):
    g = torch.Generator().manual_seed(seed)
    rk = torch.randperm(n, generator=g).to(torch.int32) + 1
    if dup:  # every R key twice: the expansion runs
        rk = (rk + 1) // 2
    sk = torch.randint(1, n + 1, (n,), generator=g, dtype=torch.int32)
    pay = torch.arange(n, dtype=torch.int32)
    return Relation(rk, pay, n), Relation(sk, pay.clone(), n)


def test_off_a_span_enters_no_record_function_and_records_nothing(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction {name!r} while off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.span("smj.a") is profiling.span("smj.b")
    with profiling.span("smj.a"), profiling.sync("read"):
        profiling.count("smj.n", 3)
    assert profiling.span_totals() == {}


def test_on_spans_nest_and_land_in_the_profiler_events():
    def body():
        with profiling.span("smj.outer"):
            assert profiling.recording()
            with profiling.span("smj.inner"):
                torch.ones(1000).sum()
            profiling.count("smj.n", 2)

    _, prof = _traced(body)
    ev = {e.name: e for e in prof.events()
          if e.name in ("smj.outer", "smj.inner")}
    assert set(ev) == {"smj.outer", "smj.inner"}
    # host events, not user annotations: the card's trace shows no
    # GPU-side copy of them among the device's operations
    assert not any(e.is_user_annotation for e in ev.values())
    outer, inner = ev["smj.outer"].time_range, ev["smj.inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    tot = profiling.span_totals()
    assert tot["smj.n"] == profiling.SpanTotal(2, 0.0, 0.0)
    assert tot["smj.outer"].calls == tot["smj.inner"].calls == 1
    assert tot["smj.outer"].host_s >= tot["smj.inner"].host_s > 0


def test_span_totals_and_reset():
    def body():
        for _ in range(3):
            with profiling.span("smj.x"):
                torch.ones(10).sum()
        with profiling.sync("read", 2):
            pass
        profiling.count(SYNCS)

    _traced(body)
    tot = profiling.span_totals()
    assert set(tot) == {"smj.x", "smj.sync.read", SYNCS}
    assert tot["smj.x"].calls == 3
    # no CUDA: the device seconds are the host seconds
    assert tot["smj.x"].device_s == tot["smj.x"].host_s > 0
    assert tot[SYNCS].calls == 3 and tot["smj.sync.read"].calls == 1
    assert profiling.span_totals() == tot  # reading resolves, not consumes
    profiling.reset()
    assert profiling.span_totals() == {}


def test_trace_starts_an_empty_registry(tmp_path):
    with profiling.trace(str(tmp_path)):
        profiling.count("smj.n")
    with profiling.trace(str(tmp_path)):
        profiling.count("smj.n")
    assert profiling.span_totals()["smj.n"].calls == 1
    assert (tmp_path / profiling.TRACE_FILE).exists()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_cpu_run_phases_keeps_its_keys_and_total(device):
    def slow(x):
        torch.ones(200_000).cumsum(0)
        return x

    out, t = common.run_phases({"sort": lambda _: 1, "merge1": slow,
                                "mergejoin": lambda x: x + 1}, device)
    assert out == 2
    assert list(t) == ["sort", "merge1", "mergejoin", "total"]
    assert all(v >= 0 for v in t.values())
    assert t["total"] >= t["sort"] + t["merge1"] + t["mergejoin"]


def _one_join(fn):
    got, _ = _traced(fn)
    return got, profiling.span_totals()


def test_host_syncs_of_the_mway_count():
    R, S = _relations(30_000, 1)
    res, tot = _one_join(lambda: mway.sortmergejoin_multiway(R, S))
    assert res.totalresults == 30_000
    # the count's read; the CPU has no device to wait for
    assert tot[SYNCS].calls == 1 and tot["smj.sync.count"].calls == 1
    assert tot["smj.join"].calls == 1
    for phase in ("sort", "merge1", "mergerest", "mergejoin"):
        assert tot[f"smj.phase.{phase}"].calls == 1


@pytest.mark.parametrize("dup,syncs", [(False, 2), (True, 4)])
def test_host_syncs_of_the_materializing_join(dup, syncs):
    R, S = _relations(20_000, 2, dup)
    res, tot = _one_join(lambda: mway.sortmergejoin_multiway(
        R, S, JoinConfig(materialize=True)))
    assert res.totalresults == merge_join_count_numpy(R.keys.numpy(),
                                                      S.keys.numpy())
    # nonzero and the match sum; with repeated R keys the two
    # repeat_interleave calls and a second materialize span
    assert tot[SYNCS].calls == syncs
    assert tot["smj.ops.materialize"].calls == (2 if dup else 1)
    assert tot["smj.sync.nonzero"].calls == tot["smj.sync.matches"].calls \
        == 1


def test_host_syncs_and_spans_of_the_sharded_join():
    n, shards = 16_000, 8
    R, S = _relations(n, 3)
    mesh = make_mesh(shards, device="cpu")
    got, tot = _one_join(lambda: scale.join_sharded(
        R.keys.view(shards, -1), S.keys.view(shards, -1), n, n, mesh))
    assert got == (n, 0)
    # bucket starts and live totals a relation, the live lengths, the sum
    assert tot[SYNCS].calls == 6
    assert tot["smj.sync.tolist"].calls == 5
    assert tot["smj.sync.host_sum"].calls == 1
    calls = {k: v.calls for k, v in tot.items() if k.startswith("smj.dist")}
    assert calls == {"smj.dist.sort": 1, "smj.dist.splitters": 1,
                     "smj.dist.cut": 2, "smj.dist.merge": 2 * shards,
                     "smj.dist.exchange": 2 * (1 + shards),
                     "smj.dist.count": 1}


def test_the_count_route_times_nothing_and_the_phased_one_three_times(
        monkeypatch):
    waits = []
    monkeypatch.setattr(dist_mway, "device_sync", waits.append)
    n = 8_000
    R, S = _relations(n, 4)
    mesh = make_mesh(4, device="cpu")
    assert dist_mway.dist_mway_join_count(R.keys, S.keys, n, n, mesh) == \
        (n, 0)
    assert waits == []
    count, ov, phases = dist_mway.dist_mway_join_phased(R.keys, S.keys, n, n,
                                                        mesh)
    assert (count, ov) == (n, 0) and len(waits) == 3
    assert list(phases) == ["sort", "merge1", "mergejoin", "total"]
    assert phases["total"] == pytest.approx(
        phases["sort"] + phases["merge1"] + phases["mergejoin"])


@pytest.mark.parametrize("nv", [[4000, 4000, 4000, 4000], [4000, 17, 0, 1]])
def test_splitter_samples_made_on_the_device_equal_the_formula(nv):
    """The sample positions min((nv // 16) * j, max(nv - 1, 0)) and the
    picks (ns * d) // n, as host lists, give the same bounds."""
    n = len(nv)
    rng = np.random.default_rng(5)
    cols = [torch.from_numpy(np.sort(rng.integers(1, 10**6, max(v, 1))
                                     .astype(np.int32))) for v in nv]
    mesh = make_mesh(n, device="cpu")
    got = dist_mway._equidepth_bounds(mesh, cols, cols, np.array(nv),
                                      np.array(nv))
    rows = []
    for c, v in zip(cols, nv):
        pos = [min((v // 16) * j, max(v - 1, 0)) for j in range(16)]
        rows.append(torch.stack([c[pos], c[pos]], 1).reshape(-1))
    samples = torch.sort(torch.cat(rows)).values
    want = [dist_mway.BOUND_MIN] + [
        int(samples[(samples.numel() * d) // n]) for d in range(1, n)]
    assert got.tolist() == want


def test_from_host_keeps_values_and_dtype():
    mesh = make_mesh(3, device="cpu")
    x = mesh.from_host([[1, 2], [3, 4], [5, 2**31 - 1]])
    assert x.dtype == torch.int32 and x.tolist() == [[1, 2], [3, 4],
                                                     [5, 2**31 - 1]]


def test_materialize_spans_wrap_the_ops():
    rk = torch.tensor([1, 2, 2, 5], dtype=torch.int32)
    sk = torch.tensor([2, 3, 5], dtype=torch.int32)
    sp = torch.tensor([7, 8, 9], dtype=torch.int32)

    def body():
        ok, op, om, nm = materialize.materialize_matches(rk, 4, sk, sp, 3)
        return materialize.expand_matches(ok, op, om, nm)

    (ek, ep, total), _ = _traced(body)
    assert ek.tolist() == [2, 2, 5] and ep.tolist() == [7, 7, 9]
    tot = profiling.span_totals()
    assert tot["smj.ops.materialize"].calls == 2
    assert tot[SYNCS].calls == 3
