"""The readers of the program's spans and counters: each on a registry
filled under a CPU profiler by one join of its route, the trace reader on
a synthetic ``Trace``, and each giving nothing when nothing was recorded,
also where the program has no registry."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu_torch.parallel import scale
from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling
from joinbench import run, spec
from joinbench.trace import Trace

ROOT = spec.default_root()
SPAN_READERS = ("host.syncs", "dist.splitter_ms", "dist.exchange_ms",
                "ops.materialize_ms")


def _reader(name):
    return spec.load_module(ROOT, "metrics", name)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _record(joins, trace=None):
    return run.Record(16_000, 16_000, False, [{}] * joins, trace)


def _relations(n):
    g = torch.Generator().manual_seed(7)
    pay = torch.arange(n, dtype=torch.int32)
    return (Relation(torch.randperm(n, generator=g).to(torch.int32) + 1, pay,
                     n),
            Relation(torch.randint(1, n + 1, (n,), generator=g,
                                   dtype=torch.int32), pay.clone(), n))


def test_sharded_join_readers():
    n = 16_000
    R, S = _relations(n)
    mesh = make_mesh(8, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            scale.join_sharded(R.keys.view(8, -1), S.keys.view(8, -1), n, n,
                               mesh)
    tot = profiling.span_totals()
    rec = _record(2)
    assert _reader("host.syncs").read(rec) == 6.0
    assert _reader("dist.splitter_ms").read(rec) == pytest.approx(
        1e3 * tot["smj.dist.splitters"].device_s / 2)
    assert _reader("dist.exchange_ms").read(rec) == pytest.approx(
        1e3 * (tot["smj.dist.cut"].device_s
               + tot["smj.dist.exchange"].device_s) / 2)
    assert _reader("dist.splitter_ms").read(rec) > 0
    assert _reader("ops.materialize_ms").read(rec) is None


def test_materialize_reader():
    R, S = _relations(20_000)
    with profile(activities=[ProfilerActivity.CPU]):
        sortmergejoin_multiway(R, S, JoinConfig(materialize=True))
    rec = _record(1)
    assert _reader("ops.materialize_ms").read(rec) == pytest.approx(
        1e3 * profiling.span_totals()["smj.ops.materialize"].device_s)
    assert _reader("ops.materialize_ms").read(rec) > 0
    assert _reader("host.syncs").read(rec) == 2.0
    assert _reader("dist.exchange_ms").read(rec) is None


def test_nothing_recorded_reads_nothing():
    R, S = _relations(4_000)
    sortmergejoin_multiway(R, S)  # untraced: the registry stays empty
    for name in SPAN_READERS:
        assert _reader(name).read(_record(1)) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    for name in SPAN_READERS:
        assert _reader(name).read(_record(1)) is None


def _trace(host):
    # window 0-100; the device busy over 10-30 and 50-60
    return Trace((0, 100), [("k1", 10, 20), ("k2", 50, 10)], host, 30)


def test_idle_in_program_on_a_synthetic_trace():
    host = [("joinbench.join", 0, 40), ("smj.join", 0, 40),
            ("smj.phase.sort", 5, 30), ("joinbench.join", 45, 25),
            ("smj.join", 45, 25), ("aten::sum", 80, 5)]
    rec = _record(2, _trace(host))
    # in the joins 0-40 and 45-70: 40 - 20 + 25 - 10 idle
    assert _reader("device.idle_in_program_pct").read(rec) == \
        pytest.approx(35.0)
    assert _reader("device.idle_pct").read(rec) == pytest.approx(70.0)


def test_idle_in_program_clips_to_the_window_and_merges_nested_spans():
    host = [("smj.join", -20, 50), ("smj.join", 20, 5), ("smj.join", 90, 30)]
    rec = _record(2, _trace(host))
    # 0-30 (busy 10-30) and 90-100 (no device op)
    assert _reader("device.idle_in_program_pct").read(rec) == \
        pytest.approx(20.0)


def test_idle_in_program_without_the_span_or_a_trace_reads_nothing():
    reader = _reader("device.idle_in_program_pct")
    assert reader.read(_record(1)) is None
    assert reader.read(_record(1, _trace([("joinbench.join", 0, 90)]))) \
        is None
