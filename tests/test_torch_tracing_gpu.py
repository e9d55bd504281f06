"""The port's spans and sync counter on the card (marker ``gpu``; each test
skips without a CUDA device).  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_gpu.py -q

* the ``smj.host_syncs`` count of one join on each route the benchmark
  drives equals the synchronizing operations PyTorch's sync debug mode
  reports plus the explicit ``torch.cuda.synchronize`` calls;
* the CUDA ``run_phases`` times each phase between events, with one
  synchronize at the end;
* a traced run of each benchmark cell at 2^23 keys reports each new
  per-layer metric in its cells and no other, and no ``smj.`` span lands
  among the device's operations.
"""

import io
import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import common, mway
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as mw
from avx_sort_merge_joins_tpu_torch.parallel import scale
from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

N = 1 << 23
NEW = {"host.syncs", "device.idle_in_program_pct", "dist.splitter_ms",
       "dist.exchange_ms", "ops.materialize_ms"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    profiling.reset()
    yield torch.device("cuda", 0)
    profiling.reset()


def _relations(dev, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    rk = torch.randperm(N, generator=g, device=dev).to(torch.int32) + 1
    sk = torch.randint(1, N + 1, (N,), generator=g, device=dev,
                       dtype=torch.int32)
    pay = torch.arange(N, dtype=torch.int32, device=dev)
    return Relation(rk, pay, N), Relation(sk, pay.clone(), N)


def _routes(dev):
    R, S = _relations(dev)
    mesh = make_mesh(8, device=dev)
    return {
        "mway_count": lambda: mway.sortmergejoin_multiway(R, S).totalresults,
        "mway_materialize": lambda: mway.sortmergejoin_multiway(
            R, S, JoinConfig(materialize=True)).totalresults,
        "join_sharded": lambda: scale.join_sharded(
            R.keys.view(8, -1), S.keys.view(8, -1), N, N, mesh)[0],
    }


def _watched(fn, monkeypatch):
    """``fn()`` under the sync debug mode, with ``torch.cuda.synchronize``
    counted: (its result, the warnings of synchronizing operations, the
    explicit synchronizes)."""
    explicit = []
    real = torch.cuda.synchronize

    def synchronize(*args):
        explicit.append(args)
        return real(*args)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        monkeypatch.setattr(torch.cuda, "synchronize", real)
    warned = [w for w in caught
              if "synchronizing CUDA operation" in str(w.message)]
    return got, warned, explicit


@pytest.mark.parametrize("route,want", [("mway_count", 2),
                                        ("mway_materialize", 3),
                                        ("join_sharded", 6)])
def test_sync_counter_equals_sync_debug_count(cuda, route, want,
                                              monkeypatch):
    fn = _routes(cuda)[route]
    assert fn() == N  # warm: the library built, every shape seen
    torch.cuda.synchronize()
    # the profiler's own start and stop stay outside the watch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got, warned, explicit = _watched(fn, monkeypatch)
    counted = profiling.span_totals()[profiling.HOST_SYNCS].calls
    assert got == N
    where = [f"{w.filename}:{w.lineno}" for w in warned]
    assert counted == len(warned) + len(explicit), where
    assert counted == want, where


def test_cuda_run_phases_times_between_events_with_one_sync(cuda,
                                                            monkeypatch):
    R, _ = _relations(cuda)
    n, block = N, mway.BLOCK_MWAY
    levels = mw.merge_levels(n, block, mway.FANIN_DEFAULT)

    def merge(ks):
        for level in levels:
            ks = mw.merge_level(ks, n, level)
        return ks

    phases = {"sort": lambda _: mw.sort_blocks_phase(R.keys, n, block),
              "merge1": merge, "mergejoin": lambda ks: ks[:n].sum()}
    common.run_phases(phases, cuda)  # warm
    (out, t), warned, waits = _watched(lambda: common.run_phases(phases, cuda),
                                       monkeypatch)
    assert len(waits) == 1 and not warned
    assert int(out) == N * (N + 1) // 2
    assert list(t) == ["sort", "merge1", "mergejoin", "total"]
    assert all(t[k] > 0 for k in ("sort", "merge1", "mergejoin"))
    assert t["sort"] + t["merge1"] + t["mergejoin"] <= t["total"]


def _cells():
    from joinbench import spec

    bench = spec.load_benchmark(spec.default_root())
    return bench, [w["name"] for w in bench["workloads"]]


@pytest.mark.parametrize("cell", ["wlB_128M.mway_count",
                                  "wlA_1600M.mway_uniform",
                                  "wlB_128M.mway_materialize",
                                  "wlA_1600M.mway_zipf1"])
def test_traced_cell_reports_the_new_metrics_in_its_cells(cuda, cell,
                                                          monkeypatch):
    from joinbench import run, spec
    from joinbench import trace as trace_mod

    bench, cells = _cells()
    assert cell in cells
    kept = []
    reduce = trace_mod.reduce
    monkeypatch.setattr(trace_mod, "reduce",
                        lambda prof: kept.append(reduce(prof)) or kept[-1])
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "4000000017", "--seconds",
                   "1", "--trace", "1", "--tuples", str(N)], out=out,
                  err=err)
    assert rc == 0, err.getvalue()[-3000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is True
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and spec.applies(m, cell)}
    got = set(res["metrics"]) & NEW
    assert got == want
    assert all(res["metrics"][m]["value"] > 0 for m in got)
    m = res["metrics"]
    assert m["device.idle_in_program_pct"]["value"] <= \
        m["device.idle_pct"]["value"]
    if cell == "wlB_128M.mway_count":
        assert m["host.syncs"]["value"] <= 2
    assert not [op for op in kept[0].ops if op[0].startswith("smj.")]
    assert not [name for name, _ in res["breakdown"]["device_ops"]
                if name.startswith("smj.")]
    assert any(name.startswith("smj.") for name, _, _ in kept[0].host)
