"""The MPSM cell ``wlB_128M.mpsm_count`` (64 private S runs) on the CPU at
a small size: correct traced and untraced, not correct with the path
broken underneath (one run's count left out, the runs' sorts returning
their input, the count off by one), and its two span readers
(``mpsm.s_sort_ms``, ``mpsm.mergejoin_ms``) on a synthetic registry."""

import io
import json

import pytest

from avx_sort_merge_joins_tpu_torch.models import mpsm
from avx_sort_merge_joins_tpu_torch.ops import mergejoin
from avx_sort_merge_joins_tpu_torch.utils import profiling
from joinbench import run, spec
from test_joinbench_faults import _walk_count, sort_unchanged

ROOT = spec.default_root()
CELL = "wlB_128M.mpsm_count"
READERS = {"mpsm.s_sort_ms": mpsm.SORT_SPAN_S,
           "mpsm.mergejoin_ms": "smj.phase.mergejoin"}
TUPLES = 20_000  # 64 S runs of 313 keys (the last 281)


def _reader(name):
    return spec.load_module(ROOT, "metrics", name)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # other test files of a session may load JAX; these tests judge correct
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    profiling.reset()
    yield
    profiling.reset()


def _run(trace=0, seed="3000000037"):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", CELL, "--seed", seed, "--seconds", "0.2",
                   "--trace", str(trace), "--device", "cpu", "--tuples",
                   str(TUPLES)], out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


def test_the_configuration_is_workload_b_at_64_runs():
    cell = spec.load_cell(ROOT, CELL)
    assert run.sizes(cell.config, None) == (128_000_000, 128_000_000)
    assert cell.config["s_runs"] == 64
    assert len(mpsm._chunks(TUPLES, cell.config["s_runs"])) == 64


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"] == {"count_gap_max": {"value": 0, "limit": 0}}
    if trace:
        assert set(res["metrics"]) == set(READERS)
        assert all(res["metrics"][m]["value"] > 0 for m in READERS)
    else:
        assert {"join_tput", "setup_s"} <= set(res["metrics"])


def one_run_left_out(mp):
    """The first S run's count left out of the sum."""
    count = mpsm._count_chunks

    def fewer(sorted_, nR, chunks, scalar_merge):
        rks, schunks = sorted_
        return count((rks, schunks[1:]), nR, chunks[1:], scalar_merge)

    mp.setattr(mpsm, "_count_chunks", fewer)


def runs_unsorted(mp):
    """The S runs' sorts return their input: R sorted, each run as it
    came, counted as K3 reads it (one merge walk)."""
    sort = mpsm._sort_chunks

    def unsorted(rk, sk, nR, chunks, fanin, block, scalar):
        rks, _ = sort(rk, sk, nR, [], fanin, block, scalar)
        return rks, [sk[lo:lo + ln] for lo, ln in chunks]

    mp.setattr(mpsm, "_sort_chunks", unsorted)
    mp.setattr(mergejoin, "merge_join_count_fused", _walk_count)


def count_off_by_one(mp):
    """The count read to the host one too many."""
    finish = mergejoin.finish_count_fused
    mp.setattr(mergejoin, "finish_count_fused", lambda c: finish(c) + 1)


@pytest.mark.parametrize("fault", [one_run_left_out, runs_unsorted,
                                   sort_unchanged, count_off_by_one],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert res["checks"]["count_gap_max"]["value"] > 0


def _record(joins):
    return run.Record(TUPLES, TUPLES, False, [{}] * joins)


def test_readers_read_a_synthetic_registry(monkeypatch):
    registry = {name: profiling.SpanTotal(calls=3, host_s=1.0,
                                          device_s=0.5 + i)
                for i, name in enumerate(READERS.values())}
    monkeypatch.setattr(profiling, "span_totals", lambda: registry)
    for name, span in READERS.items():
        assert _reader(name).read(_record(4)) == pytest.approx(
            1e3 * registry[span].device_s / 4)
        assert _reader(name).read(_record(0)) is None


@pytest.mark.parametrize("registry", [{}, None], ids=["empty", "absent"])
def test_readers_read_nothing_without_their_spans(registry, monkeypatch):
    if registry is None:
        monkeypatch.delattr(profiling, "span_totals")
    else:
        monkeypatch.setattr(profiling, "span_totals", lambda: registry)
    for name in READERS:
        assert _reader(name).read(_record(1)) is None
