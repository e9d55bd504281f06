"""The star-schema cell ``wlB_128M.mway_card16`` (|S| = 16 |R|) on the
CPU at a small size with its ratio kept: correct traced and untraced, not
correct with the path broken underneath, and its two span readers
(``mway.s_sort_ms``, ``mway.mergejoin_ms``) reading nothing untraced and the
registry's values traced."""

import io
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avx_sort_merge_joins_tpu_torch.models import mway
from avx_sort_merge_joins_tpu_torch.types import Relation
from avx_sort_merge_joins_tpu_torch.utils import profiling
from joinbench import run, spec
from test_joinbench_faults import answer_altered, half_of_s, sort_unchanged

ROOT = spec.default_root()
CELL = "wlB_128M.mway_card16"
READERS = ("mway.s_sort_ms", "mway.mergejoin_ms")
TUPLES = 20_000  # R in two blocks, S in 20: two K2 levels of S


def _reader(name):
    return spec.load_module(ROOT, "metrics", name)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # other test files of a session may load JAX; these tests judge correct
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    profiling.reset()
    yield
    profiling.reset()


def _run(trace=0, seed="3000000019"):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", CELL, "--seed", seed, "--seconds", "0.2",
                   "--trace", str(trace), "--device", "cpu", "--tuples",
                   str(TUPLES)], out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


def test_the_configuration_keeps_its_ratio_at_any_size():
    cell = spec.load_cell(ROOT, CELL)
    assert run.sizes(cell.config, None) == (128_000_000, 2_048_000_000)
    assert run.sizes(cell.config, TUPLES) == (TUPLES, 16 * TUPLES)
    assert cell.config["s_tuples"] < 2**31  # the generator's row ids


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


@pytest.mark.parametrize("fault", [sort_unchanged, half_of_s,
                                   answer_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert res["checks"]["count_gap_max"]["value"] > 0


def _record(joins):
    return run.Record(TUPLES, 16 * TUPLES, False, [{}] * joins)


def test_readers_read_nothing_untraced():
    g = torch.Generator().manual_seed(5)
    rk = torch.randperm(4000, generator=g).to(torch.int32) + 1
    sk = rk.repeat(16)
    mway.sortmergejoin_multiway(Relation(rk, None, 4000),
                                Relation(sk, None, 64_000))
    for name in READERS:
        assert _reader(name).read(_record(1)) is None


def test_readers_read_the_registry_traced():
    g = torch.Generator().manual_seed(6)
    rk = torch.randperm(TUPLES, generator=g).to(torch.int32) + 1
    sk = rk.repeat(16)[torch.randperm(16 * TUPLES, generator=g)]
    R, S = Relation(rk, None, TUPLES), Relation(sk, None, 16 * TUPLES)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            assert mway.sortmergejoin_multiway(R, S).totalresults == \
                16 * TUPLES
    tot = profiling.span_totals()
    rec = _record(2)
    assert _reader("mway.s_sort_ms").read(rec) == pytest.approx(
        1e3 * tot[mway.SORT_SPAN_S].device_s / 2)
    assert _reader("mway.mergejoin_ms").read(rec) == pytest.approx(
        1e3 * tot["smj.phase.mergejoin"].device_s / 2)
    assert all(_reader(name).read(rec) > 0 for name in READERS)


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    for name in READERS:
        assert _reader(name).read(_record(1)) is None
