"""A small run of each cell on the CPU prints the contract's last line;
the harness refuses a run without a card, without the program, or with a
module of JAX loaded."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from joinbench import run, spec

ROOT = spec.default_root()
BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = "4294967311"  # past 32 bits


def _cli(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-m", "joinbench", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def _e2e(cell, trace):
    key = "per_layer" if trace else "end_to_end"
    return {m["name"] for m in BENCH[key] if spec.applies(m, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_small_cpu_run_prints_the_contract_line(cell):
    p = _cli(["--workload", cell, "--seed", SEED, "--seconds", "0.5",
              "--trace", "0", "--device", "cpu", "--tuples", "40000"])
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    # peak memory is a device reading: a CPU run leaves it out
    assert set(res["metrics"]) == _e2e(cell, False) - {"peak_mem_gb"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["device"]["platform"] == "cpu"
    # each compared number beside its limit, last on stderr and last in
    # the line
    lines = p.stderr.splitlines()[-len(res["checks"]):]
    assert lines == [f"check {k} {v['value']} limit {v['limit']}"
                     for k, v in res["checks"].items()]
    assert any(line.startswith("[setup] ") for line in p.stdout.splitlines())


@pytest.mark.parametrize("cell", ["wlB_128M.mway_count",
                                  "wlA_1600M.mway_zipf1"])
def test_small_cpu_traced_run_reports_per_layer_metrics(cell):
    p = _cli(["--workload", cell, "--seed", SEED, "--seconds", "0.5",
              "--trace", "1", "--device", "cpu", "--tuples", "40000"])
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert list(res) == KEYS and res["correct"] is True
    # no device on the CPU: the trace's readers find nothing
    assert set(res["metrics"]) <= _e2e(cell, True)
    assert set(res["metrics"]).isdisjoint({"kern.sort_roofline",
                                           "kern.merge_roofline",
                                           "device.idle_pct"})


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "avx_sort_merge_joins_tpu_torch_x",
                        sys)
    monkeypatch.setitem(sys.modules, "jax_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "avx_sort_merge_joins_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["avx_sort_merge_joins_tpu", "jaxlib"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", CELLS[0], "--seed", SEED, "--seconds",
                   "0.1", "--device", "cpu", "--tuples", "20000"], out=out,
                  err=err)
    assert rc == 3
    assert not any(line.startswith("{") for line in
                   out.getvalue().splitlines())
    assert "jax" in err.getvalue()


def test_the_program_imports_no_jax():
    code = ("import sys; from joinbench import run; "
            "rc = run.main(['--workload', 'wlA_1600M.mway_uniform', "
            "'--seed', '5', '--seconds', '0.1', '--device', 'cpu', "
            "'--tuples', '16000']); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'avx_sort_merge_joins_tpu'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(["--workload", CELLS[0], "--seed", SEED, "--seconds", "1",
              "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(ROOT / "joinbench", tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cli(["--workload", CELLS[0], "--seed", SEED, "--seconds", "1",
              "--trace", "0", "--device", "cpu", "--tuples", "20000"],
             cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
