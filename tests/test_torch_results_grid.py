"""The port's results grid (``avx_sort_merge_joins_tpu_torch/scripts/
run_results_grid.py``) and its renderer (``make_results_md.py``) on the
CPU at tiny sizes: every row exact, the runner resumable, the rows in the
committed JAX grid's format plus ``device``, the workload the JAX grid's,
and one table line a key."""

import importlib
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.scripts import make_results_md as mr
from avx_sort_merge_joins_tpu_torch.scripts import run_results_grid as rg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_ALGO = (3000, 5000)  # the second size takes the phase columns
TINY = {"algo": dict(sizes=N_ALGO, phases_from=5000),
        "key8b": dict(sizes=(3000, 4000)),
        "zipf": dict(n=4096),
        "card": dict(nR=3000),
        "scale": dict(mults=(1, 2, 4, 8, 16, 25), base=256)}


def _run_all(g):
    for name, kw in TINY.items():
        rg.GRIDS[name](g, **kw)


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "rows.jsonl")
    _run_all(rg.Grid(path, CPU, reps=1, burn=1))
    return path


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_every_row_exact_and_each_grid_has_its_cells(grid_file):
    rows = _rows(grid_file)
    keys = [r["key"] for r in rows]
    assert len(keys) == len(set(keys)) == 13 + 2 + 2 + 2 + 6
    for r in rows:
        assert r["exact"] is True and r["device"] == "cpu"
        assert r["reps"] == 1 and r["burn"] == 1
        assert r["ms"] > 0 and r["mtps"] > 0
    assert "algo/mpsm/5000/cuda/nchunks4" in keys
    assert "algo/mpsm/3000/cuda/nchunks4" not in keys
    assert {k for k in keys if k.startswith("algo/m-way/")} == {
        f"algo/m-way/{n}/{m}" for n in N_ALGO for m in ("cuda", "scalar")}
    assert "zipf/m-way/4096/z0.75" in keys and "zipf/m-way/4096/z1.0" in keys
    assert "card/m-way/3000x12000/cuda" in keys
    assert "scale/m-way/6400/cuda" in keys  # 25 x 256
    phased = {r["key"]: r.get("phases_ms") for r in rows
              if r["grid"] == "algo" and r["mode"] == "cuda"
              and "nchunks4" not in r["key"]}
    for key, ph in phased.items():
        assert (ph is not None) == ("/5000/" in key), key
    assert set(phased["algo/mpsm/5000/cuda"]) == {"sort", "mergejoin",
                                                  "total"}
    k8 = [r for r in rows if r["grid"] == "key8b"]
    assert all(set(r["phases_ms"]) == {"sort_r", "sort_s", "count"}
               for r in k8)


def test_second_run_writes_nothing(grid_file, capsys):
    before = open(grid_file).read()
    capsys.readouterr()
    _run_all(rg.Grid(grid_file, CPU, reps=1, burn=1))
    assert open(grid_file).read() == before
    skipped = re.findall(r"^\[grid\] skip \(done\): (\S+)$",
                         capsys.readouterr().out, re.M)
    assert sorted(skipped) == sorted(r["key"] for r in _rows(grid_file))


def _shape(key: str) -> str:
    """A row key with its sizes taken out and the JAX mode named as the
    port's: rows of one shape are the same kind of cell."""
    key = key.replace("/pallas", "/cuda")
    return re.sub(r"z[\d.]+$", "z", re.sub(r"\d+", "N", key))


def test_rows_carry_the_jax_rows_fields_and_device(grid_file):
    """Each row of the committed JAX grid has a port row of the same kind
    (key shape) with every one of its fields, and the port's rows add
    ``device``."""
    with open(os.path.join(ROOT, "results_grid.jsonl")) as f:
        jax_rows = [json.loads(line) for line in f if line.strip()]
    ours = _rows(grid_file)
    by_shape = {}
    for r in ours:
        by_shape.setdefault(_shape(r["key"]), []).append(set(r))
    assert set(by_shape) == {_shape(r["key"]) for r in jax_rows}
    for jr in jax_rows:
        assert any(set(jr) <= fields for fields in by_shape[_shape(jr["key"])]
                   ), jr["key"]
    assert all("device" in r for r in ours)
    assert not any("device" in jr for jr in jax_rows)


def test_workload_equals_the_jax_grid_workload():
    spec = importlib.util.spec_from_file_location(
        "jax_run_results_grid", os.path.join(ROOT, "scripts",
                                             "run_results_grid.py"))
    jgrid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgrid)
    jR, jS = jgrid.workload(4096)
    tR, tS = rg.workload(4096, CPU)
    for j, t in ((jR, tR), (jS, tS)):
        jk, jp = j.to_numpy()
        assert t.num_tuples == 4096
        np.testing.assert_array_equal(t.keys.numpy(), jk[:4096])
        np.testing.assert_array_equal(t.payloads.numpy(), jp[:4096])


def test_renderer_has_one_table_line_a_key(grid_file, tmp_path):
    with open(grid_file, "a") as f:  # a re-run row of a key: the last wins
        row = _rows(grid_file)[0]
        f.write(json.dumps({**row, "ms": 12345.678}) + "\n")
    rows = mr.load(grid_file)
    md = mr.render(rows)
    table = [line for line in md.splitlines()
             if line.startswith("| ") and not line.startswith("| algo |")
             and not line.startswith(("| n/side", "| z |", "| R |"))]
    assert len(table) == len(rows) == 25
    assert md.count("12345.678") == 1
    out = tmp_path / "R.md"
    assert mr.main(["--src", grid_file, "--out", str(out)]) == 0
    assert out.read_text() == md


def test_outputs_never_the_jax_files(tmp_path):
    assert rg.DEFAULT_OUT == os.path.join(ROOT, "results_grid_torch.jsonl")
    assert mr.DEFAULT_DST == os.path.join(ROOT, "RESULTS_TORCH.md")
    with pytest.raises(ValueError, match="JAX grid"):
        rg.Grid(os.path.join(ROOT, "results_grid.jsonl"), CPU)
    with pytest.raises(SystemExit):
        mr.main(["--src", str(tmp_path / "x.jsonl"), "--out",
                 os.path.join(ROOT, "RESULTS.md")])


def test_no_work_at_import(monkeypatch):
    """Importing the runner reads no file: the done keys are read when a
    ``Grid`` is made."""
    def refuse(*a, **k):
        raise AssertionError("a file was opened at import")
    monkeypatch.setattr("builtins.open", refuse)
    importlib.reload(rg)
    assert not hasattr(rg, "DONE")


def test_main_refuses_an_unknown_grid_and_runs_without_a_card(capsys):
    with pytest.raises(SystemExit):
        rg.main(["nope", "--device", "cpu"])
    if not torch.cuda.is_available():
        assert rg.main(["algo"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("key", ["algo/m-way/5000/cuda",
                                 "scale/m-way/512/cuda",
                                 "zipf/m-way/4096/z1.0"])
def test_rerun_cells_appends_a_row_the_renderer_keeps(grid_file, tmp_path,
                                                      monkeypatch, key):
    """``rerun_cells KEY`` (the twin of ``scripts/rerun_cells.py``) runs that
    one cell again at its own size: one row appended, exact, with the old
    row's columns (the algo row's phase columns), and the renderer keeps the
    new row."""
    from avx_sort_merge_joins_tpu_torch.scripts import rerun_cells

    path = tmp_path / "rows.jsonl"
    path.write_text(open(grid_file).read())
    before = _rows(str(path))
    old = mr.load(str(path))[key]
    monkeypatch.setenv("SMJ_GRID_OUT", str(path))
    monkeypatch.setenv("SMJ_GRID_REPS", "1")
    monkeypatch.setenv("SMJ_GRID_BURN", "0")
    assert rerun_cells.main([key, "--device", "cpu"]) == 0
    after = _rows(str(path))
    assert after[:len(before)] == before and len(after) == len(before) + 1
    new = after[-1]
    assert new["key"] == key and new["exact"] and new["reps"] == 1
    assert mr.load(str(path))[key] == new
    assert set(new) == set(old)
    assert len(mr.load(str(path))) == 25


def test_rerun_cells_refuses_an_unknown_key(grid_file, tmp_path, monkeypatch,
                                            capsys):
    from avx_sort_merge_joins_tpu_torch.scripts import rerun_cells

    path = tmp_path / "rows.jsonl"
    path.write_text(open(grid_file).read())
    monkeypatch.setenv("SMJ_GRID_OUT", str(path))
    for key in ("algo/m-way/7/cuda", "nope"):
        assert rerun_cells.main([key, "--device", "cpu"]) == 2
        assert "unknown cell keys" in capsys.readouterr().err
    assert path.read_text() == open(grid_file).read()
    with pytest.raises(ValueError, match="no grid"):
        rerun_cells.grid_call("other/m-way/7/cuda", {})
