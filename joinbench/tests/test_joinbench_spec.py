"""The harness finds configurations, cells, traffic and metrics by the
names in BENCHMARK.json, and a new cell or metric is picked up from new
files and entries alone."""

import io
import json
import shutil

import pytest

from joinbench import run, spec

ROOT = spec.default_root()
BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_its_files(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.entry.ANSWER == c.traffic["query"]
    assert callable(c.entry.prepare) and callable(c.entry.join)
    assert c.config["name"] == [w["config"] for w in BENCH["workloads"]
                                if w["name"] == cell][0]
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_every_metric_has_a_reader_and_configs_their_files():
    for m in BENCH["per_layer"]:
        assert callable(spec.load_module(ROOT, "metrics", m["name"]).read)
    for c in BENCH["configs"]:
        assert c["file"] == f"joinbench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _copy(tmp_path):
    shutil.copytree(ROOT / "joinbench", tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return bench


def _run(root, argv):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(argv, root=root, out=out, err=err)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "joinbench").rglob("*")
              if p.is_file()}
    pkg = tmp_path / "joinbench"
    (pkg / "configs" / "wlB_small.json").write_text(json.dumps(
        dict(json.loads((pkg / "configs" / "wlB_128M.json").read_text()),
             name="wlB_small", r_tuples=3000, s_tuples=12000)))
    (pkg / "traffic" / "zipf075_count.json").write_text(json.dumps(
        {"name": "zipf075_count", "query": "count", "s_keys": "zipf",
         "zipf_z": 0.75}))
    (pkg / "workloads" / "wlB_small.zipf075.json").write_text(json.dumps(
        {"entry": "mway_count", "args": {}}))
    (pkg / "metrics" / "mway.count_ms.py").write_text(
        "def read(run):\n"
        "    v = [j['phases']['mergejoin'] for j in run.joins]\n"
        "    return 1e3 * sum(v) / len(v)\n")
    bench["configs"].append({"name": "wlB_small", "source": "test",
                             "file": "joinbench/configs/wlB_small.json",
                             "reduced": ["r_tuples", "s_tuples"],
                             "why": "test"})
    bench["workloads"].append({"name": "wlB_small.zipf075",
                               "config": "wlB_small",
                               "traffic": "zipf075_count", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "mway.count_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "join model", "moves": "join_tput",
                               "workloads": ["wlB_small.zipf075"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())  # nothing edited
    for trace in ("0", "1"):
        rc, out, _ = _run(tmp_path, ["--workload", "wlB_small.zipf075",
                                     "--seed", "4000000000", "--seconds",
                                     "0.2", "--trace", trace, "--device",
                                     "cpu"])
        assert rc == 0
        res = json.loads(out[-1])
        assert res["correct"] and res["attempted"] >= 1
        want = {"0": {"join_tput", "setup_s"},
                "1": {"mway.count_ms"}}  # the others name their cells
        assert set(res["metrics"]) == want[trace]
