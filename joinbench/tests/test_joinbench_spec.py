"""The harness finds configurations, cells, traffic and metrics by the
names in BENCHMARK.json, and a new cell or metric is picked up from new
files and entries alone."""

import io
import json
import re
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


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def test_every_pair_of_config_and_traffic_is_given_once():
    """A cell is one deployment under one traffic mix: two routes of the
    program on one deployment take a configuration each."""
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))


@pytest.mark.parametrize("part", sorted(KEYS))
def test_benchmark_entries_keep_their_form(part):
    names = [e["name"] for e in BENCH[part]]
    assert len(names) == len(set(names))
    for e in BENCH[part]:
        extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
        assert KEYS[part] <= set(e) <= KEYS[part] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        for key in ("why", "layer") + (("source",) if part == "configs"
                                       else ()):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in (
                "lower", "higher"), e["name"]
        for w in e.get("workloads", []):
            assert w in CELLS, (e["name"], w)
    if part == "configs":
        for c in BENCH["configs"]:
            assert len(c["reduced"]) <= 16
            assert all(NAME.fullmatch(k) for k in c["reduced"])
    if part == "workloads":
        for w in BENCH["workloads"]:
            assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
    if part == "end_to_end":
        assert "setup_s" in names
        for m in BENCH["end_to_end"]:
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
    if part == "per_layer":
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        for m in BENCH["per_layer"]:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e
            for w in m.get("workloads", CELLS):  # each reports what it moves
                assert spec.applies(e2e[m["moves"]], w), (m["name"], w)


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


KEY8B_ENTRY = """
import torch

from avx_sort_merge_joins_tpu_torch.ops import join64, mergejoin

ANSWER = "count"


def prepare(rel, config, args):
    assert rel.r_keys.dtype == rel.s_keys.dtype == torch.int64
    return rel


def _planes(keys):
    return (keys >> 32).int(), ((keys & 0xFFFFFFFF) - 2**31).int()


def join(rel):
    rhi, rlo = join64.sort64(*_planes(rel.r_keys), rel.n_r)
    shi, slo = join64.sort64(*_planes(rel.s_keys), rel.n_s)
    count = mergejoin.merge_join_count_fused64(rhi, rlo, shi, slo, rel.n_r,
                                               rel.n_s)
    return {"count": join64.finish_count64(count)}, {}
"""


def _small_config(pkg, name, **over):
    (pkg / "configs" / f"{name}.json").write_text(json.dumps(
        dict(json.loads((pkg / "configs" / "wlB_128M.json").read_text()),
             name=name, r_tuples=3000, s_tuples=6000, **over)))
    return {"name": name, "source": "test", "file":
            f"joinbench/configs/{name}.json",
            "reduced": ["r_tuples", "s_tuples"], "why": "test"}


def _add_cell(tmp_path, bench, cell, config, traffic, entry, metrics=()):
    """``cell`` on ``config`` and ``traffic`` through ``entry``, by a new
    workload file and new entries; each metric of ``metrics`` lists it."""
    pkg = tmp_path / "joinbench"
    (pkg / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"entry": entry, "args": {}}))
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if m["name"] in metrics:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


# (cell, configuration keys, entry, the entry's new file or None, metrics
# that list the cell, untraced and traced metrics on the CPU): the 8-byte-key
# configuration through an entry of its own, and the m-pass entry on a
# configuration of its own
NEW_CELLS = {
    "key8b": ("wlB_small8.key8b", {"key_bytes": 8}, "key8b_count",
              KEY8B_ENTRY, ("join_p95_ms",),
              {"join_tput", "join_p95_ms", "setup_s"}, set()),
    "mpass": ("wlB_small.mpass", {}, "mpass_count", None,
              ("join_p95_ms", "host.syncs"),
              {"join_tput", "join_p95_ms", "setup_s"}, {"host.syncs"})}


@pytest.mark.parametrize("case", sorted(NEW_CELLS))
def test_a_key8b_or_mpass_cell_needs_only_new_files(case, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    cell, over, entry, source, metrics, e2e, layer = NEW_CELLS[case]
    config = cell.split(".")[0]
    bench = _copy(tmp_path)
    pkg = tmp_path / "joinbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    bench["configs"].append(_small_config(pkg, config, **over))
    if source is not None:
        (pkg / "entries" / f"{entry}.py").write_text(source)
    _add_cell(tmp_path, bench, cell, config, "pkfk_count", entry, metrics)
    after = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())  # nothing edited
    for trace, want in (("0", e2e), ("1", layer)):
        rc, out, _ = _run(tmp_path, ["--workload", cell, "--seed",
                                     "4000000021", "--seconds", "0.2",
                                     "--trace", trace, "--device", "cpu"])
        assert rc == 0
        res = json.loads(out[-1])
        assert res["correct"] and res["failed"] == 0
        assert res["checks"]["count_gap_max"]["value"] == 0
        assert set(res["metrics"]) == want  # no device: no trace readers


def test_rows_at_8_byte_keys_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    bench = _copy(tmp_path)
    bench["configs"].append(_small_config(tmp_path / "joinbench",
                                          "wlB_small8", key_bytes=8))
    _add_cell(tmp_path, bench, "wlB_small8.rows", "wlB_small8", "pkfk_rows",
              "mway_materialize")
    with pytest.raises(ValueError, match="wlB_small8.*rows"):
        _run(tmp_path, ["--workload", "wlB_small8.rows", "--seed", "5",
                        "--seconds", "0.2", "--device", "cpu"])
