"""Where the harness finds what a cell is made of, by the names that
``BENCHMARK.json`` gives:

* ``configs/<config>.json``   the deployment: sizes, layout, guarantees;
* ``traffic/<traffic>.json``  the parameters the generator reads;
* ``workloads/<cell>.json``   the entry the window drives and its args;
* ``entries/<entry>.py``      the adapter that calls into the program;
* ``metrics/<metric>.py``     a per-layer metric's reader.

Adding a cell, a configuration, a traffic mix or a per-layer metric is
adding such files and an entry in ``BENCHMARK.json``: nothing here or in
the harness names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PACKAGE = "joinbench"


def default_root() -> Path:
    """The checkout's root: the directory that holds this package."""
    return Path(__file__).resolve().parent.parent


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(root: Path, kind: str, name: str) -> dict:
    with open(root / PACKAGE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    """``<root>/joinbench/<kind>/<name>.py`` as a module of its own (a
    metric's name holds dots, so it is loaded by path, not imported)."""
    path = root / PACKAGE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}._{kind}_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    """Whether ``BENCHMARK.json``'s metric entry is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    entry: ModuleType
    end_to_end: list
    per_layer: list
    root: Path

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root, "metrics", metric)


def load_cell(root: Path, name: str) -> Cell:
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    workload = _json(root, "workloads", name)
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root, "configs", w["config"]),
        traffic=_json(root, "traffic", w["traffic"]),
        workload=workload,
        entry=load_module(root, "entries", workload["entry"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root)
