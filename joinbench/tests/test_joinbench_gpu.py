"""On the card (marker ``gpu``): each cell through the harness at a
smaller size, untraced and traced: correct, every metric of the cell
read, each ``kern.*_roofline`` share that applies to the cell inside
(0, 100].  ``python -m pytest joinbench/tests -q -m gpu`` from the
checkout's root; skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from joinbench import spec

ROOT = spec.default_root()
BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "joinbench", "--workload", cell, "--seed",
         "4000000013", "--seconds", "1", "--trace", str(trace), "--tuples",
         str(1 << 23)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    key = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[key] if spec.applies(m, cell)}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        rooflines = [n for n in want if n.startswith("kern.")
                     and n.endswith("_roofline")]
        assert rooflines
        for name in rooflines:
            assert 0 < res["metrics"][name]["value"] <= 100
