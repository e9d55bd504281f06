"""The control, the plain reference with its keys held in float32 in the
program's place, comes out not correct: at 17,000,000 tuples, past the
2^24 keys float32 holds exactly (on the chip it runs at each cell's own
size: ``python3 -m joinbench.control``)."""

import pytest
import torch

from joinbench import control, spec

ROOT = spec.default_root()
N = 17_000_000


def test_lower_precision_merges_keys_past_2_24():
    k = torch.tensor([16_777_216, 16_777_217, 16_777_218, 5], dtype=torch.int32)
    assert control.lower_precision(k).tolist() == [16_777_216, 16_777_216,
                                                   16_777_218, 5]


@pytest.mark.parametrize("cell", ["wlB_128M.mway_count",
                                  "wlB_128M.mway_materialize",
                                  "wlA_1600M.mway_zipf1",
                                  "wlB_128M.mpass_count"])
def test_control_is_not_correct(cell):
    res = control.control_run(spec.load_cell(ROOT, cell), 4000000009,
                              torch.device("cpu"), N)
    assert res["correct"] is False
    assert res["checks"]["count_gap_max"]["value"] > 0
    if "rows_wrong_last" in res["checks"]:
        assert res["checks"]["rows_wrong_last"]["value"] > 0
        assert res["checks"]["sample_rows_wrong"]["value"] > 0


def test_control_at_exact_sizes_is_correct():
    # below 2^24 float32 holds every key: the control then agrees, so the
    # tests above fail for the precision and nothing else
    res = control.control_run(spec.load_cell(ROOT, "wlB_128M.mway_count"),
                              3, torch.device("cpu"), 100_000)
    assert res["correct"] is True
