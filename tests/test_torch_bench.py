"""The port's micro-benchmarks at tiny sizes on the CPU (their kernels'
plain versions): each returns 0 after its own output check and prints the
JAX module's record line, with the same number of fields
(tests/test_bench_modules.py)."""

import pytest
import torch

from avx_sort_merge_joins_tpu_torch.bench import (common, mergebench,
                                                  multiwaymergebench,
                                                  partitioningbench,
                                                  sortbench, tputbench)

CPU = ["--device", "cpu", "--reps", "1"]


def _rows(out):
    return [ln.split() for ln in out.splitlines() if ln.strip()]


@pytest.mark.parametrize("variant", ["pairwise", "multiway", "keysonly",
                                     "torch"])
def test_sortbench(variant, capsys):
    assert sortbench.main(["0.0625", variant, "--block", "1024",
                           "--negative", *CPU]) == 0
    cap = capsys.readouterr()
    assert [len(r) for r in _rows(cap.out)] == [3]
    assert f"variant={variant} n=65536" in cap.err and "on cpu" in cap.err


@pytest.mark.parametrize("variant", ["fifo2", "pairwise"])
def test_mergebench(variant, capsys):
    assert mergebench.main(["0.03125", "--variant", variant, *CPU]) == 0
    rows = _rows(capsys.readouterr().out)
    assert len(rows) == 1 and len(rows[0]) == 3 and rows[0][0] == "65536"


def test_multiwaymergebench(capsys):
    assert multiwaymergebench.main(["5000", "4", *CPU]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == ["mway", "torch", "copy"]
    assert all(len(r) == 4 for r in rows)


@pytest.mark.parametrize("bits", [2, 7, 16])
def test_partitioningbench_all(bits, capsys):
    """Every variant at every bits value (the JAX ``hist`` stopped past
    2^7), each histogram checked against radix_hist_torch and the
    partition against radix_cluster_numpy."""
    assert partitioningbench.main(["70000", "all", str(bits), *CPU]) == 0
    cap = capsys.readouterr()
    rows = _rows(cap.out)
    assert [r[0] for r in rows] == ["hist", "hist-mxu", "hist-torch",
                                    "partition", "copy"]
    assert all(len(r) == 3 for r in rows)
    assert f"n=65536 bits={bits}" in cap.err


def test_partitioningbench_refuses_bits_past_16():
    with pytest.raises(SystemExit) as e:
        partitioningbench.main(["65536", "hist", "17", *CPU])
    assert e.value.code == 2


def test_tputbench_tput(capsys):
    assert tputbench.main(["--mode", "tput", "-n", "20000", *CPU]) == 0
    cap = capsys.readouterr()
    assert all(k in cap.err for k in ("SORT-BLOCKS", "MERGE", "MJOIN"))
    rows = _rows(cap.out)
    assert len(rows) == 1 and len(rows[0]) == 6


def test_tputbench_mpsm(capsys):
    assert tputbench.main(["--mode", "mpsm", "-n", "8192", "--nchunks", "1",
                           "2", *CPU]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(len(r) == 6 and r[3] == "16384" for r in rows)


@pytest.mark.parametrize("strategy", ["NEXT", "RANDOM"])
def test_tputbench_numa(strategy, capsys):
    """The numabench analog on 8 shards of the CPU: the all-to-all and the
    aggregation rows, the aggregate checked against numpy inside."""
    assert tputbench.main(["--mode", "numa", "-n", "8192", "-S", strategy,
                           *CPU]) == 0
    cap = capsys.readouterr()
    assert "numabench over 8 shards of one device (cpu)" in cap.err
    assert "ALL-TO-ALL" in cap.err
    assert "AGGREGATION" in cap.err and "checked against numpy" in cap.err
    rows = _rows(cap.out)
    assert len(rows) == 1 and len(rows[0]) == 4


def test_tputbench_numa_refuses_a_ragged_stack(capsys):
    assert tputbench.main(["--mode", "numa", "-n", "8193", *CPU]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("main,argv", [
    (sortbench.main, ["0.0625"]), (mergebench.main, ["0.03125"]),
    (multiwaymergebench.main, ["4096", "4"]),
    (partitioningbench.main, ["65536", "hist", "4"]),
    (tputbench.main, ["-n", "8192"])])
def test_benches_without_a_card_exit_1(main, argv, capsys, monkeypatch):
    """No silent CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == common.NO_DEVICE_EXIT
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""


def test_time_steady_on_the_cpu():
    calls = []
    secs = common.time_steady(lambda x: calls.append(x) or x,
                              torch.zeros(3), reps=4, burn=2)
    assert len(calls) == 1 + 2 + 4 and secs >= 0
