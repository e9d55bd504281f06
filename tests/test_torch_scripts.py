"""The port's twins of the JAX experiment scripts
(``avx_sort_merge_joins_tpu_torch/scripts/*.sh``) on the CPU with small
knobs and ``DEVICE=cpu``, as ``tests/test_cli.py`` runs the JAX workload-A
runbook: each run's exit code and outputs.  The counts are the pk-fk
workload's |S| (tolerance 0)."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = os.path.join(ROOT, "avx_sort_merge_joins_tpu_torch", "scripts")
NAMES = ("cardinality.sh", "scalesize.sh", "tput-scalability.sh",
         "sort-bench.sh", "multiwaymerge-bench.sh", "partitioning-bench.sh",
         "workload-a.sh")


def _run(name, tmp_path, args=(), device="cpu", **env):
    """Run a twin from ``tmp_path`` with the environment's knobs; the
    interpreter of this test first on PATH."""
    e = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    e["PATH"] = os.path.dirname(sys.executable) + os.pathsep + e["PATH"]
    if device:
        e["DEVICE"] = device
    e.update({k: str(v) for k, v in env.items()})
    return subprocess.run(["bash", os.path.join(TWINS, name), *args],
                          cwd=tmp_path, env=e, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("name", NAMES)
def test_twin_drives_the_port_only(name):
    """Every JAX script has its twin, which calls the port's package and
    never the JAX one, and passes DEVICE on as --device."""
    assert os.path.isfile(os.path.join(ROOT, "scripts", name))
    text = open(os.path.join(TWINS, name)).read()
    calls = re.findall(r"python -m (\S+)", text)
    assert calls and all(c.startswith("avx_sort_merge_joins_tpu_torch")
                         for c in calls)
    assert not re.search(r"avx_sort_merge_joins_tpu(?!_torch)\b", text)
    assert text.count('${DEVICE:+--device "$DEVICE"}') == len(
        re.findall(r"^\s*(?:out=\$\()?python -m", text, re.M))


def test_workload_a_small_on_the_cpu(tmp_path):
    p = _run("workload-a.sh", tmp_path,
             ["--ntuples", "400000", "--scale-min", "100000"])
    assert p.returncode == 0, p.stderr
    assert "Results = 400000" in p.stdout
    assert "[workload-a] PASS: count == |S| == 400000 over 8 shards" in \
        p.stdout


def test_workload_a_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run("workload-a.sh", tmp_path, ["--ntuples", "400000"], device="")
    assert p.returncode == 1
    assert "[workload-a] driver FAILED" in p.stderr
    assert "Results" not in p.stdout


def test_cardinality_small_on_the_cpu(tmp_path):
    nr = 3000
    p = _run("cardinality.sh", tmp_path, NR=nr, REPS=1)
    assert p.returncode == 0, p.stderr
    out = (tmp_path / "cardinality.txt").read_text()
    assert re.findall(r"^Results = (\d+)$", out, re.M) == [
        str(nr * r) for r in (1, 2, 4, 8, 16)]
    log = (tmp_path / "cardinality.log").read_text()
    assert [f"# ratio={r} rep=1" for r in (1, 2, 4, 8, 16)] == re.findall(
        r"^# ratio=\d+ rep=\d+$", log, re.M)
    assert "[RECORD] m-way 1 3000 48000 " in log


def test_tput_scalability_small_on_the_cpu(tmp_path):
    """The [RECORD] grep and the scalar double sweep: a kernel row and a
    scalar row a configuration, tagged."""
    p = _run("tput-scalability.sh", tmp_path, NR=4000, CHIPS="2", REPS=1,
             ALGOS="m-pass")
    assert p.returncode == 0, p.stderr
    rows = (tmp_path / "tput-scalability.txt").read_text().splitlines()
    assert len(rows) == 2
    assert [r.split()[:3] for r in rows] == [["[RECORD]", "m-pass", "2"]] * 2
    assert rows[0].endswith(" cuda")
    assert rows[1].endswith(" --scalarsort --scalarmerge")


@pytest.mark.parametrize("name,env,lines", [
    ("sort-bench.sh", dict(SIZES="1", VARIANTS="keysonly"), 2),
    ("multiwaymerge-bench.sh", dict(TOTALS="8192", FANINS="4 2048"), 6),
    ("partitioning-bench.sh", dict(N=65536, BITS="2 16"), 10)])
def test_bench_twins_small_on_the_cpu(tmp_path, name, env, lines):
    p = _run(name, tmp_path, **env)
    assert p.returncode == 0, p.stderr
    out = (tmp_path / name.replace(".sh", ".txt")).read_text().splitlines()
    assert len(out) == lines
    assert "Error" not in (tmp_path / name.replace(".sh", ".log")).read_text()


@pytest.mark.parametrize("argv,scale_tier,refused", [
    (["-r", str(1 << 27), "-s", str(1 << 31)], False, None),
    (["-a", "m-pass", "-r", str(1 << 27), "-s", str(1 << 31)], False,
     "-s 2147483648: past 2147483647 tuples"),
    (["-r", str(1 << 27), "-s", str(1 << 31), "--scalarmerge"], False,
     "-s 2147483648: past 2147483647 tuples"),
    (["-r", str(1 << 27), "-s", str(1 << 31), "--materialize"], False,
     "-s 2147483648: past 2147483647 tuples"),
    (["-r", str(1 << 27), "-s", str(1 << 31), "-n", "3"], False,
     "-s 2147483648: past 2147483647 tuples"),
    (["-r", str(2**31 - 1), "-s", "10"], False, "-r 2147483647: R's keys"),
    (["-r", str(2**31 - 2), "-s", str(2**31 - 2), "-a", "mpsm"], False,
     None),
    (["-r", "800000000", "-s", str(1 << 31), "-n", "8"], True, None),
    (["-r", str(2**31 - 1), "-s", "8", "-n", "8"], True,
     "-r 2147483647: R's keys")])
def test_one_device_size_limit(argv, scale_tier, refused):
    """The CLI's size checks (cardinality.sh's last row at its default NR
    asks for |S| = 2^31): R's keys 1..|R| stay below the INT32_MAX pad;
    past 2^31 - 1 tuples a relation runs on the standard path only through
    the one-device m-way count join's kernels, which count it exactly on
    the card (tests/test_torch_gpu.py); the scale tier makes S a shard at
    a time."""
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    args = tcli.build_parser().parse_args(argv)
    why = tcli._size_refusal(args, scale_tier)
    if refused is None:
        assert why is None
    else:
        assert why.startswith(refused)


def test_cardinality_last_row_on_another_path_exits_1_up_front(capsys):
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    rc = tcli.main(["-a", "mpsm", "-r", str(1 << 27), "-s", str(1 << 31),
                    "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == tcli.TOO_LARGE_EXIT == 1 and "Results" not in out
    assert "-s 2147483648: past 2147483647 tuples a relation runs on one " \
           "device only through the m-way count join's kernels" in err
    assert "Creating" not in err


def test_out_of_device_memory_exits_1(monkeypatch, capsys):
    """scalesize.sh's rows past 40 x 32 Mi run out of an 80 GB card's
    memory in the device generation: the CLI prints the error and exits 1,
    no result."""
    from avx_sort_merge_joins_tpu_torch import cli as tcli
    from avx_sort_merge_joins_tpu_torch import datagen

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 12.00 GiB.\nmore")
    monkeypatch.setattr(datagen, "parallel_create_relation", oom)
    rc = tcli.main(["-r", "1000", "-s", "1000", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == tcli.OUT_OF_MEMORY_EXIT == 1 and "Results" not in out
    assert "[ERROR] out of device memory at -r 1000 -s 1000 -n 1: CUDA out " \
           "of memory. Tried to allocate 12.00 GiB." in err
