"""The m-way count join end to end: the PyTorch port against the JAX
package on the same relations (JAX in Pallas interpret mode with 8-row
blocks and tiles, the port with 1,024-key blocks on its CPU path), the
port's CLI, and a check that the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.models import mway as jmway
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.types import JoinConfig as JConfig
from avx_sort_merge_joins_tpu.types import Relation as JRelation
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.models import mway as tmway
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.types import (JoinConfig, Relation,
                                                  default_device)

ROWS = 8
BLOCK = ROWS * 128
N = 2500  # three ragged 1,024-key blocks per relation, both sides


def _relations(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, N + 1)).astype(np.int32)
        sk = rng.integers(1, N + 1, N).astype(np.int32)
    elif kind == "non_unique":
        rk = rng.integers(0, 300, N).astype(np.int32)
        sk = rng.integers(0, 300, N).astype(np.int32)
    else:  # negative keys, down to the end of the domain
        rk = rng.integers(-(2**31 - 2), -(2**31 - 2) + 4000, N).astype(
            np.int32)
        sk = rng.integers(-(2**31 - 2), -(2**31 - 2) + 4000, N).astype(
            np.int32)
    pay = rng.integers(0, 1000, N).astype(np.int32)
    jR, jS = JRelation.from_numpy(rk, pay), JRelation.from_numpy(sk, pay)
    # the port takes the JAX relations' own columns
    tR = Relation.from_numpy(*jR.to_numpy(), device="cpu")
    tS = Relation.from_numpy(*jS.to_numpy(), device="cpu")
    return jR, jS, tR, tS, merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("fanin", [2, 16])
@pytest.mark.parametrize("kind", ["pk_fk", "non_unique", "negative"])
def test_mway_matches_jax(kind, fanin):
    jR, jS, tR, tS, want = _relations(kind)
    jres = jmway.sortmergejoin_multiway(jR, jS, fanin=fanin,
                                        block_rows=ROWS, tile_rows=ROWS)
    tres = tmway.sortmergejoin_multiway(tR, tS, fanin=fanin, block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sort", "merge1", "mergerest", "mergejoin",
                                "total"}
    assert tres.bytes_moved["sort"] == 2 * 4 * 2 * N


@pytest.mark.parametrize("swap", ["scalar_sort", "scalar_merge"])
def test_mway_scalar_swaps_match_jax(swap):
    jR, jS, tR, tS, want = _relations("non_unique")
    jres = jmway.sortmergejoin_multiway(jR, jS, JConfig(**{swap: True}),
                                        fanin=2, block_rows=ROWS,
                                        tile_rows=ROWS)
    tres = tmway.sortmergejoin_multiway(tR, tS, JoinConfig(**{swap: True}),
                                        fanin=2, block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sortmerge", "total"}


def test_mway_count_past_2_31_at_the_default_block():
    """One hot key: 2^16 x 2^16 = 2^32 matches, plus a pk-fk tail."""
    n = 1 << 16
    rk = np.concatenate([np.full(n, 3, np.int32), np.arange(10, 5010,
                                                            dtype=np.int32)])
    sk = np.concatenate([np.arange(10, 5010, dtype=np.int32),
                         np.full(n, 3, np.int32)])
    res = tmway.sortmergejoin_multiway(Relation.from_numpy(rk, device="cpu"),
                                       Relation.from_numpy(sk, device="cpu"))
    assert res.totalresults == 2**32 + 5000 == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("config", [JoinConfig(mwaybufsize_bytes=1),
                                    JoinConfig(mwaybufsize_bytes=1 << 20)])
def test_mway_unported_options_raise(config):
    """The ``-m`` budget, once refused, now sizes the K2 merge tile (the
    smallest tile at 1 byte, the largest at 1 MiB): the count and the
    materialized rows are those of the default configuration and the JAX
    join under the same budget.  What the budget does not reach is still
    refused: the pair merge (K6) at the budget's tile."""
    tile = tmw.merge_tile_for(config.mwaybufsize_bytes, 2)
    assert tile != tmw.MERGE_TILE
    keys = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="pairs merge at tiles"):
        tmw.multiway_merge(keys, 2, (2, 8, 4), keys, tile=tile)
    jR, jS, tR, tS, want = _relations("non_unique")
    jres = jmway.sortmergejoin_multiway(
        jR, jS, JConfig(mwaybufsize_bytes=config.mwaybufsize_bytes,
                        scalar_merge=True), fanin=2, block_rows=ROWS,
        tile_rows=ROWS)
    got = tmway.sortmergejoin_multiway(tR, tS, config, fanin=2, block=BLOCK)
    assert got.totalresults == jres.totalresults == want
    mat = JoinConfig(mwaybufsize_bytes=config.mwaybufsize_bytes,
                     materialize=True)
    rows = tmway.sortmergejoin_multiway(tR, tS, mat, fanin=2, block=BLOCK)
    base = tmway.sortmergejoin_multiway(tR, tS, JoinConfig(materialize=True),
                                        fanin=2, block=BLOCK)
    assert rows.totalresults == base.totalresults == want
    assert torch.equal(rows.resultlist[0].results.keys,
                       base.resultlist[0].results.keys)


def test_cli_prints_the_pk_fk_count(capsys):
    assert tcli.main(["-a", "m-way", "-r", "20000", "-s", "20000",
                      "-x", "42", "-y", "43", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1] == "Results = 20000"
    assert "[RECORD] m-way 1 20000 20000 0 0 " in err
    # every throughput line names the device it was measured on
    assert ", DEVICE cpu\n" in err
    record = next(ln for ln in err.splitlines() if ln.startswith("[RECORD]"))
    assert record.split()[-1] == "cpu"


@pytest.mark.parametrize("flags", [["-a", "m-way"], ["-a", "m-pass"],
                                   ["-a", "mpsm"], ["--materialize"],
                                   ["--key8b"],
                                   ["--key8b", "--scalarsort"]],
                         ids=lambda f: f[-1])
def test_cli_without_a_card_runs_only_when_told_cpu(flags, monkeypatch,
                                                    capsys):
    """No silent CPU: without a card the CLI exits 1 and prints no result,
    unless it is given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [*flags, "-r", "3000", "-s", "3000"]
    assert tcli.main(argv) == 1
    out, err = capsys.readouterr()
    assert "Results" not in out and "no CUDA device" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "Results = 3000"


# Results of the compiled reference binary for these flags, pinned in
# tests/test_reference_parity.py (GOLDEN): the port's CLI must reproduce
# the reference's seeded workloads and counts bit for bit.
@pytest.mark.parametrize("argv,expected", [
    (["-r", "100000", "-s", "100000", "--non-unique", "-x", "42", "-y",
      "43"], 100336),
    (["-r", "100000", "-s", "100000", "--non-unique", "-x", "7", "-y", "8"],
     99575),
    (["-r", "100000", "-s", "100000", "-x", "42", "-y", "43"], 100000),
    (["-r", "50000", "-s", "150000", "--non-unique", "-x", "11", "-y", "12"],
     149492),
], ids=["nonunique-42", "nonunique-7", "default", "card3"])
def test_cli_reference_golden_counts(argv, expected, capsys):
    assert tcli.main(["-a", "m-way", "-n", "1", *argv, "--device", "cpu"]) \
        == 0
    assert capsys.readouterr().out.split("Results = ")[1].split()[0] \
        == str(expected)


@pytest.mark.parametrize("extra", [[], ["--non-unique"], ["--full-range"],
                                   ["-z", "0.75"]])
def test_cli_builds_the_jax_cli_relations(extra):
    argv = ["-r", "30000", "-s", "20000", "-x", "7", "-y", "8", *extra]
    jR, jS = jcli.make_relations(jcli.build_parser().parse_args(argv))
    tR, tS = tcli.make_relations(tcli.build_parser().parse_args(argv),
                                 torch.device("cpu"))
    for j, t in ((jR, tR), (jS, tS)):
        for a, b in zip(j.to_numpy(), t.to_numpy()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ["m-way", "mpsm"])
def test_cli_zipf_count_equals_the_jax_cli(algo, capsys):
    """-z builds S as the JAX CLI does (Zipf over R's keys); the port's
    count equals the JAX CLI's (its --scalarmerge route: lax.sort, no
    Pallas kernel) and, R being unique, |S|."""
    argv = ["-r", "30000", "-s", "20000", "-z", "0.75", "-x", "3", "-y", "4"]
    assert jcli.main(["-a", "m-way", *argv, "--scalarmerge"]) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main(["-a", algo, *argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert got == want == "20000"


SHORT_MAPPING = "<a mapping file of 2 ids>"


@pytest.mark.parametrize("argv", [["-n", "0"],
                                  ["-n", "4", "--mapping-file",
                                   SHORT_MAPPING],
                                  ["-a", "m-pass", "--materialize"],
                                  ["-a", "mpsm", "--materialize"],
                                  ["-f", "3"]])
def test_cli_refuses_what_is_not_ported(argv, capsys, tmp_path):
    """Refused flags and values exit 2 with no result.  (``-m`` is ported:
    its case became ``-n 0``, a shard count the CLI refuses; so is
    ``--mapping-file``: its case became a file with fewer ids than
    ``-n``.)"""
    path = tmp_path / "mapping.txt"
    path.write_text("2 0 0\n")
    argv = [str(path) if a == SHORT_MAPPING else a for a in argv]
    assert tcli.main(["-r", "100", "-s", "100", *argv]) == 2
    assert "Results" not in capsys.readouterr().out


def test_cli_mapping_file_shapes_the_mesh(tmp_path, capsys):
    """``--mapping-file`` places the ``-n N`` shards on the file's devices
    (every id names the CPU under ``--device cpu``); its trailing host
    count sets RING's stride while the run lasts; the count is exact."""
    from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh

    path = tmp_path / "mapping.txt"
    path.write_text("4 0 0 0 0 2\n")
    before = tmesh.DEFAULT_MESH, tmesh.HOST_GRANULARITY
    assert tcli.main(["-n", "4", "-S", "RING", "-r", "3000", "-s", "5000",
                      "--mapping-file", str(path), "--device", "cpu"]) == 0
    assert "Results = 5000" in capsys.readouterr().out
    assert (tmesh.DEFAULT_MESH, tmesh.HOST_GRANULARITY) == before


def test_cli_writes_a_trace(tmp_path, capsys):
    """``-o DIR`` runs the join under torch.profiler and writes a Chrome
    trace with the join's span (the refusal it replaces predates the
    port's ``utils/profiling.trace``)."""
    import json

    out = tmp_path / "trace"
    assert tcli.main(["-r", "5000", "-s", "5000", "-o", str(out),
                      "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "Results = 5000" in cap.out and "trace written to" in cap.err
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "join" for e in events)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import avx_sort_merge_joins_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "for m in ('parallel.scale', 'bench.scalebench', 'utils.profiling'):\n"
        "    assert pkg.__name__ + '.' + m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'avx_sort_merge_joins_tpu.'))\n"
        "             or m == 'avx_sort_merge_joins_tpu')\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


# one merge CTA's shared memory at fan-in 16: 17,092 B at 2,048 outputs,
# 33,988 at 4,096 and 67,780 at 8,192; at fan-in 1,024: 79,876 at 8,192
@pytest.mark.parametrize("budget,fanin,tile", [
    (0, 16, 4096), (1, 16, 2048), (-5, 16, 2048), (17_091, 16, 2048),
    (17_092, 16, 2048), (33_987, 16, 2048), (33_988, 16, 4096),
    (67_779, 16, 4096), (67_780, 16, 8192), (1 << 20, 16, 8192),
    (67_780, 1024, 4096), (79_876, 1024, 8192), (0, 1024, 4096)])
def test_merge_tile_for_table(budget, fanin, tile):

    assert tmw.merge_tile_for(budget, fanin) == tile
    if budget > 0:
        fit = [t for t in tmw.MERGE_TILES
               if tmw.merge_smem_bytes(t, fanin) <= budget]
        assert tile == (fit[-1] if fit else tmw.MERGE_TILES[0])


def test_multiway_merge_tiles_on_the_cpu():
    """On the CPU every tile gives the plain version's columns; a tile
    outside MERGE_TILES, or another than 4,096 for pairs, raises."""

    rng = np.random.default_rng(5)
    keys = torch.from_numpy(np.sort(rng.integers(-50, 50, (8, 300)), 1)
                            .astype(np.int32).reshape(-1))
    want = tmw.multiway_merge(keys, 4, (8, 2400, 300))[0]
    for tile in tmw.MERGE_TILES:
        got, lens = tmw.multiway_merge(keys, 4, (8, 2400, 300), tile=tile)
        assert torch.equal(got, want) and lens == [1200, 1200]
    with pytest.raises(ValueError, match="tile 1000"):
        tmw.multiway_merge(keys, 4, (8, 2400, 300), tile=1000)
    with pytest.raises(ValueError, match="pairs merge at tiles of 4096"):
        tmw.multiway_merge(keys, 4, (8, 2400, 300), payloads=keys,
                           tile=8192)


@pytest.mark.parametrize("budget,tile", [(1, 2048), (40_000, 4096),
                                         (1 << 20, 8192)])
def test_cli_m_gives_the_jax_cli_count(budget, tile, capsys):
    """``-m`` on one device: the count of the JAX CLI under the same flag
    (its lax.sort route), tolerance 0, and the tile it names, at the
    planned fan-ins (no ``-f``) and at ``-f 16``."""
    argv = ["-r", "20000", "-s", "20000", "-x", "7", "-y", "8",
            "--non-unique", "-m", str(budget)]
    assert jcli.main(["-a", "m-way", *argv, "--scalarmerge"]) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    for flags, at in (([], "the planned fan-ins"), (["-f", "16"],
                                                     "fan-in 16")):
        assert tcli.main(["-a", "m-way", *argv, *flags, "--device",
                          "cpu"]) == 0
        out, err = capsys.readouterr()
        assert out.split("Results = ")[1].split()[0] == want
        assert f"-m {budget}: K2 merge tile {tile} outputs at {at}" in err


def test_cli_m_on_a_mesh_warns_and_is_ignored(capsys):
    """``-n N -m B``: the JAX CLI's warning, and the count without -m."""
    argv = ["-a", "m-way", "-n", "4", "-r", "20000", "-s", "20000",
            "--device", "cpu"]
    assert tcli.main([*argv, "-m", "65536"]) == 0
    out, err = capsys.readouterr()
    assert "[WARN ] -m merge-buffer size has no effect on the distributed " \
           "path" in err
    assert "K2 merge tile" not in err
    assert tcli.main(argv) == 0
    assert out.split("Results = ")[1].split()[0] == \
        capsys.readouterr().out.split("Results = ")[1].split()[0] == "20000"
