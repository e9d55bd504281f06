"""The port's range-partition join (``parallel/dist_join.py``) and its CLI's
distributed m-way route (``-a m-way -n N``) against the JAX package on its
8-device CPU mesh: the same seeded columns, the same relations from the
same CLI flags, equal counts (integers, tolerance 0)."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_join as jdj
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.parallel import dist_join as tdj
from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def no_installed_granularity(monkeypatch):
    monkeypatch.setattr(jmesh, "HOST_GRANULARITY", None)
    monkeypatch.setattr(tmesh, "HOST_GRANULARITY", None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU route is many small tensor ops a shard; one thread
    each keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("kind", ["pk_fk", "full_range"])
def test_dist_join_count_equals_jax(kind):
    """Uniform keys, and keys over the whole domain, whose span wraps int32
    and goes through dest_of_keys' uint32/float32 arithmetic."""
    rng = np.random.default_rng(len(kind))
    nR, nS = 5_000, 9_001
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    else:
        rk = rng.integers(-(2**31) + 2, 2**31 - 2, nR).astype(np.int32)
        sk = np.concatenate([rk[:nS // 2], rng.integers(
            -(2**31) + 2, 2**31 - 2, nS - nS // 2)]).astype(np.int32)
    rp = np.arange(nR, dtype=np.int32)
    sp = np.arange(nS, dtype=np.int32)
    want = jdj.dist_join_count(rk, rp, sk, sp, nR, nS)
    got = tdj.dist_join_count(rk, rp, sk, sp, nR, nS,
                              tmesh.make_mesh(8, "cpu"))
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


def test_dist_join_counts_past_int32_without_a_guard():
    """A shard count past 2^31 (2^16 x 2^16 equal keys): the JAX package
    recounts through numpy here; the port's int64 count needs nothing."""
    n = 1 << 16
    k = np.full(n, 3, np.int32)
    mesh = tmesh.make_mesh(4, "cpu")
    # all keys go to one bucket: 16,384 a shard overflow the cap of 8,192
    # by 8,192, on 4 shards of each relation
    assert tdj.dist_join_count(k, k, k, k, n, n, mesh)[1] == 2 * 4 * 8192
    assert tdj.dist_join_count(k, k, k, k, n, n, mesh, slack=8.0) == \
        (1 << 32, 0)


def test_dist_join_refuses_a_2d_mesh():
    k = np.arange(100, dtype=np.int32)
    with pytest.raises(ValueError, match="flat mesh"):
        tdj.dist_join_count(k, k, k, k, 100, 100,
                            tmesh.make_mesh2d(2, 4, "cpu"))


@pytest.mark.parametrize("flags", [[], ["-S", "RING", "--non-unique"]],
                         ids=["next", "ring"])
def test_cli_dist_mway_equals_the_jax_cli(flags, capsys):
    """-a m-way -n 8 prints the JAX CLI's Results (its --scalarmerge route
    on the 8-device CPU mesh) for the same flags, with the exchange line
    and the phase columns of the record row."""
    argv = ["-a", "m-way", "-n", "8", "-r", "20000", "-s", "30000", "-x",
            "5", "-y", "6", *flags]
    assert jcli.main([*argv, "--scalarmerge"]) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.split("Results = ")[1].split()[0] == want
    strategy = flags[1] if flags else "NEXT"
    assert ("[INFO ] exchange path: " + ("bulk all_to_all" if not flags else
                                         f"{strategy}-scheduled")) in err
    assert "device-side copy" in err
    record = next(ln for ln in err.splitlines() if ln.startswith("[RECORD]"))
    cols = record.split()
    assert cols[1:4] == ["m-way", "8", "20000"]
    # part sort merge1 mergerest mergejoin: the phased join fills three
    assert int(cols[6]) == int(cols[9]) == 0
    assert int(cols[7]) > 0 and int(cols[8]) > 0 and int(cols[10]) > 0
    if not flags:
        assert want == "30000"


def test_cli_dist_overflow_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(tdm, "dist_mway_join_phased",
                        lambda *a, **k: (0, 17, {"sort": 0.0, "merge1": 0.0,
                                                 "mergejoin": 0.0,
                                                 "total": 0.0}))
    assert tcli.main(["-n", "4", "-r", "1000", "-s", "1000", "--device",
                      "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "Results" not in out and "[ERROR] exchange bucket overflow (17" \
        in err


def test_cli_dist_raises_fanin_to_the_shard_count(capsys):
    assert tcli.main(["-n", "8", "-f", "2", "-r", "3000", "-s", "3000",
                      "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "raising partfanout" in err and "Results = 3000" in out


@pytest.mark.parametrize("nthreads,raised", [(8, None), (16, None),
                                             (32, 32), (40, 64)])
def test_cli_without_f_raises_the_fanin_past_16_shards(nthreads, raised,
                                                       capsys):
    """Without ``-f`` the received runs merge at fan-in 16, so past 16
    shards the fan-out is raised to the shard count's power of two, with
    the warning, as the JAX CLI raises its default of 16 (main.c:866-869);
    at 16 shards or fewer it stays
    unnamed (each local sort's planned levels)."""
    argv = ["-n", str(nthreads), "-r", "3000", "-s", "3000"]
    args = tcli.build_parser().parse_args(argv)
    assert tcli._validate(args) is None
    assert args.partfanout == raised
    _, err = capsys.readouterr()
    assert ("raising partfanout" in err) == (raised is not None)


def test_cli_dist_without_a_card_runs_only_when_told_cpu(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-n", "8", "-r", "3000", "-s", "3000"]
    assert tcli.main(argv) == 1
    assert "Results" not in capsys.readouterr().out
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    assert "Results = 3000" in capsys.readouterr().out
