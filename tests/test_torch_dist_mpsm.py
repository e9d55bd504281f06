"""The distributed MPSM count join of the port (``parallel/dist_mpsm.py``)
and its CLI route (``-a mpsm -n N``) on meshes of shards on the CPU, against
the JAX package's on its 8-device CPU mesh (its default route there,
``use_pallas=False``) and the numpy oracle: the same seeded numpy columns
go to both, and ``(count, overflow)`` must be equal (integers, tolerance
0).  Each case checks the port's kernel route (the kernels' plain versions
on the CPU) and its ``torch.sort`` baseline route.  The JAX program runs
its count kernel in Pallas interpret mode and takes about 23 s to build, so
every JAX call here has one shape (|R| = 12,003, |S| = 16,005 over 8
shards); the other cases hold the port against numpy."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mpsm as jds
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.parallel import dist_mpsm as tds
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh
from test_torch_dist_mway import NR, NS, _workload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU route is many small tensor ops a shard; one thread
    each keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both_routes(rk, sk, nR, nS, mesh, **kw):
    """(count, overflow) of the kernel route, which the baseline route
    must equal."""
    got = tds.dist_mpsm_join_count(rk, sk, nR, nS, mesh, **kw)
    assert tds.dist_mpsm_join_count(rk, sk, nR, nS, mesh,
                                    use_kernels=False) == got
    return got


@pytest.mark.parametrize("kind", ["uniform", "ragged_nonunique", "zipf",
                                  "domain_ends"])
def test_dist_mpsm_equals_jax(kind, monkeypatch):
    """Both routes give JAX's (count, overflow), with n^3 = 512 K3 calls
    (their plain version on the CPU) on 8 shards; "domain_ends" holds keys
    at -(2^31 - 2) and up to 2^31 - 2."""
    rk, sk = _workload(kind)
    want = jds.dist_mpsm_join_count(rk, sk, NR, NS)
    calls = []
    real = tmj.merge_join_count_fused

    def spy(*args):
        calls.append(args[2:])
        return real(*args)

    monkeypatch.setattr(tmj, "merge_join_count_fused", spy)
    got = tds.dist_mpsm_join_count(rk, sk, NR, NS, tmesh.make_mesh(8, "cpu"))
    assert len(calls) == 512 and all(isinstance(x, int) for c in calls
                                     for x in c)
    assert got == want == (merge_join_count_numpy(rk, sk), 0)
    assert tds.dist_mpsm_join_count(rk, sk, NR, NS, tmesh.make_mesh(8, "cpu"),
                                    use_kernels=False) == want


@pytest.mark.parametrize("ndev,nR,nS", [(3, NR, NS), (6, 5, 2000)],
                         ids=["3", "6-tiny"])
def test_dist_mpsm_nonpow2_mesh(ndev, nR, nS):
    """Shard counts that are not powers of two; on 6 shards R has 5 keys,
    so five shards hold only pads."""
    rk, sk = _workload("ragged_nonunique", nR, nS, seed=ndev)
    got = _both_routes(rk, sk, nR, nS, tmesh.make_mesh(ndev, "cpu"))
    assert got == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mpsm_refuses_a_2d_mesh():
    """Both packages raise ValueError on a 2 x 4 mesh: the S ring and R's
    exchange address only the flat shard axis."""
    rk, sk = _workload("uniform", 100, 100)
    with pytest.raises(ValueError, match="flat mesh"):
        jds.dist_mpsm_join_count(rk, sk, 100, 100, jmesh.make_mesh2d(2, 4))
    with pytest.raises(ValueError, match="flat mesh"):
        tds.dist_mpsm_join_count(rk, sk, 100, 100,
                                 tmesh.make_mesh2d(2, 4, "cpu"))


def test_dist_mpsm_range_ends():
    """Keys equal to the splitters lie on exactly one shard: every key of
    R and S is one of four values, the two ends of the domain among them,
    so the splitters are those values."""
    rng = np.random.default_rng(4)
    vals = np.array([-(2**31 - 2), -1, 7, 2**31 - 2], np.int32)
    rk = rng.choice(vals, 4000)
    sk = rng.choice(vals, 5000)
    got = _both_routes(rk, sk, 4000, 5000, tmesh.make_mesh(8, "cpu"))
    assert got == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mpsm_overflow_retry():
    """20,000 copies of one key in R's first shard of 4 overflow its bucket
    at slack 2 (cap 16,384): the slack doubles and the count is exact
    with no overflow."""
    n = 4 * 20_000
    rng = np.random.default_rng(11)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    rk[:20_000] = 5
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    mesh = tmesh.make_mesh(4, "cpu")
    assert tds._join(rk, sk, n, n, mesh, 2.0, tds.BLOCKSIZE_DEFAULT, 16,
                     True)[1] > 0
    assert _both_routes(rk, sk, n, n, mesh) == \
        (merge_join_count_numpy(rk, sk), 0)


@pytest.mark.parametrize("kind", ["empty S", "hot key"])
def test_dist_mpsm_edges(kind):
    """An empty S counts 0 on both routes.  One key with cntR * cntS =
    24,000^2 >= 2^29 on one shard, where the JAX package raises
    CountLimbOverflow (dist_mpsm.py:181-184): the port's int64 count
    equals numpy's."""
    if kind == "empty S":
        rk, sk = _workload("uniform", 1000, 0)
    else:
        rk = sk = np.full(24_000, 9, np.int32)
    got = _both_routes(rk, sk, rk.size, sk.size, tmesh.make_mesh(8, "cpu"))
    assert got == (merge_join_count_numpy(rk, sk), 0)


def test_cli_dist_mpsm_equals_the_jax_cli(capsys):
    """-a mpsm -n 8 prints the JAX CLI's Results for the same flags (at
    the shape of the JAX calls above), with one total phase."""
    argv = ["-a", "mpsm", "-n", "8", "-r", str(NR), "-s", str(NS), "-x",
            "7", "-y", "8"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.split("Results = ")[1].split()[0] == want == str(NS)
    assert "[STATS] total" in err and "[STATS] sort" not in err
