"""The distributed m-pass count join of the port (``parallel/dist_mpass.py``)
and its CLI route (``-a m-pass -n N``) on meshes of shards on the CPU,
against the JAX package's on its 8-device CPU mesh (its default route
there, ``use_pallas=False``) and the numpy oracle: the same seeded numpy
columns go to both, and ``(count, overflow)`` must be equal (integers,
tolerance 0).  Each case checks the port's kernel route (the kernels'
plain versions on the CPU) and its ``torch.sort`` baseline route.  The JAX
cases share shapes, so that its shard programs compile once a mesh."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mpass as jdp
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.parallel import dist_mpass as tdp
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
    got = tdp.dist_mpass_join_count(rk, sk, nR, nS, mesh, **kw)
    assert tdp.dist_mpass_join_count(rk, sk, nR, nS, mesh,
                                     use_kernels=False) == got
    return got


@pytest.mark.parametrize("kind", ["uniform", "ragged_nonunique", "zipf",
                                  "domain_ends"])
def test_dist_mpass_equals_jax(kind):
    """Both routes give JAX's (count, overflow); "domain_ends" holds keys
    at -(2^31 - 2) and up to 2^31 - 2."""
    rk, sk = _workload(kind)
    want = jdp.dist_mpass_join_count(rk, sk, NR, NS)
    got = _both_routes(rk, sk, NR, NS, tmesh.make_mesh(8, "cpu"))
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


@pytest.mark.parametrize("ndev", [2, 8])
def test_dist_mpass_overlap_equals_jax(ndev):
    """overlap=True: permute rounds, each pair of arrivals merged by the
    varlen K4 on two runs as it completes, then the halving passes (the
    JAX overlap needs its Pallas pipeline; its bulk count is the
    reference)."""
    rk, sk = _workload("heavy_hitter", seed=3)
    want = jdp.dist_mpass_join_count(rk, sk, NR, NS)
    got = tdp.dist_mpass_join_count(rk, sk, NR, NS,
                                    tmesh.make_mesh(ndev, "cpu"),
                                    overlap=True)
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


@pytest.mark.parametrize("mesh,kw", [
    ((6,), {}), ((2, 4), {}), ((8,), {"use_kernels": False})],
    ids=["6 shards", "2x4 mesh", "baseline route"])
def test_dist_mpass_overlap_falls_back_loudly(mesh, kw, capsys):
    """Where the overlap cannot run (a shard count that is no power of
    two, a 2-D mesh, the baseline route) the bulk path runs, after the
    JAX package's warning on stderr."""
    rk, sk = _workload("uniform", 1000, 1500, seed=5)
    m = tmesh.make_mesh2d(*mesh, "cpu") if len(mesh) == 2 else \
        tmesh.make_mesh(mesh[0], "cpu")
    got = tdp.dist_mpass_join_count(rk, sk, 1000, 1500, m, overlap=True,
                                    **kw)
    assert got == (merge_join_count_numpy(rk, sk), 0)
    err = capsys.readouterr().err
    assert "[WARN ] dist m-pass overlap=True requires" in err
    assert "running the non-overlapped all_to_all path" in err


@pytest.mark.parametrize("ndev,nR,nS", [(3, NR, NS), (6, 5, 2000)],
                         ids=["3", "6-tiny"])
def test_dist_mpass_nonpow2_mesh_equals_jax(ndev, nR, nS):
    """Shard counts that are not powers of two: the received runs are
    padded with empty ones to 4 or 8 (K4 passes over them).  On 6 shards R
    has 5 keys, so five shards hold only pads."""
    rk, sk = _workload("uniform", nR, nS, seed=ndev)
    want = jdp.dist_mpass_join_count(rk, sk, nR, nS, jmesh.make_mesh(ndev))
    got = _both_routes(rk, sk, nR, nS, tmesh.make_mesh(ndev, "cpu"))
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mpass_2d_mesh_equals_jax():
    """A 2 x 4 (host, chip) mesh: the two-stage exchange."""
    rk, sk = _workload("zipf", seed=2)
    want = jdp.dist_mpass_join_count(rk, sk, NR, NS,
                                     jmesh.make_mesh2d(2, 4))
    got = _both_routes(rk, sk, NR, NS, tmesh.make_mesh2d(2, 4, "cpu"))
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mpass_overflow_retry():
    """20,000 copies of one key on one source shard of 4 overflow its
    bucket at slack 2 (cap 16,384): the slack doubles and the count is
    exact with no overflow."""
    n = 4 * 20_000
    rng = np.random.default_rng(11)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    sk[:20_000] = 5
    mesh = tmesh.make_mesh(4, "cpu")
    assert tdp._join(rk, sk, n, n, mesh, 2.0, tdp.BLOCKSIZE_DEFAULT, 16,
                     True, False)[1] > 0
    assert _both_routes(rk, sk, n, n, mesh) == (n, 0)


@pytest.mark.parametrize("kind", ["empty S", "hot key"])
def test_dist_mpass_edges(kind):
    """An empty S counts 0 on both routes.  One key with cntR * cntS =
    24,000^2 >= 2^29 on one shard, where the JAX package raises
    CountLimbOverflow (dist_mpass.py:276-279): the port's int64 count
    equals numpy's."""
    if kind == "empty S":
        rk, sk = _workload("uniform", 1000, 0)
    else:
        rk = sk = np.full(24_000, 9, np.int32)
    mesh = tmesh.make_mesh(8, "cpu")
    got = _both_routes(rk, sk, rk.size, sk.size, mesh)
    assert got == (merge_join_count_numpy(rk, sk), 0)
    assert tdp.dist_mpass_join_count(rk, sk, rk.size, sk.size, mesh,
                                     overlap=True) == got


def test_cli_dist_mpass_equals_the_jax_cli(capsys):
    """-a m-pass -n 8 prints the JAX CLI's Results for the same flags,
    with one total phase in the record row."""
    argv = ["-a", "m-pass", "-n", "8", "-r", str(NR), "-s", str(NS), "-x",
            "5", "-y", "6", "--non-unique"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.split("Results = ")[1].split()[0] == want
    assert "[STATS] total" in err and "[STATS] sort" not in err
    record = next(ln for ln in err.splitlines() if ln.startswith("[RECORD]"))
    assert record.split()[1:4] == ["m-pass", "8", str(NR)]


def test_cli_dist_mpass_materialize_warns(capsys):
    """-n 2 -a m-pass --materialize runs the distributed materializing
    join, after the JAX CLI's warning."""
    assert tcli.main(["-a", "m-pass", "-n", "2", "--materialize", "-r",
                      "3000", "-s", "4000", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "[WARN ] --materialize with -n>1 uses the distributed m-way " \
        "pipeline" in err
    assert "Results = 4000" in out
