"""The distributed m-way count join of the port (``parallel/dist_mway.py``)
on a mesh of shards on the CPU against the JAX package's on its 8-device
CPU mesh (its ``use_pallas=False`` route) and the numpy oracle: the same
seeded numpy columns go to both, and ``(count, overflow)`` must be equal
(integers, tolerance 0).  Each case checks the port's kernel route (the
kernels' plain versions on the CPU), its ``torch.sort`` baseline route and
the phased entry point.  The JAX cases share shapes where they can, so
that its shard programs compile once."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.datagen import (create_relation_pk,
                                              create_relation_zipf,
                                              seed_generator)
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mway as jdm
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh

NR, NS = 12_003, 16_005  # ragged: the last shard of 8 is short


@pytest.fixture(autouse=True)
def no_installed_granularity(monkeypatch):
    """RING strides by the host granularity, module state in both packages
    that an earlier test may have installed."""
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


def _workload(kind, nR=NR, nS=NS, seed=0):
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    if kind == "uniform":
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    elif kind == "ragged_nonunique":
        rk = rng.integers(1, 3000, nR).astype(np.int32)
        sk = rng.integers(1, 3000, nS).astype(np.int32)
    elif kind == "zipf":
        seed_generator(42)
        rk = create_relation_pk(nR).to_numpy()[0]
        seed_generator(43)
        sk = create_relation_zipf(nS, nR, 1.0).to_numpy()[0]
    elif kind == "heavy_hitter":  # 90% of S is one key
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = np.where(rng.random(nS) < 0.9, 7,
                      rng.integers(1, nR + 1, nS)).astype(np.int32)
    else:  # "domain_ends": negative keys down to the end of the domain
        rk = rng.integers(-(2**31 - 2), -(2**31 - 2) + 5000, nR).astype(
            np.int32)
        sk = np.concatenate([rk[:nS // 2], rng.integers(
            2**31 - 5000, 2**31 - 1, nS - nS // 2)]).astype(np.int32)
    return rk, sk


def _port_routes(rk, sk, nR, nS, mesh, **kw):
    """(count, overflow) of the kernel route and of the phased entry point;
    the two must agree."""
    got = tdm.dist_mway_join_count(rk, sk, nR, nS, mesh, **kw)
    count, ov, phases = tdm.dist_mway_join_phased(rk, sk, nR, nS, mesh, **kw)
    assert set(phases) == {"sort", "merge1", "mergejoin", "total"}
    assert got == (count, ov)
    return got


@pytest.mark.parametrize("kind", ["uniform", "ragged_nonunique", "zipf",
                                  "heavy_hitter", "domain_ends"])
def test_dist_mway_equals_jax(kind):
    """The kernel route, the phased entry point and the torch.sort baseline
    route (``use_kernels=False``) all give JAX's (count, overflow)."""
    rk, sk = _workload(kind)
    want = jdm.dist_mway_join_count(rk, sk, NR, NS, use_pallas=False)
    mesh = tmesh.make_mesh(8, "cpu")
    got = _port_routes(rk, sk, NR, NS, mesh)
    assert got == want == (merge_join_count_numpy(rk, sk), 0)
    assert tdm.dist_mway_join_count(rk, sk, NR, NS, mesh,
                                    use_kernels=False) == want


def test_dist_mway_overlap_equals_jax():
    """overlap=True: permute rounds and two group merges as the runs
    arrive, then the final two-way merge (the JAX baseline route falls
    back to the bulk exchange; its count is the reference)."""
    rk, sk = _workload("heavy_hitter", seed=3)
    want = jdm.dist_mway_join_count(rk, sk, NR, NS, use_pallas=False)
    for ndev in (4, 8):
        got = tdm.dist_mway_join_count(rk, sk, NR, NS,
                                       tmesh.make_mesh(ndev, "cpu"),
                                       overlap=True, fanin=2)
        assert got == want == (merge_join_count_numpy(rk, sk), 0)


@pytest.mark.parametrize("strategy", ["NEXT", "RING", "RANDOM"])
def test_dist_mway_schedules_equal_jax(strategy):
    rk, sk = _workload("ragged_nonunique", seed=1)
    want = jdm.dist_mway_join_count(rk, sk, NR, NS, use_pallas=False,
                                    numa_strategy=strategy)
    got = _port_routes(rk, sk, NR, NS, tmesh.make_mesh(8, "cpu"),
                       numa_strategy=strategy)
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


@pytest.mark.parametrize("ndev,nR,nS", [(3, NR, NS), (6, 5, 2000)],
                         ids=["3", "6-tiny"])
def test_dist_mway_nonpow2_mesh_equals_jax(ndev, nR, nS):
    """Shard counts that are not powers of two: the received runs are
    padded with empty ones (K2 fan-in over 4 or 8 runs).  On 6 shards R
    has 5 keys, so five shards hold only pads, whose +inf must never match
    (their splitter samples read the pad at index 0)."""
    rk, sk = _workload("uniform", nR, nS, seed=ndev)
    want = jdm.dist_mway_join_count(rk, sk, nR, nS, jmesh.make_mesh(ndev),
                                    use_pallas=False)
    got = _port_routes(rk, sk, nR, nS, tmesh.make_mesh(ndev, "cpu"))
    assert got == want == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mway_2d_mesh_equals_jax():
    """A 2 x 4 (host, chip) mesh: the two-stage exchange, with the RANDOM
    schedule at the host tier on the port's side as well."""
    rk, sk = _workload("zipf", seed=2)
    want = jdm.dist_mway_join_count(rk, sk, NR, NS, jmesh.make_mesh2d(2, 4),
                                    use_pallas=False)
    mesh = tmesh.make_mesh2d(2, 4, "cpu")
    assert _port_routes(rk, sk, NR, NS, mesh) == want
    assert tdm.dist_mway_join_count(rk, sk, NR, NS, mesh,
                                    numa_strategy="RANDOM") == \
        want == (merge_join_count_numpy(rk, sk), 0)


def test_dist_mway_empty_s():
    """An empty S counts 0 on the kernel route and on the torch.sort
    baseline route, whose empty shards keep one pad slot for their
    splitter samples, as JAX's padded rows do."""
    rk, sk = _workload("uniform", 1000, 0)
    want = jdm.dist_mway_join_count(rk, sk, 1000, 0, use_pallas=False)
    mesh = tmesh.make_mesh(8, "cpu")
    assert _port_routes(rk, sk, 1000, 0, mesh) == want == (0, 0)
    assert tdm.dist_mway_join_count(rk, sk, 1000, 0, mesh,
                                    use_kernels=False) == want


def test_dist_mway_tiny_relation_on_a_wide_mesh():
    """|R| = 5 over 8 shards (tests/test_dist.py's case; the JAX package's
    count of it is held on 6 shards above): exact."""
    rk, sk = _workload("uniform", 5, 2000)
    got = _port_routes(rk, sk, 5, 2000, tmesh.make_mesh(8, "cpu"))
    assert got == (merge_join_count_numpy(rk, sk), 0) == (2000, 0)


def test_dist_mway_overflow_retry_equals_jax():
    """20,000 copies of one key on one source shard of 4 overflow its
    bucket at slack 2 (cap 16,384): both packages double the slack to 4
    (cap 32,768) and return the exact count with no overflow."""
    n = 4 * 20_000
    rng = np.random.default_rng(11)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    sk[:20_000] = 5
    mesh = tmesh.make_mesh(4, "cpu")
    # one run of the pipeline at slack 2, without the retry
    assert tdm._join(rk, sk, n, n, mesh, 2.0, tdm.BLOCKSIZE_DEFAULT, 16,
                     True, None, False, False, None, 1)[1] > 0
    want = jdm.dist_mway_join_count(rk, sk, n, n, jmesh.make_mesh(4),
                                    use_pallas=False)
    got = tdm.dist_mway_join_count(rk, sk, n, n, mesh)
    assert got == want == (n, 0)


def test_dist_mway_hot_key_past_the_jax_limbs():
    """One key with cntR * cntS = 24,000^2 >= 2^29 on one shard, where the
    JAX package raises CountLimbOverflow (no numpy fallback on this path,
    dist_mway.py:613-616): the port's int64 count equals the oracle."""
    n = 24_000
    rk = np.full(n, 9, np.int32)
    sk = np.full(n, 9, np.int32)
    got = _port_routes(rk, sk, n, n, tmesh.make_mesh(8, "cpu"))
    assert got == (merge_join_count_numpy(rk, sk), 0) == (n * n, 0)


def test_dist_mway_pre_sharded():
    """An (n, shard) array, the layout of JAX's pre_sharded input, gives
    the count of the same keys as one column."""
    rk, sk = _workload("uniform", 16_000, 16_000, seed=4)
    mesh = tmesh.make_mesh(8, "cpu")
    got = tdm.dist_mway_join_count(rk.reshape(8, -1), sk.reshape(8, -1),
                                   16_000, 16_000, mesh, pre_sharded=True)
    assert got == tdm.dist_mway_join_count(rk, sk, 16_000, 16_000, mesh) \
        == (16_000, 0)
    with pytest.raises(ValueError, match="pre_sharded"):
        tdm.dist_mway_join_count(rk.reshape(4, -1), sk.reshape(4, -1),
                                 16_000, 16_000, mesh, pre_sharded=True)


def test_dist_mway_fallbacks_are_loud(capsys):
    rk, sk = _workload("uniform", 1000, 1500, seed=5)
    want = (merge_join_count_numpy(rk, sk), 0)

    def mesh(n, hosts=None):
        return tmesh.make_mesh2d(*hosts, "cpu") if hosts else \
            tmesh.make_mesh(n, "cpu")

    for m, kw in ((mesh(2), dict(use_kernels=False, remote_pull="emulate")),
                  (mesh(4, (2, 2)), dict(remote_pull="emulate")),
                  (mesh(4), dict(overlap=True, remote_pull="emulate"))):
        assert tdm.dist_mway_join_count(rk, sk, 1000, 1500, m, **kw) == want
        err = capsys.readouterr().err
        assert "[WARN ] remote_pull" in err and "bulk path" in err
    for m in (mesh(3), mesh(4, (2, 2))):
        assert tdm.dist_mway_join_count(rk, sk, 1000, 1500, m,
                                        overlap=True) == want
        assert "[WARN ] dist m-way overlap=True requires" in \
            capsys.readouterr().err
    assert tdm.dist_mway_join_count(rk, sk, 1000, 1500, mesh(4),
                                    overlap=True,
                                    numa_strategy="RING") == want
    assert "ignores numa_strategy=RING" in capsys.readouterr().err


def test_dist_mway_refusals():
    rk, sk = _workload("uniform", 100, 100)
    mesh = tmesh.make_mesh(8, "cpu")
    # "dma" runs on a power-of-two flat mesh (tests/test_torch_remote_pull.py)
    # and raises on what K11 does not take; an unknown route raises
    with pytest.raises(ValueError, match="remote_pull='dma' needs"):
        tdm.dist_mway_join_count(rk, sk, 100, 100, tmesh.make_mesh(6, "cpu"),
                                 remote_pull="dma")
    with pytest.raises(ValueError, match="not None, 'emulate' or 'dma'"):
        tdm.dist_mway_join_count(rk, sk, 100, 100, mesh, remote_pull="rdma")
    for fanin in (6, 1):
        with pytest.raises(ValueError, match="power of two"):
            tdm.dist_mway_join_count(rk, sk, 100, 100, mesh, fanin=fanin)
        with pytest.raises(ValueError, match="power of two"):
            tdm.dist_mway_join_phased(rk, sk, 100, 100, mesh, fanin=fanin)
