"""The remote pull of the port (``parallel/remote_fifo.py``:
``remote_pull_exchange_merge``, kernel K11, here its plain version on a
CPU mesh) and ``dist_mway_join_count(..., remote_pull="dma")`` against
the JAX package on the same seeded inputs: integers, tolerance 0.

The JAX K11 (``_remote_pull_kernel``) is not run: it needs several chips,
and in Pallas interpret mode on two CPU devices its merged columns come
out wrong and change from run to run.  The port is held to the contract
its module's test plan fixes, through JAX functions that do run on the
CPU: the landing equals the all-to-all of the buckets (step 1), the merged
column equals JAX's chunk-gated merge of that landing under all-zero
arrivals (Pallas interpret mode), the waits equal ``leaf_wait_chunk`` /
``expected_sem_waits``, and the join counts equal the JAX bulk and
``"emulate"`` routes (step 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mway as jdm
from avx_sort_merge_joins_tpu.parallel import remote_fifo as jrf
from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
from avx_sort_merge_joins_tpu_torch.parallel.mesh import (make_mesh,
                                                          make_mesh2d)

INF = 2**31 - 1
DMAX = 2**31 - 2  # keys lie in [-DMAX, DMAX]
LANES = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU route is many small tensor ops a shard; one thread
    each keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _buckets(n, cap, case, seed):
    """(bflat, counts) of one relation on n shards: shard me's bucket d
    holds counts[me, d] ascending keys at [me, d*cap], pads after.
    "empty": half the buckets and every bucket for shard 0 empty; "hot":
    every bucket for the last shard full of one key, all others empty;
    "domain_ends": keys at both ends of the key domain."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, (n, n))
    if case == "empty":
        counts[rng.random((n, n)) < 0.5] = 0
        counts[:, 0] = 0
    elif case == "hot":
        counts[:] = 0
        counts[:, -1] = cap
    bflat = np.full((n, n * cap), INF, np.int32)
    for me in range(n):
        for d in range(n):
            c = counts[me, d]
            if case == "hot":
                keys = np.full(c, 7)
            elif case == "domain_ends":
                keys = rng.choice([-DMAX, -DMAX + 1, 0, DMAX - 1, DMAX], c)
            else:
                keys = rng.integers(-10**6, 10**6, c)
            bflat[me, d * cap:d * cap + c] = np.sort(keys)
    return torch.from_numpy(bflat), torch.from_numpy(counts.astype(np.int32))


@pytest.mark.parametrize("case", ["uniform", "empty", "hot", "domain_ends"])
@pytest.mark.parametrize("n,cap,chunk", [(2, 4096, 4096), (4, 4096, 1024),
                                         (8, 3000, 1000), (4, 1000, 5),
                                         (16, 2048, 512)])
def test_plain_landing_is_the_all_to_all(n, cap, chunk, case):
    """Step 1 and 2 of the JAX test plan: the pushes, full chunks in the
    JAX walk's order, land as the mesh's all-to-all of the buckets (held
    against JAX in tests/test_torch_mesh_exchange.py), every slot of it;
    each shard's merged column is the sorted union of its strips' live
    prefixes, pads after; the waits are ceil(count / chunk), the flags 0,
    whatever the send window."""
    mesh = make_mesh(n, "cpu")
    bflat, counts = _buckets(n, cap, case, n + chunk)
    rcounts = mesh.all_to_all(counts)
    merged, waited, viol, landing = trf.remote_pull_exchange_merge(
        mesh, bflat, rcounts, cap, chunk)
    assert torch.equal(landing, mesh.all_to_all(bflat))
    for d in range(n):
        live = torch.cat([landing[d, r * cap:r * cap + int(rcounts[d, r])]
                          for r in range(n)])
        assert torch.equal(merged[d, :live.numel()], torch.sort(live).values)
        assert bool((merged[d, live.numel():] == INF).all())
    assert waited.dtype == torch.int32 and waited.shape == (n, n)
    assert torch.equal(waited, (rcounts + chunk - 1) // chunk)
    assert viol.shape == (n,) and int(viol.abs().sum()) == 0
    for window in (1, 4):
        again = trf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap,
                                               chunk, window=window)
        assert all(torch.equal(a, b) for a, b in
                   zip(again, (merged, waited, viol, landing)))


TILE = 4096  # output keys a merge tile of the port's K11 (and K2)
EDGE_LENS = (TILE - 1, TILE, TILE + 1, 3 * TILE + 7)  # the tile's edges


@pytest.mark.parametrize("case", ["uniform", "tile_edges", "hot"])
def test_plain_merge_equals_jax_chunk_gated_merge(case):
    """Two shards' merged columns against JAX's chunk-gated merge of the
    same landing under all-zero arrivals (Pallas interpret mode), the
    waits and flags too.  "uniform": tests/test_remote_fifo.py's size,
    strips of 32 rows of 128, chunks of 1,024 keys, 4 strips, one empty.
    "tile_edges": strips of 4,095, 4,096, 4,097 and 12,295 keys, where the
    kernel's merge tiles of 4,096 outputs have their edges; "hot": one key
    filling every strip of one shard, and half of each strip of the other
    between uniform keys.  Both on strips of 128 rows, chunks of 4,096, so
    that they share one JAX program."""
    n, tile_rows = 4, 8
    stride_rows, chunk = (32, 1024) if case == "uniform" else (128, 4096)
    cap = stride_rows * LANES
    mesh = make_mesh(n, "cpu")
    bflat, counts = _buckets(n, cap, "uniform", 11)
    if case == "uniform":
        counts[0, 1] = 0  # shard 1 gets an empty strip
    elif case == "tile_edges":
        for me in range(n):
            for d in (1, 3):  # shard d's strips: every edge length once
                ln = EDGE_LENS[(me + d) % n]
                counts[me, d] = ln
                bflat[me, d * cap:(d + 1) * cap] = INF
                bflat[me, d * cap:d * cap + ln] = torch.from_numpy(np.sort(
                    np.random.default_rng(me * n + d).integers(
                        -DMAX, DMAX + 1, ln)).astype(np.int32))
    else:  # hot
        rng = np.random.default_rng(7)
        for me in range(n):
            counts[me, 1] = cap  # shard 1: one key everywhere
            bflat[me, cap:2 * cap] = 7
            ln = int(counts[me, 3])  # shard 3: half its keys are 7
            keys = np.where(rng.random(ln) < 0.5, 7,
                            rng.integers(-10**6, 10**6, ln))
            bflat[me, 3 * cap:3 * cap + ln] = torch.from_numpy(
                np.sort(keys).astype(np.int32))
    rcounts = mesh.all_to_all(counts)
    merged, waited, viol, landing = trf.remote_pull_exchange_merge(
        mesh, bflat, rcounts, cap, chunk)
    spare = np.full(((tile_rows + 8) * LANES,), INF, np.int32)
    for d in (1, 3):
        land = np.concatenate([landing[d].numpy(), spare])
        jm, jw, jv = jrf.chunk_gated_merge(
            jnp.asarray(land.reshape(-1, LANES)), rcounts[d].tolist(),
            stride_rows, chunk, np.zeros((n, cap // chunk), np.int32),
            tile_rows=tile_rows, interpret=True)
        total = int(rcounts[d].sum())
        np.testing.assert_array_equal(merged[d, :total].numpy(),
                                      np.asarray(jm).reshape(-1)[:total])
        assert waited[d].tolist() == np.asarray(jw).tolist()
        assert int(viol[d]) == int(jv) == 0
    if case == "tile_edges":
        assert sorted(rcounts[1].tolist()) == sorted(EDGE_LENS)


@pytest.mark.parametrize("n,cap,chunk", [(8, 81_920 * 3, 81_920),
                                         (4, 4096, 128), (2, 1000, 1000)])
def test_plain_waits_equal_jax_wait_helpers(n, cap, chunk):
    """Every strip's wait count is the chunk count JAX's leaf gate waits
    for when a leaf reads the strip to its end: leaf_wait_chunk(0, len,
    chunk) + 1, the last of expected_sem_waits over one window of the
    strip's length, and 0 for an empty strip."""
    mesh = make_mesh(n, "cpu")
    rng = np.random.default_rng(n)
    counts = rng.integers(0, cap + 1, (n, n)).astype(np.int32)
    counts[0, :] = [0, 1, chunk - 1, chunk, chunk + 1, cap, cap - 1,
                    2 * chunk][:n]
    bflat = torch.full((n, n * cap), INF, dtype=torch.int32)
    for me in range(n):
        for d in range(n):
            bflat[me, d * cap:d * cap + counts[me, d]] = torch.arange(
                int(counts[me, d]), dtype=torch.int32)
    rcounts = mesh.all_to_all(torch.from_numpy(counts))
    _, waited, _, _ = trf.remote_pull_exchange_merge(mesh, bflat, rcounts,
                                                     cap, chunk)
    for d in range(n):
        for r in range(n):
            ln = int(rcounts[d, r])
            want = (jrf.leaf_wait_chunk(0, ln, chunk) + 1 if ln else 0)
            if ln:
                assert want == jrf.expected_sem_waits(1, ln, chunk)[-1] + 1
            assert int(waited[d, r]) == want


def test_dist_dma_equals_jax_bulk_and_emulate():
    """One case on 2 shards against the JAX join on 2 of its CPU devices,
    its bulk route (XLA) and its "emulate" route (its chunk-gated kernel
    in Pallas interpret mode): the port's "dma", bulk and "emulate" routes
    give the same (count, overflow)."""
    from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh as jmake

    rng = np.random.default_rng(5)
    nR, nS = 3_001, 4_003
    rk = rng.integers(1, 1000, nR).astype(np.int32)
    sk = rng.integers(1, 1000, nS).astype(np.int32)
    want = (merge_join_count_numpy(rk, sk), 0)
    assert jdm.dist_mway_join_count(rk, sk, nR, nS, jmake(2),
                                    use_pallas=False, slack=3.0) == want
    assert jdm.dist_mway_join_count(rk, sk, nR, nS, jmake(2),
                                    use_pallas=True, slack=3.0,
                                    remote_pull="emulate") == want
    mesh = make_mesh(2, "cpu")
    for route in ("dma", None, "emulate"):
        assert tdm.dist_mway_join_count(rk, sk, nR, nS, mesh, slack=3.0,
                                        remote_pull=route) == want


def _relations(kind, nR, nS, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    elif kind == "ragged":
        rk = rng.integers(1, 3000, nR).astype(np.int32)
        sk = rng.integers(1, 3000, nS).astype(np.int32)
    elif kind == "zipf":  # Zipf S (alpha 1.2) over unique R
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = np.minimum(rng.zipf(1.2, nS), nR).astype(np.int32)
    else:  # "hot": 90% of S is one key, R holds it 50 times
        rk = np.concatenate([rng.permutation(np.arange(1, nR - 49)),
                             np.full(50, 7)]).astype(np.int32)
        sk = np.where(rng.random(nS) < 0.9, 7,
                      rng.integers(1, nR + 1, nS)).astype(np.int32)
    return rk, sk


@pytest.mark.parametrize("kind", ["uniform", "ragged", "zipf", "hot"])
@pytest.mark.parametrize("n", [4, 8])
def test_dist_dma_equals_oracle(n, kind, monkeypatch):
    """The distributed m-way join through the remote pull (its plain
    version on the CPU): exact against numpy, one call a relation, each
    landing the all-to-all of its buckets, waits ceil(count / chunk) at
    the emulate route's chunk, no flag; the skewed inputs go through the
    slack retry."""
    nR, nS = (12_007, 16_013) if n == 8 else (6_001, 9_001)
    rk, sk = _relations(kind, nR, nS, n)
    calls = []
    real = trf.remote_pull_exchange_merge

    def spy(mesh, bflat, rcounts, cap, chunk, window=None):
        out = real(mesh, bflat, rcounts, cap, chunk, window)
        calls.append((cap, chunk))
        assert torch.equal(out[3], mesh.all_to_all(bflat))
        assert torch.equal(out[1], (rcounts + chunk - 1) // chunk)
        assert int(out[2].abs().sum()) == 0
        return out

    monkeypatch.setattr(trf, "remote_pull_exchange_merge", spy)
    before = _build.launches()
    got = tdm.dist_mway_join_count(rk, sk, nR, nS, make_mesh(n, "cpu"),
                                   remote_pull="dma")
    assert got == (merge_join_count_numpy(rk, sk), 0)
    assert _build.launches() == before  # the plain version launches nothing
    assert len(calls) % 2 == 0 and calls
    for cap, chunk in calls:
        assert chunk == trf.pick_chunk_elems(cap, tdm.TILE_ELEMS, n)


@pytest.mark.parametrize("strategy", ["RING", "RANDOM"])
def test_dist_dma_takes_any_schedule(strategy):
    """A schedule orders only the bulk exchange's rounds, which the pushes
    replace: "dma" takes RING and RANDOM, pushes in NEXT order, and counts
    exactly."""
    rk, sk = _relations("uniform", 6_001, 9_001, 3)
    assert tdm.dist_mway_join_count(rk, sk, 6_001, 9_001,
                                    make_mesh(4, "cpu"), remote_pull="dma",
                                    numa_strategy=strategy) == \
        (merge_join_count_numpy(rk, sk), 0)


def test_dma_refusals():
    """What K11 does not take raises, and the join never falls back from
    "dma": a shard count that is not a power of two >= 2, a 2-D mesh,
    overlap, the baseline route, an unknown route; an undersized strip
    (step 5), a negative count, strips of partial chunks, strided or
    wrongly typed tensors, a window below 1."""
    rk, sk = _relations("uniform", 500, 700, 0)
    for mesh, kw, match in (
            (make_mesh(3, "cpu"), {}, "n_chips=3"),
            (make_mesh(6, "cpu"), {}, "n_chips=6"),
            (make_mesh(1, "cpu"), {}, "n_chips=1"),
            (make_mesh2d(2, 2, "cpu"), {}, "mesh_axes=..host., .chips.."),
            (make_mesh(4, "cpu"), {"overlap": True}, "overlap=True"),
            (make_mesh(4, "cpu"), {"use_kernels": False}, "use_kernels=False"),
            (make_mesh(4, "cpu"), {"remote_pull": "push"}, "not None")):
        kw = {"remote_pull": "dma", **kw}
        with pytest.raises(ValueError, match=match):
            tdm.dist_mway_join_count(rk, sk, 500, 700, mesh, **kw)

    mesh = make_mesh(4, "cpu")
    bflat, counts = _buckets(4, 1024, "uniform", 2)
    rcounts = mesh.all_to_all(counts)
    for bad in (1025, -1):
        wrong = rcounts.clone()
        wrong[1, 2] = bad
        with pytest.raises(ValueError, match="outside"):
            trf.remote_pull_exchange_merge(mesh, bflat, wrong, 1024, 256)
    for args, match in (
            ((mesh, bflat, rcounts, 1024, 300), "whole chunks"),
            ((mesh, bflat, rcounts, 1024, 0), "whole chunks"),
            ((mesh, bflat, rcounts.t(), 1024, 256), "contiguous"),
            ((mesh, bflat, rcounts.long(), 1024, 256), "int32"),
            ((mesh, bflat[:, :2048], rcounts, 1024, 256), r"int32\[4, 4096\]"),
            ((mesh, bflat, rcounts, 1024, 256, 0), "window"),
            ((make_mesh(3, "cpu"), bflat[:3], rcounts, 1024, 256),
             "power of two"),
            ((make_mesh2d(2, 2, "cpu"), bflat, rcounts, 1024, 256),
             "2-D mesh")):
        with pytest.raises(ValueError, match=match):
            trf.remote_pull_exchange_merge(*args)
