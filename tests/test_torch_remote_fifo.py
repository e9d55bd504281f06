"""The remote-pull receiver of the port (``parallel/remote_fifo.py``: the
host helpers and the chunk-gated merge K9) and the varlen K2 against the
JAX package on the same seeded inputs: integers, tolerance 0.  The JAX
kernels run in Pallas interpret mode, at the sizes of
tests/test_remote_fifo.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from avx_sort_merge_joins_tpu.ops import multiwaymerge as jmw
from avx_sort_merge_joins_tpu.ops import sort as jsort
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mway as jdm
from avx_sort_merge_joins_tpu.parallel import remote_fifo as jrf
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

INF = 2**31 - 1
LANES = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU route is many small tensor ops a shard; one thread
    each keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n,me,lens,chunk,order", [
    (4, 1, [100, 0, 250, 64], 64, None),
    (4, 0, [64] * 4, 64, [2, 0, 3, 1]),
    (8, 5, [0] * 8, 16, None),
    (3, 2, [5, 1000, 33], 100, [1, 2, 0]),
    (8, 0, [81_920 * 49, 4_000_000, 1, 0, 81_920, 7, 8, 9], 81_920, None)])
def test_push_schedule_equals_jax(n, me, lens, chunk, order):
    assert trf.push_schedule(n, me, lens, chunk, order) == [
        trf.ChunkPush(p.round, p.dst, p.chunk, p.start, p.size)
        for p in jrf.push_schedule(n, me, lens, chunk, order)]


@pytest.mark.parametrize("n,cap,chunk", [(8, 1024, 256), (8, 4_014_080,
                                                           81_920),
                                         (4, 16384, 16384), (8, 1000, 256)])
def test_landing_layout_equals_jax(n, cap, chunk):
    if cap % chunk:
        for rf in (jrf, trf):
            with pytest.raises(AssertionError):
                rf.landing_layout(n, cap, chunk)
        return
    assert trf.landing_layout(n, cap, chunk) == \
        jrf.landing_layout(n, cap, chunk)


@pytest.mark.parametrize("windows,win,chunk", [(10, 16384 + 128, 4096),
                                               (5, 1, 1), (3, 4096, 81_920),
                                               (0, 8, 8)])
def test_wait_helpers_equal_jax(windows, win, chunk):
    assert trf.expected_sem_waits(windows, win, chunk) == \
        jrf.expected_sem_waits(windows, win, chunk)
    for c in (0, 1, chunk - 1, chunk, 3 * chunk + 5):
        assert trf.leaf_wait_chunk(c, win, chunk) == \
            jrf.leaf_wait_chunk(c, win, chunk)


@pytest.mark.parametrize("n,chunks,rate,order", [
    (4, 3, 2, None), (4, 4, 0, None), (8, 49, 1, None), (8, 49, 3, None),
    (4, 5, 1, [2, 0, 3, 1]), (16, 1, 1, None)])
def test_arrival_schedule_equals_jax(n, chunks, rate, order):
    got = trf.arrival_schedule(n, chunks, rate, order)
    want = jrf.arrival_schedule(n, chunks, rate, order)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("cap,tile,n_src", [
    (4 * 1024, 1024, 4), (1024 * 1024, 1024, 8), (4_014_080, 16384, 8),
    (8_011_776, 16384, 4), (16384, 16384, 2), (49_152, 16384, 16)])
def test_pick_chunk_elems_equals_jax(cap, tile, n_src):
    assert trf.pick_chunk_elems(cap, tile, n_src) == \
        jrf.pick_chunk_elems(cap, tile, n_src)


def test_full_size_chunking():
    """At 128M over 8 shards the bucket cap is 4,014,080 and the chunk
    81,920 keys: 49 chunks a strip, arrival rounds 0-391 at rate 1."""
    from avx_sort_merge_joins_tpu_torch.parallel import exchange as tex

    cap = tex.bucket_cap(16_000_000, 8, 2.0, tdm.TILE_ELEMS)
    chunk = trf.pick_chunk_elems(cap, tdm.TILE_ELEMS, 8)
    arrive = trf.arrival_schedule(8, cap // chunk)
    assert (cap, chunk, cap // chunk) == (4_014_080, 81_920, 49)
    assert (arrive.min(), arrive.max()) == (0, 391)


@pytest.mark.parametrize("env", [{}, {"SMJ_REMOTE_DMA": "1",
                                      "SMJ_REMOTE_WINDOW": "4"},
                                 {"SMJ_REMOTE_WINDOW": "0"}])
def test_env_switches_equal_jax(env, monkeypatch):
    monkeypatch.delenv("SMJ_REMOTE_DMA", raising=False)
    monkeypatch.delenv("SMJ_REMOTE_WINDOW", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert trf.remote_dma_enabled() == jrf.remote_dma_enabled()
    assert trf.push_window() == jrf.push_window()


@settings(max_examples=200, deadline=None)
@given(start=st.integers(0, 10**6), size=st.integers(1, 10**5),
       chunk=st.integers(1, 10**5))
def test_need_arithmetic_is_leaf_wait_chunk(start, size, chunk):
    """K9's need(c) = ceil(c / chunk) is the chunk count leaf_wait_chunk
    implies: reading a strip up to c means waiting for chunks [0 ..
    leaf_wait_chunk(start, c - start, chunk)] for any window start."""
    end = start + size
    need = int(trf.chunks_needed(torch.tensor(end), chunk))
    assert need == trf.leaf_wait_chunk(start, size, chunk) + 1
    assert need == trf.leaf_wait_chunk(0, end, chunk) + 1
    assert int(trf.chunks_needed(torch.tensor(0), chunk)) == 0


def _strips(lens, stride, seed=0, extra=0):
    """Ascending strips of seeded keys in a landing buffer with ``extra``
    spare slots past the strips; and the sorted union."""
    rng = np.random.default_rng(seed)
    land = np.full(len(lens) * stride + extra, INF, np.int32)
    vals = []
    for s, ln in enumerate(lens):
        v = np.sort(rng.integers(-10**6, 10**6, ln).astype(np.int32))
        land[s * stride:s * stride + ln] = v
        vals.append(v)
    return land, np.sort(np.concatenate(vals))


SCHEDULES = {
    "bulk": np.zeros((4, 4), np.int32),
    "push-next": jrf.arrival_schedule(4, 4, rate=1),
    "slow": jrf.arrival_schedule(4, 4, rate=3),
    "late-leaf": np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                           [9, 9, 9, 9], [0, 5, 10, 15]], np.int32),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_chunk_gated_merge_equals_jax(case):
    """tests/test_remote_fifo.py's four schedules at its own size (strips of
    32 rows of 128, chunks of 1,024 keys): the merged prefix, the wait
    counters and the violation flag equal JAX's, and the CPU route of
    ``chunk_gated_merge`` is the plain version."""
    tile_rows, stride_rows, chunk = 8, 32, 1024
    lens = [3900, 0, 4096, 1111]
    stride = stride_rows * LANES
    land, expect = _strips(lens, stride, extra=(tile_rows + 8) * LANES)
    jm, jw, jv = jrf.chunk_gated_merge(
        jnp.asarray(land.reshape(-1, LANES)), lens, stride_rows, chunk,
        SCHEDULES[case], tile_rows=tile_rows, interpret=True)
    tl = torch.from_numpy(land)
    tlens = torch.tensor(lens, dtype=torch.int32)
    got = trf.chunk_gated_merge(tl, tlens, stride, chunk, SCHEDULES[case])
    want = trf.chunk_gated_merge_plain(tl, tlens, stride, chunk,
                                       SCHEDULES[case])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    m, w, v = got
    total = expect.size
    np.testing.assert_array_equal(m[:total].numpy(), expect)
    np.testing.assert_array_equal(m[:total].numpy(),
                                  np.asarray(jm).reshape(-1)[:total])
    assert bool((m[total:] == INF).all())
    assert w.tolist() == np.asarray(jw).tolist() == \
        [-(-ln // chunk) for ln in lens]
    assert int(v) == int(jv) == 0


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_chunk_gated_merge_ties_equal_jax(case):
    """test_chunk_gated_merge_equals_jax's shapes with the strips drawn
    from four keys, so that ties to the lower strip decide the consumed
    prefixes at every tile boundary: the plain version, at the kernel's
    tile and at JAX's, against JAX in interpret mode."""
    tile_rows, stride_rows, chunk = 8, 32, 1024
    lens = [3900, 0, 4096, 1111]
    stride = stride_rows * LANES
    rng = np.random.default_rng(11)
    land = np.full(len(lens) * stride + (tile_rows + 8) * LANES, INF,
                   np.int32)
    for s, ln in enumerate(lens):
        land[s * stride:s * stride + ln] = np.sort(rng.integers(-2, 2, ln))
    jm, jw, jv = jrf.chunk_gated_merge(
        jnp.asarray(land.reshape(-1, LANES)), lens, stride_rows, chunk,
        SCHEDULES[case], tile_rows=tile_rows, interpret=True)
    total = sum(lens)
    tl = torch.from_numpy(land)
    tlens = torch.tensor(lens, dtype=torch.int32)
    for tile in (trf.GATE_TILE, tile_rows * LANES):
        m, w, v = trf.chunk_gated_merge_plain(tl, tlens, stride, chunk,
                                              SCHEDULES[case], tile=tile)
        np.testing.assert_array_equal(m[:total].numpy(),
                                      np.asarray(jm).reshape(-1)[:total])
        assert bool((m[total:] == INF).all())
        assert w.tolist() == np.asarray(jw).tolist() == \
            [-(-ln // chunk) for ln in lens]
        assert int(v) == int(jv) == 0


@pytest.mark.parametrize("W,lens,chunk", [
    (2, [0, 0], 64), (2, [5000, 1], 8192), (8, [0, 3, 700, 4096, 0, 1, 64,
                                                2000], 512),
    (16, [100 * i for i in range(16)], 2048)])
def test_chunk_gated_merge_plain_shapes(W, lens, chunk):
    """Empty strips, a chunk that is the whole strip and a wide fan-in,
    under every schedule shape: exact merge, ceil(len / chunk) waits, no
    violation, and the round arithmetic stalls on a late strip."""
    stride = 8192 if W == 2 else 4096
    land, expect = _strips(lens, stride, seed=W)
    nch = stride // chunk
    late = np.zeros((W, nch), np.int32)
    late[W - 1] = 50
    for arrive in (trf.arrival_schedule(W, nch, 1),
                   trf.arrival_schedule(W, nch, 3), late):
        m, w, v = trf.chunk_gated_merge_plain(
            torch.from_numpy(land), torch.tensor(lens, dtype=torch.int32),
            stride, chunk, arrive, tile=256)
        np.testing.assert_array_equal(m[:expect.size].numpy(), expect)
        assert w.tolist() == [-(-ln // chunk) for ln in lens]
        assert int(v) == 0


def test_chunk_gated_merge_refuses_what_it_does_not_take():
    land = torch.full((4 * 1024,), INF, dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    ok = np.zeros((4, 4), np.int32)
    bad = [
        (land, lens, 1024, 256, np.zeros((3, 4), np.int32), "power of two"),
        (land, lens, 1024, 256, np.array([[0, 2, 1, 3]] * 4), "non-decr"),
        (land, lens, 1024, 300, ok, "whole chunks"),
        (land, lens, 1024, 128, ok, "chunks a strip"),
        (land[:3000], lens, 1024, 256, ok, "fewer than"),
        (land, lens[:2], 1024, 256, ok, "lens must be"),
        (land, lens, 1024, 256, np.zeros(4, np.int32), "shape"),
        (land, torch.zeros((4, 2), dtype=torch.int32)[:, 0], 1024, 256, ok,
         "contiguous"),
    ]
    for args in bad:
        with pytest.raises(ValueError, match=args[-1]):
            trf.chunk_gated_merge(*args[:-1])


def test_varlen_k2_plain_equals_jax_dynamic_lens():
    """One tiny size against JAX's dynamic-lens multiway_merge (a traced
    lens vector; Pallas interpret mode): run r at r * 8 rows, fan-in 4."""
    lens = [100, 0, 1024, 7]
    stride_rows, tile_rows = 8, 8
    stride = stride_rows * LANES
    land, expect = _strips(lens, stride, seed=4,
                           extra=(tile_rows + 8) * LANES)
    with jsort.force_interpret(True):
        jout, _, jlens = jmw.multiway_merge(
            jnp.asarray(land.reshape(-1, LANES)), None,
            jnp.asarray(lens, jnp.int32), stride_rows, 4, tile_rows)
    got, glens = tmw.multiway_merge(torch.from_numpy(land), 4,
                                    lens=torch.tensor(lens, dtype=torch.int32),
                                    stride=stride)
    total = sum(lens)
    np.testing.assert_array_equal(got[:total].numpy(), expect)
    np.testing.assert_array_equal(
        got[:total].numpy(), np.asarray(jout).reshape(-1)[:total])
    assert glens.tolist() == np.asarray(jlens).tolist() == [total]
    assert bool((got[total:] == INF).all())


@pytest.mark.parametrize("fanin,lens,stride", [
    (2, [0, 0, 3, 0], 5), (4, [7, 0, 2, 9, 0, 0, 0, 1], 9),
    (8, [13] * 8 + [0] * 8, 13), (16, list(range(16)), 21),
    (2, [4_000, 1, 0, 2_999], 4_014)])
def test_varlen_k2_plain_equals_numpy(fanin, lens, stride):
    """Ragged and empty runs, strides that are not powers of two, groups
    far below their capacity: each group's region holds its runs' sorted
    union, then pads; the group sums stay on the device."""
    land, _ = _strips(lens, stride, seed=fanin, extra=3)
    got, glens = tmw.multiway_merge(
        torch.from_numpy(land), fanin,
        lens=torch.tensor(lens, dtype=torch.int32), stride=stride)
    want = np.full_like(land, INF)
    for g in range(len(lens) // fanin):
        base = g * fanin * stride
        runs = [land[(g * fanin + j) * stride:][:lens[g * fanin + j]]
                for j in range(fanin)]
        union = np.sort(np.concatenate(runs))
        want[base:base + union.size] = union
    np.testing.assert_array_equal(got.numpy(), want)
    assert glens.dtype == torch.int32 and glens.tolist() == [
        sum(lens[g * fanin:(g + 1) * fanin])
        for g in range(len(lens) // fanin)]


def test_varlen_k2_refuses_what_it_does_not_take():
    keys = torch.zeros(64, dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    for kwargs, match in (
            (dict(lens=lens, stride=None), "stride"),
            (dict(lens=lens.long(), stride=8), "int32"),
            (dict(lens=lens[:3], stride=8), "whole groups"),
            (dict(lens=lens, stride=17), "fewer than")):
        with pytest.raises(ValueError, match=match):
            tmw.multiway_merge(keys, 2, **kwargs)
    # the varlen K6 takes payloads, but only ones that match the keys
    with pytest.raises(ValueError, match="do not match"):
        tmw.multiway_merge(keys, 2, payloads=keys[:32], lens=lens, stride=8)


@pytest.mark.parametrize("pull_rate", [1, 3])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_dist_remote_pull_emulate_equals_oracle(kind, pull_rate,
                                                monkeypatch):
    """The distributed m-way join through K9 (the plain version on the CPU)
    under push-shaped arrivals at rates 1 and 3: exact, and every K9 call
    waits ceil(len / chunk) chunks per strip with no violation."""
    rng = np.random.default_rng(pull_rate)
    if kind == "uniform":
        nR, nS = 60_000, 90_000
        rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
        sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    else:
        nR, nS = 10_007, 14_013
        rk = rng.integers(1, 3000, nR).astype(np.int32)
        sk = rng.integers(1, 3000, nS).astype(np.int32)
    calls = []
    real = trf.chunk_gated_merge

    def spy(landing, lens, stride, chunk, arrive):
        out = real(landing, lens, stride, chunk, arrive)
        calls.append((lens.tolist(), chunk, out[1].tolist(), int(out[2])))
        return out

    monkeypatch.setattr(trf, "chunk_gated_merge", spy)
    cnt, ov = tdm.dist_mway_join_count(
        rk, sk, nR, nS, make_mesh(8, "cpu"), slack=3.0,
        remote_pull="emulate", pull_rate=pull_rate)
    assert (cnt, ov) == (merge_join_count_numpy(rk, sk), 0)
    assert len(calls) == 16
    for lens, chunk, waited, viol in calls:
        assert waited == [-(-ln // chunk) for ln in lens] and viol == 0


def test_dist_remote_pull_emulate_equals_jax_kernels():
    """One case through JAX's own chunk-gated kernel (use_pallas=True,
    Pallas interpret mode) on a 2-device mesh of its CPU devices, smaller
    than tests/test_remote_fifo.py:145-159: the same (count, overflow)."""
    from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh as jmake

    rng = np.random.default_rng(5)
    nR, nS = 3_001, 4_003
    rk = rng.integers(1, 1000, nR).astype(np.int32)
    sk = rng.integers(1, 1000, nS).astype(np.int32)
    want = jdm.dist_mway_join_count(rk, sk, nR, nS, jmake(2),
                                    use_pallas=True, slack=3.0,
                                    remote_pull="emulate", pull_rate=3)
    got = tdm.dist_mway_join_count(rk, sk, nR, nS, make_mesh(2, "cpu"),
                                   slack=3.0, remote_pull="emulate",
                                   pull_rate=3)
    assert got == want == (merge_join_count_numpy(rk, sk), 0)
