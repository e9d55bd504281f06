"""K2's and K6's co-rank rows on the card against their plain version,
bit for bit, and the merged columns against the plain merges.  The rows
are the scratch the coarse and fine co-rank launches write (entry mask
1 | 2), read back before the tile merge; ``corank_rows_plain`` derives
them from a stable sort.  Every test here is marked ``gpu`` and skips
without a CUDA device; the file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_corank_gpu.py -q
"""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.gpu

IMAX, IMIN = 2**31 - 1, -(2**31)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tmw.corank_fallbacks(torch.device("cuda", 0), reset=True)
    return torch.device("cuda", 0)


def _values(kind, n, rng):
    if kind == "uniform":
        return rng.integers(-(2**31 - 2), 2**31 - 1, n)
    if kind == "equal":
        return np.full(n, 7)
    # Zipf 1.0 over 1,000 values: the hot key fills long stretches of
    # every run, so ties decide most boundaries
    w = 1.0 / np.arange(1, 1001)
    return 1 + np.searchsorted(np.cumsum(w) / w.sum(), rng.random(n))


def _rows(keys, pays, fanin, tile, ngroups, stride, entry, *layout):
    scratch = tmw.corank_scratch(keys, ngroups, stride, fanin, tile)
    tmw._launch(entry, keys, pays, ngroups, stride, fanin, *layout,
                parts=1 | 2, scratch=scratch, tile=tile)
    tpg = -(-fanin * stride // tile)
    return scratch[:ngroups * (tpg + 1) * fanin].view(ngroups, tpg + 1,
                                                      fanin)


def _check_uniform(keys, pays, fanin, nruns, n, span, tile):
    ngroups = -(-nruns // fanin)
    got = _rows(keys, pays, fanin, tile, ngroups, span,
                "smj_multiway_merge", n, span)
    want = tmw.corank_rows_plain(keys, fanin, (nruns, n, span), pays,
                                 tile=tile)
    assert torch.equal(got, want)
    merged, _ = tmw.multiway_merge(keys, fanin, (nruns, n, span), pays,
                                   tile=tile)
    plain = tmw.multiway_merge_plain(keys, fanin, (nruns, n, span), pays)
    if pays is None:
        merged, plain = (merged,), (plain,)
    assert all(torch.equal(g, w) for g, w in zip(merged, plain))


def _check_varlen(keys, pays, fanin, lens, stride, tile):
    got = _rows(keys, pays, fanin, tile, lens.numel() // fanin, stride,
                "smj_multiway_merge_varlen", lens.data_ptr(), lens.numel(),
                stride)
    want = tmw.corank_rows_plain(keys, fanin, payloads=pays, lens=lens,
                                 stride=stride, tile=tile)
    assert torch.equal(got, want)
    merged, _ = tmw.multiway_merge(keys, fanin, payloads=pays, lens=lens,
                                   stride=stride, tile=tile)
    plain, _ = tmw.multiway_merge_varlen_plain(keys, fanin, lens, stride,
                                               pays)
    if pays is None:
        merged, plain = (merged,), (plain,)
    assert all(torch.equal(g, w) for g, w in zip(merged, plain))


@pytest.mark.parametrize("kind", ["uniform", "zipf", "equal"])
@pytest.mark.parametrize("fanin", [2, 8, 16])
@pytest.mark.parametrize("tile", [2048, 4096, 8192])
def test_keys_rows_equal_plain(cuda, kind, fanin, tile):
    # span 16,384 and a ragged total: many coarse intervals, a short last
    # group and a short last interval
    rng = np.random.default_rng(fanin * 7 + tile + len(kind))
    span = 16384
    n = span * fanin * 3 + 5 * span + 1234
    keys = torch.from_numpy(_values(kind, n, rng).astype(np.int32)).to(cuda)
    runs = tsort.sort_blocks(keys, n, span)
    before = _build.launches()["K2.search"]
    _check_uniform(runs, None, fanin, -(-n // span), n, span, tile)
    assert _build.launches()["K2.search"] == before
    assert tmw.corank_fallbacks(cuda) == 0


@pytest.mark.parametrize("fanin,span", [(1024, 64), (2048, 40)])
def test_keys_rows_equal_plain_at_the_largest_fanins(cuda, fanin, span):
    """Fan-in above SAMPLED_MAX_FANIN: the fine co-ranks keep the search
    in device memory."""
    rng = np.random.default_rng(fanin)
    n = fanin * span + fanin * span // 3
    keys = torch.from_numpy(_values("zipf", n, rng).astype(np.int32)).to(
        cuda)
    runs = tsort.sort_blocks_plain(keys, n, span)
    before = _build.launches()["K2.search"]
    for tile in (2048, 4096, 8192):
        _check_uniform(runs, None, fanin, -(-n // span), n, span, tile)
    assert _build.launches()["K2.search"] >= before + 3


@pytest.mark.parametrize("fanin", [2, 8, 16, 1024])
def test_pair_rows_equal_plain_with_repeated_keys_and_extreme_payloads(
        cuda, fanin):
    rng = np.random.default_rng(fanin + 5)
    span = 16384 if fanin <= 16 else 48
    n = span * fanin * 2 + 3 * span + 77
    k = rng.integers(0, 50, n).astype(np.int32)
    p = rng.integers(-3, 4, n).astype(np.int32)
    p[::13], p[::17] = IMAX, IMIN
    rk, rp = tsort.sort_blocks_pairs_plain(torch.from_numpy(k).to(cuda),
                                           torch.from_numpy(p).to(cuda), n,
                                           span)
    _check_uniform(rk, rp, fanin, -(-n // span), n, span, 4096)
    assert tmw.corank_fallbacks(cuda) == 0


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("fanin", [2, 8, 16])
@pytest.mark.parametrize("pairs", [False, True])
def test_varlen_rows_equal_plain_with_empty_runs(cuda, kind, fanin, pairs):
    rng = np.random.default_rng(fanin + 3 * pairs + len(kind))
    stride = 300_000
    lens = rng.integers(0, stride + 1, 2 * fanin)
    lens[::3] = 0
    lens[1] = stride
    land = np.full(lens.size * stride, IMAX, dtype=np.int64)
    pays = np.full_like(land, IMAX) if pairs else None
    for r, ln in enumerate(lens):
        v = _values(kind, int(ln), rng)
        if pairs:
            q = rng.integers(-2, 3, int(ln))
            q[::11] = IMAX
            o = np.lexsort((q, v))
            pays[r * stride:r * stride + ln] = q[o]
            v = v[o]
        else:
            v = np.sort(v)
        land[r * stride:r * stride + ln] = v
    tk = torch.from_numpy(land.astype(np.int32)).to(cuda)
    tp = None if pays is None else torch.from_numpy(
        pays.astype(np.int32)).to(cuda)
    tlens = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    _check_varlen(tk, tp, fanin, tlens, stride, 4096)
    assert tmw.corank_fallbacks(cuda) == 0


@pytest.mark.parametrize("cell", ["wlB_128M", "wlA_1600M"])
def test_no_fallback_at_the_cells_scaled_down_shapes(cuda, cell):
    """The cells' K2 levels at 2^23 keys a relation: workload B's sort
    (fan-in 16, 16, 2), a workload A shard's (16, 16, 4 at 2^25 keys)
    and the W = 8 merge of its received runs, uniform and Zipf 1.0: rows
    equal the plain rows, no stage overflows, no launch keeps the search
    in device memory."""
    rng = np.random.default_rng(len(cell))
    n = 1 << 23 if cell == "wlB_128M" else 1 << 25
    keys = torch.from_numpy(rng.integers(
        1, n + 1, n).astype(np.int32)).to(cuda)
    before = _build.launches()["K2.search"]
    runs = tsort.sort_blocks(keys, n, 16384)
    for _, span, nruns, w in tmw.merge_levels(n, 16384, 16):
        _check_uniform(runs, None, w, nruns, n, span, 4096)
        runs, _ = tmw.multiway_merge(runs, w, (nruns, n, span))
    if cell == "wlA_1600M":
        stride = n // 4
        for kind in ("uniform", "zipf"):
            lens = torch.from_numpy(rng.integers(
                stride // 2, stride + 1, 8).astype(np.int32)).to(cuda)
            land = torch.full((8 * stride,), IMAX, dtype=torch.int32,
                              device=cuda)
            for r in range(8):
                v = torch.from_numpy(_values(kind, int(lens[r]), rng).astype(
                    np.int32)).to(cuda)
                land[r * stride:r * stride + v.numel()] = torch.sort(v).values
            _check_varlen(land, None, 8, lens, stride, 4096)
    assert _build.launches()["K2.search"] == before
    assert tmw.corank_fallbacks(cuda) == 0


@pytest.mark.parametrize("fanin", [2, 16, 1024])
def test_corank_counter_counts_the_boundaries_without_a_sync(cuda, fanin):
    """A K2 call, traced, is counted as one "K2" launch and makes no host
    sync."""
    from torch.profiler import ProfilerActivity, profile

    span = 16384 if fanin <= 16 else 64
    n = span * fanin * 2 + 999
    runs = tsort.sort_blocks_plain(torch.from_numpy(np.random.default_rng(
        fanin).integers(0, 1000, n).astype(np.int32)).to(cuda), n, span)
    nruns = -(-n // span)
    tmw.multiway_merge(runs, fanin, (nruns, n, span))  # built and warm
    torch.cuda.synchronize()
    before = _build.launches()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            tmw.multiway_merge(runs, fanin, (nruns, n, span))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert _build.launches()["K2"] == before["K2"] + 1
