"""The plain co-rank rows of K2 and K6 (``multiwaymerge.corank_rows_plain``)
against a brute-force definition, on the CPU: run r's share of the first
``min(t * tile, live)`` outputs of its group's merge, ties to the lower
run.  The card's scratch rows are held to these rows in
``tests/test_torch_corank_gpu.py``."""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

IMAX, IMIN = 2**31 - 1, -(2**31)


def brute_rows(keys, pays, run_lens, stride, fanin, tile):
    """Rows by sorting (value, run, position) triples in Python."""
    ngroups = len(run_lens) // fanin
    tpg = -(-fanin * stride // tile)
    rows = np.zeros((ngroups, tpg + 1, fanin), dtype=np.int64)
    for g in range(ngroups):
        elems = []
        for r in range(fanin):
            base = (g * fanin + r) * stride
            for i in range(run_lens[g * fanin + r]):
                v = (int(keys[base + i]),) if pays is None else (
                    int(keys[base + i]), int(pays[base + i]))
                elems.append((v, r, i))
        elems.sort()
        for t in range(tpg + 1):
            for _, r, _ in elems[:min(t * tile, len(elems))]:
                rows[g, t, r] += 1
    return rows


def sorted_runs(values, run_lens, stride, pays=None):
    """Columns of len(run_lens) runs at ``stride``, run r the first
    run_lens[r] of ``values`` left, ascending (by pair with ``pays``),
    INT32_MAX in the slots after."""
    k = np.full(len(run_lens) * stride, IMAX, dtype=np.int64)
    p = None if pays is None else np.full_like(k, IMAX)
    at = 0
    for r, n in enumerate(run_lens):
        vk = np.asarray(values[at:at + n])
        if pays is None:
            vk = np.sort(vk)
        else:
            vp = np.asarray(pays[at:at + n])
            o = np.lexsort((vp, vk))
            vk, vp = vk[o], vp[o]
            p[r * stride:r * stride + n] = vp
        k[r * stride:r * stride + n] = vk
        at += n
    return k, p


def draw(kind, n, rng):
    if kind == "uniform":
        return rng.integers(-(2**31 - 2), 2**31 - 1, n)
    if kind == "equal":
        return np.full(n, 5)
    if kind == "zipf":  # Zipf 1.0 over 50 values: long stretches of ties
        return 1 + np.searchsorted(np.cumsum(1.0 / np.arange(1, 51)) /
                                   np.sum(1.0 / np.arange(1, 51)),
                                   rng.random(n))
    raise ValueError(kind)


def check(keys, pays, run_lens, run_stride, fanin, tile, **layout):
    tk = torch.from_numpy(keys.astype(np.int32))
    tp = None if pays is None else torch.from_numpy(pays.astype(np.int32))
    got = tmw.corank_rows_plain(tk, fanin, payloads=tp, tile=tile, **layout)
    want = brute_rows(keys, pays, run_lens, run_stride, fanin, tile)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("kind", ["uniform", "equal", "zipf"])
@pytest.mark.parametrize("fanin,tile", [(2, 7), (4, 16), (8, 5), (16, 32)])
def test_uniform_layout_rows_equal_brute_force(kind, fanin, tile):
    rng = np.random.default_rng(fanin * 31 + tile)
    span = 23
    # the last group is short: runs past `total` are empty, one is partial
    total = span * fanin + span * (fanin // 2) + 9
    nruns = -(-total // span)
    run_lens = [max(0, min(total - r * span, span))
                for r in range(-(-nruns // fanin) * fanin)]
    keys, _ = sorted_runs(draw(kind, total, rng), run_lens, span)
    keys = keys[:total]
    rows = check(np.r_[keys, np.full(len(run_lens) * span - total, IMAX)],
                 None, run_lens, span, fanin, tile,
                 uniform_lens=(nruns, total, span))
    # every row sums to min(t * tile, live)
    live = torch.tensor(run_lens).view(-1, fanin).sum(1)
    t = torch.arange(rows.shape[1]) * tile
    assert torch.equal(rows.sum(2), torch.minimum(t[None], live[:, None]))


@pytest.mark.parametrize("kind", ["uniform", "equal", "zipf"])
@pytest.mark.parametrize("fanin", [2, 8])
def test_varlen_rows_with_empty_runs_equal_brute_force(kind, fanin):
    rng = np.random.default_rng(fanin + len(kind))
    stride = 40
    run_lens = rng.integers(0, stride + 1, 3 * fanin)
    run_lens[::3] = 0  # empty runs, the first of a group among them
    run_lens[1] = stride  # a full one
    keys, _ = sorted_runs(draw(kind, int(run_lens.sum()), rng), run_lens,
                          stride)
    check(keys, None, list(run_lens), stride, fanin, 16,
          lens=torch.from_numpy(run_lens.astype(np.int32)), stride=stride)


@pytest.mark.parametrize("fanin", [2, 4, 16])
def test_pair_rows_with_repeated_keys_and_extreme_payloads(fanin):
    rng = np.random.default_rng(100 + fanin)
    stride = 30
    run_lens = list(rng.integers(0, stride + 1, 2 * fanin))
    n = int(sum(run_lens))
    k = rng.integers(0, 6, n)  # few keys: ties on the key decide by payload
    p = rng.integers(-3, 4, n)
    p[::7], p[::11] = IMAX, IMIN
    keys, pays = sorted_runs(k, run_lens, stride, p)
    check(keys, pays, run_lens, stride, fanin, 8,
          lens=torch.tensor(run_lens, dtype=torch.int32), stride=stride)


def test_all_runs_empty_gives_zero_rows():
    lens = torch.zeros(8, dtype=torch.int32)
    keys = torch.full((8 * 10,), IMAX, dtype=torch.int32)
    rows = tmw.corank_rows_plain(keys, 4, lens=lens, stride=10, tile=4)
    assert rows.shape == (2, 11, 4)
    assert not rows.any()


@pytest.mark.parametrize("fanin", [2, 16])
def test_rows_cut_the_plain_merge_into_its_tiles(fanin):
    """Merging each tile's segments [rows[t], rows[t + 1]) gives the plain
    merge's tile: the rows are the split the tile merge reads."""
    rng = np.random.default_rng(fanin)
    span, tile = 64, 32
    n = span * fanin * 2 - 17
    keys = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    runs = tsort.sort_blocks_plain(keys, n, span)
    nruns = -(-n // span)
    rows = tmw.corank_rows_plain(runs, fanin, (nruns, n, span), tile=tile)
    merged = tmw.multiway_merge_plain(runs, fanin, (nruns, n, span))
    for g in range(rows.shape[0]):
        for t in range(rows.shape[1] - 1):
            seg = torch.cat([runs[(g * fanin + r) * span + rows[g, t, r]:
                                  (g * fanin + r) * span + rows[g, t + 1, r]]
                             for r in range(fanin)])
            lo = g * fanin * span + t * tile
            assert torch.equal(torch.sort(seg).values,
                               merged[lo:lo + seg.numel()])
