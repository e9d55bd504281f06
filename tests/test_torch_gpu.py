"""CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.datagen import generator as tgen
from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.models import mpass, mpsm, mway
from avx_sort_merge_joins_tpu_torch.ops import join64 as tj
from avx_sort_merge_joins_tpu_torch.ops import merge as tmg
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import partition as tpt
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _keys(n, seed, low=-(2**31 - 2), high=2**31 - 2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(low, high + 1, n).astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 1000, 16384, 16385, 100_003])
@pytest.mark.parametrize("block", [1024, 16384])
def test_block_sort_kernel_equals_plain(cuda, n, block):
    keys = _keys(max(n, 1), n, -50, 50).to(cuda)
    before = _build.launches()
    got = tsort.sort_blocks(keys, n, block)
    torch.cuda.synchronize()
    assert _build.launches()["K1"] == before["K1"] + 1
    assert torch.equal(got, tsort.sort_blocks_plain(keys, n, block))


def _edge_keys(kind, n, seed):
    """Inputs at the bitonic network's edges."""
    rng = np.random.default_rng(seed)
    dmax = 2**31 - 2
    if kind == "sorted":
        keys = np.sort(rng.integers(-dmax, dmax + 1, n))
    elif kind == "reversed":
        keys = np.sort(rng.integers(-dmax, dmax + 1, n))[::-1]
    elif kind == "equal":
        keys = np.full(n, -3)
    elif kind == "16_values":
        keys = rng.integers(0, 16, n)
    else:  # the two ends of the key domain
        keys = rng.choice(np.array([-dmax, dmax]), n)
    return torch.from_numpy(np.ascontiguousarray(keys).astype(np.int32))


@pytest.mark.parametrize("rel", [-1, 0, 1, "zero"])
@pytest.mark.parametrize("kind", ["sorted", "reversed", "equal", "16_values",
                                  "domain_ends"])
@pytest.mark.parametrize("block", tsort.SUPPORTED_BLOCKS)
def test_block_sort_kernel_edges(cuda, block, kind, rel):
    """K1 at every block size on sorted, reversed, all-equal, 16-value and
    domain-end keys, at n = block - 1, block, block + 1 and 0: the same
    blocks and pads as its plain version."""
    n = 0 if rel == "zero" else block + rel
    keys = _edge_keys(kind, block + 1, block + len(kind)).to(cuda)
    got = tsort.sort_blocks(keys, n, block)
    torch.cuda.synchronize()
    assert torch.equal(got, tsort.sort_blocks_plain(keys, n, block))


@pytest.mark.parametrize("n,span,fanin", [
    (1, 1024, 2), (5000, 1024, 4), (70_001, 1024, 16), (70_001, 2048, 2),
    (300_000, 16384, 16)])
def test_multiway_merge_kernel_equals_plain(cuda, n, span, fanin):
    runs = tsort.sort_blocks_plain(_keys(n, fanin, -1000, 1000).to(cuda), n,
                                   span)
    lens = (max(1, -(-n // span)), n, span)
    before = _build.launches()
    got, new_lens = tmw.multiway_merge(runs, fanin, lens)
    torch.cuda.synchronize()
    after = _build.launches()
    assert (after["K2"], after["K6"]) == (before["K2"] + 1, before["K6"])
    assert torch.equal(got, tmw.multiway_merge_plain(runs, fanin, lens))
    assert sum(new_lens) == n


@pytest.mark.parametrize("nR,nS,width", [
    (1, 1, 3), (5000, 7000, 100), (200_000, 150_000, 2**31 - 2)])
def test_count_kernel_equals_plain(cuda, nR, nS, width):
    rk = torch.sort(_keys(nR, 1, -width, width)).values.to(cuda)
    sk = torch.sort(_keys(nS, 2, -width, width)).values.to(cuda)
    got = tmj.merge_join_count_fused(rk, sk, nR, nS)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == int(tmj.merge_join_count_fused_plain(rk, sk, nR, nS))


K3_TILE = 1920  # merged elements a tile of csrc/merge_join_count.cu
K3_CTA = 8 * K3_TILE  # merged elements a CTA


def _k3_case(kind):
    """Sorted (R, S) at the edges of K3's merge-path tiles."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    dmax = 2**31 - 2
    if kind == "hot_key_2^16_x_2^16":
        r = s = np.full(1 << 16, 7)
    elif kind == "hot_key_in_S_over_100_tiles":
        r = np.arange(0, 4000, 2)
        s = np.r_[np.full(100 * K3_TILE, 1000), rng.integers(0, 4000, 500)]
    elif kind == "non_unique_R_and_S":
        r, s = rng.integers(0, 300, 40_000), rng.integers(0, 300, 30_000)
    elif kind == "nR_much_larger":
        r, s = rng.integers(0, 1 << 20, 500_000), rng.integers(0, 1 << 20, 50)
    elif kind == "nS_much_larger":
        r, s = rng.integers(0, 1 << 20, 50), rng.integers(0, 1 << 20, 500_000)
    elif kind == "R_of_length_1":
        r, s = np.array([77]), rng.integers(0, 100, 9000)
    elif kind == "S_of_length_1":
        r, s = rng.integers(0, 100, 9000), np.array([77])
    elif kind == "domain_ends":
        r = rng.choice(np.array([-dmax, dmax]), 5000)
        s = rng.choice(np.array([-dmax, dmax]), 7000)
    elif kind == "no_matches":
        r, s = 2 * np.arange(30_000), 2 * np.arange(20_000) + 1
    else:  # "<tile|cta>_<delta>_<nR: 1, half, n - 1>"
        size, delta, share = kind.split("_")
        n = {"tile": K3_TILE, "cta": K3_CTA}[size] + int(delta)
        nr = {"1": 1, "half": n // 2, "all": n - 1}[share]
        r, s = rng.integers(0, 40, nr), rng.integers(0, 40, n - nr)
    return (torch.sort(torch.from_numpy(np.asarray(r).astype(np.int32))
                       ).values, torch.sort(torch.from_numpy(
                           np.asarray(s).astype(np.int32))).values)


@pytest.mark.parametrize("kind", [
    "hot_key_2^16_x_2^16", "hot_key_in_S_over_100_tiles",
    "non_unique_R_and_S", "nR_much_larger", "nS_much_larger",
    "R_of_length_1", "S_of_length_1", "domain_ends", "no_matches",
    *(f"{size}_{delta}_{share}" for size in ("tile", "cta")
      for delta in (-1, 0, 1) for share in ("1", "half", "all"))])
def test_count_kernel_at_tile_edges(cuda, kind):
    """K3 exact where its merge-path tiles have their edges: hot keys over
    many tiles, duplicates on both sides, lopsided sides, a side of one
    key, the domain's ends, no match, and nR + nS at a tile's and a CTA's
    size - 1, + 0 and + 1."""
    rk, sk = (t.to(cuda) for t in _k3_case(kind))
    before = _build.launches()
    got = tmj.merge_join_count_fused(rk, sk, rk.numel(), sk.numel())
    torch.cuda.synchronize()
    assert _build.launches()["K3"] == before["K3"] + 1
    assert int(got) == int(tmj.merge_join_count_fused_plain(
        rk, sk, rk.numel(), sk.numel()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    keys = torch.arange(4096, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        tsort.sort_blocks(keys, 4096, 1024)
    with pytest.raises(ValueError):
        tsort.sort_blocks(keys.to(torch.int32)[::2], 2048, 1024)
    with pytest.raises(ValueError):
        tmj.merge_join_count_fused(keys.to(torch.int32),
                                   keys.to(torch.int32).cpu(), 10, 10)


def test_device_datagen_on_the_card_equals_the_cpu(cuda):
    n = 1 << 20
    for seed in (12345, 2**31 - 101):
        gk, gp = tgen._device_gen(n, n // 3, 4, seed, cuda)
        ck, cp = tgen._device_gen(n, n // 3, 4, seed, torch.device("cpu"))
        assert torch.equal(gk.cpu(), ck) and torch.equal(gp.cpu(), cp)


@pytest.mark.parametrize("fanin", [2, 16])
def test_mway_join_on_the_card(cuda, fanin):
    rng = np.random.default_rng(fanin)
    rk = rng.integers(0, 50_000, 300_000).astype(np.int32)
    sk = rng.integers(0, 50_000, 200_000).astype(np.int32)
    res = mway.sortmergejoin_multiway(
        Relation.from_numpy(rk, device=cuda),
        Relation.from_numpy(sk, device=cuda), fanin=fanin)
    assert res.totalresults == tmj.merge_join_count_numpy(rk, sk)


def _pairs(n, seed, kmax, pmax):
    """Seeded pairs with duplicate keys and payloads, and payloads equal
    to both pad values."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-kmax, kmax + 1, n).astype(np.int32)
    p = rng.integers(-pmax, pmax + 1, n).astype(np.int32)
    p[::97] = 2**31 - 1
    p[::89] = -(2**31)
    return torch.from_numpy(k), torch.from_numpy(p)


@pytest.mark.parametrize("n", [0, 1, 16385, 100_003])
@pytest.mark.parametrize("block", [1024, 16384])
@pytest.mark.parametrize("descending", [False, True])
def test_pair_block_sort_kernel_equals_plain(cuda, n, block, descending):
    k, p = (t.to(cuda) for t in _pairs(max(n, 1), n, 40, 3))
    before = _build.launches()
    got = tsort.sort_blocks_pairs(k, p, n, block, descending)
    torch.cuda.synchronize()
    assert _build.launches()["K5"] == before["K5"] + 1
    want = tsort.sort_blocks_pairs_plain(k, p, n, block, descending)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _edge_pairs(kind, n, seed):
    """(key, payload) inputs at the bitonic network's edges."""
    rng = np.random.default_rng(seed)
    pays = rng.integers(-(2**31), 2**31, n)
    if kind == "equal_keys":  # distinct payloads
        keys, pays = np.full(n, 5), rng.permutation(n) - n // 2
    elif kind == "equal_pairs":
        keys, pays = np.full(n, 5), np.full(n, -9)
    elif kind == "domain_ends":
        ends = np.array([-(2**31), -(2**31 - 2), 2**31 - 2, 2**31 - 1])
        keys, pays = rng.choice(ends[1:3], n), rng.choice(ends, n)
    else:
        keys = _edge_keys(kind, n, seed).numpy()
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
                 for a in (keys, pays))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("rel", [-1, 0, 1, "zero"])
@pytest.mark.parametrize("kind", ["sorted", "reversed", "equal_keys",
                                  "equal_pairs", "domain_ends"])
@pytest.mark.parametrize("block", tsort.SUPPORTED_BLOCKS)
def test_pair_block_sort_kernel_edges(cuda, block, kind, rel, descending):
    """K5 at every block size in both directions on sorted and reversed
    keys, equal keys with distinct payloads, equal pairs and the domains'
    ends, at n = block - 1, block, block + 1 and 0: the same blocks and
    pads as its plain version."""
    n = 0 if rel == "zero" else block + rel
    pairs = _edge_pairs(kind, block + 1, block + len(kind))
    k, p = (t.to(cuda) for t in pairs)
    got = tsort.sort_blocks_pairs(k, p, n, block, descending)
    torch.cuda.synchronize()
    want = tsort.sort_blocks_pairs_plain(k, p, n, block, descending)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,span", [(1, 1024), (5000, 1024), (70_001, 1024),
                                    (300_000, 16384), (2049, 1000)])
@pytest.mark.parametrize("mode", ["keys", "pairs_asc", "pairs_desc"])
def test_merge_pass_kernel_equals_plain(cuda, n, span, mode):
    k, p = (t.to(cuda) for t in _pairs(n, n, 500, 2))
    desc = mode == "pairs_desc"
    nruns = max(1, -(-n // span))
    # runs of `span` elements, each sorted in the pass's direction
    packed = tsort.pack_pairs(k, p if mode != "keys" else torch.zeros_like(p))
    runs = tsort.sorted_groups(packed, n, span, desc)
    rk, rp = tsort.unpack_pairs(runs)
    pay = None if mode == "keys" else rp
    before = _build.launches()
    got = tsort.merge_pass(rk, pay, (nruns, n, span), desc)
    torch.cuda.synchronize()
    assert _build.launches()["K4"] == before["K4"] + 1
    want = tsort.merge_pass_plain(rk, pay, (nruns, n, span), desc)
    assert torch.equal(got[0], want[0])
    if pay is not None:
        assert torch.equal(got[1], want[1])


K4_TILE = 4096  # outputs a merge-path tile of csrc/merge_pass.cu
K4_CTA = 7 * K4_TILE  # outputs a CTA of it: 7 tiles


def _merge_pass_both(keys, pays, desc=False, **kw):
    """K4 and its plain version on the same runs, one launch checked."""
    before = _build.launches()
    if "lens" in kw:
        got = tsort.merge_pass(keys, pays, **kw)
        want = tsort.merge_pass_plain(keys, pays, **kw)
    else:
        got = tsort.merge_pass(keys, pays, kw["uniform_lens"], desc)
        want = tsort.merge_pass_plain(keys, pays, kw["uniform_lens"], desc)
    torch.cuda.synchronize()
    assert _build.launches()["K4"] == before["K4"] + 1
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)


def _uniform_runs(k, p, n, span, desc):
    """Runs of ``span`` sorted in the pass's direction (pairs packed)."""
    packed = tsort.pack_pairs(k, torch.zeros_like(k) if p is None else p)
    rk, rp = tsort.unpack_pairs(tsort.sorted_groups(packed, n, span, desc))
    return rk, (None if p is None else rp)


@pytest.mark.parametrize("span", [1, K4_TILE - 1, K4_TILE, K4_TILE + 1,
                                  K4_CTA - 1, K4_CTA, K4_CTA + 1])
@pytest.mark.parametrize("b", ["empty", "one", "tile", "full"])
@pytest.mark.parametrize("mode", ["keys", "keys_desc", "pairs",
                                  "pairs_desc"])
def test_merge_pass_kernel_tile_edges(cuda, span, b, mode):
    """K4 where its tiles and CTAs have their edges: run A of 1, a tile -
    1, a tile, a tile + 1 and a CTA's outputs - 1, + 0, + 1, against a B
    run that is empty, of one element, of a tile or as long as A; keys at
    both ends of the domain, payloads equal to the pads; both directions,
    keys and pairs."""
    lb = {"empty": 0, "one": 1, "tile": min(K4_TILE, span), "full": span}[b]
    n = span + lb
    k, p = (t.to(cuda) for t in _pairs(n, span + lb, 2**31 - 2, 3))
    desc = mode.endswith("desc")
    rk, rp = _uniform_runs(k, p if mode.startswith("pairs") else None, n,
                           span, desc)
    _merge_pass_both(rk, rp, desc, uniform_lens=(-(-n // span), n, span))


@pytest.mark.parametrize("case", ["keys", "same_pairs", "payload_only",
                                  "between"])
@pytest.mark.parametrize("desc", [False, True])
def test_merge_pass_kernel_hot_key(cuda, case, desc):
    """One key fills both runs over many tiles and CTAs, so every tile
    boundary falls inside a tie: keys only, identical pairs, pairs that
    differ only in payload, and the hot key between other keys."""
    span = 3 * K4_CTA + 5
    n = 4 * span - 7
    k = torch.full((n,), -4, dtype=torch.int32, device=cuda)
    p = None
    if case == "same_pairs":
        p = torch.full_like(k, 9)
    elif case == "payload_only":
        p = torch.randint(-3, 4, (n,), dtype=torch.int32, device=cuda)
        p[::5] = INF32
        p[::7] = -(2**31)
    elif case == "between":
        k[::3] = torch.randint(-9, 9, (k[::3].numel(),), dtype=torch.int32,
                               device=cuda)
    rk, rp = _uniform_runs(k, p, n, span, desc)
    _merge_pass_both(rk, rp, desc, uniform_lens=(4, n, span))


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("stride", [1, K4_TILE + 1, 100_003])
def test_varlen_merge_pass_kernel_equals_plain(cuda, stride, pairs):
    """The varlen K4: random lens up to the stride, empty runs, a full
    run, and a run padded to an even count (a zero-length last run, as
    dist_mpass pads a shard count that is no power of two)."""
    rng = np.random.default_rng(stride)
    lens = rng.integers(0, stride + 1, 10).tolist()
    lens[2] = lens[5] = 0
    lens[7] = stride
    lens[9] = 0  # the padding run
    k, p = (t.to(cuda) for t in _pairs(10 * stride, stride, 2**31 - 2, 3))
    lk, lp = _varlen_runs(lens, stride, k, p if pairs else None)
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _merge_pass_both(lk, lp, lens=lt, stride=stride)
    got_lens = tsort.merge_pass(lk, lp, lens=lt, stride=stride)[2]
    assert got_lens.device == lk.device
    assert got_lens.tolist() == [lens[i] + lens[i + 1]
                                 for i in range(0, 10, 2)]


def test_varlen_merge_pass_kernel_hot_key_and_two_passes(cuda):
    """One key over every run and many tiles, merged through two varlen
    passes down to one run (dist_mpass's chain over 4 received runs)."""
    stride = 2 * K4_CTA + 3
    lens = [stride, 17, 0, stride - 1]
    k = torch.full((4 * stride,), 77, dtype=torch.int32, device=cuda)
    p = torch.randint(-2, 3, (4 * stride,), dtype=torch.int32, device=cuda)
    lk, lp = _varlen_runs(lens, stride, k, p)
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _merge_pass_both(lk, lp, lens=lt, stride=stride)
    k1, p1, l1 = tsort.merge_pass(lk, lp, lens=lt, stride=stride)
    _merge_pass_both(k1, p1, lens=l1, stride=2 * stride)
    k2, p2, l2 = tsort.merge_pass(k1, p1, lens=l1, stride=2 * stride)
    n = sum(lens)
    assert l2.tolist() == [n]
    want = tsort.sort_torch(lk[lk != INF32], lp[lk != INF32])
    assert torch.equal(k2[:n], want[0]) and torch.equal(p2[:n], want[1])


def test_varlen_merge_pass_refuses_on_the_card(cuda):
    keys = torch.zeros(40, dtype=torch.int32, device=cuda)
    lens = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8], dtype=torch.int32,
                        device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tsort.merge_pass(keys, None, lens=lens[::2], stride=10)
    with pytest.raises(ValueError, match="contiguous"):
        tsort.merge_pass(keys, None, lens=lens[:4].cpu(), stride=10)
    with pytest.raises(ValueError, match="not the"):
        tsort.merge_pass(keys, None, lens=lens[:2], stride=10)


@pytest.mark.parametrize("n", [1, 1025, 200_001])
def test_pair_sort_on_the_card_equals_sort_torch(cuda, n):
    k, p = (t.to(cuda) for t in _pairs(n, 3, 1000, 5))
    want = tsort.sort_torch(k, p)
    got = tsort.sort(k, p, block=1024)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tsort.sort_descending(k, p, block=1024)
    assert all(torch.equal(g, w.flip(0)) for g, w in zip(got, want))


def test_tag_merge_count_on_the_card(cuda):
    rng = np.random.default_rng(5)
    rk = np.sort(rng.integers(0, 3000, 300_000)).astype(np.int32)
    sk = np.sort(rng.integers(0, 3000, 200_001)).astype(np.int32)
    stats = tmj.merge_join_count(torch.from_numpy(rk).to(cuda),
                                 torch.from_numpy(sk).to(cuda),
                                 len(rk), len(sk))
    assert tmj.finish_count(stats) == tmj.merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("algo", ["m-pass", "mpsm"])
def test_mpass_and_mpsm_joins_on_the_card(cuda, algo):
    rng = np.random.default_rng(9)
    rk = rng.integers(0, 50_000, 300_000).astype(np.int32)
    sk = rng.integers(0, 50_000, 200_001).astype(np.int32)
    R = Relation.from_numpy(rk, device=cuda)
    S = Relation.from_numpy(sk, device=cuda)
    if algo == "m-pass":
        before = _build.launches()
        res = mpass.sortmergejoin_multipass(R, S, block=1024)
        assert _build.launches()["K4"] - before["K4"] == 9 + 8
    else:
        before = _build.launches()
        res = mpsm.sortmergejoin_mpsm(R, S, nchunks=3)
        assert _build.launches()["K3"] - before["K3"] == 3
    assert res.totalresults == tmj.merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("n,span,fanin", [
    (1, 1024, 2), (5000, 1024, 4), (70_001, 1024, 16), (70_001, 2048, 2),
    (300_000, 16384, 16), (2049, 1000, 4)])
@pytest.mark.parametrize("kmax,pmax", [(500, 2), (1, 0), (2**31 - 2, 2**31 - 2)])
def test_pair_multiway_merge_kernel_equals_plain(cuda, n, span, fanin, kmax,
                                                 pmax):
    """K6: ragged totals, identical pairs in several runs (kmax=1, pmax=0)
    and payloads equal to the pad values."""
    k, p = (t.to(cuda) for t in _pairs(n, n + fanin, kmax, pmax))
    nruns = max(1, -(-n // span))
    rk, rp = tsort.unpack_pairs(tsort.sorted_groups(tsort.pack_pairs(k, p),
                                                    n, span))
    before = _build.launches()
    (gk, gp), new_lens = tmw.multiway_merge(rk, fanin, (nruns, n, span), rp)
    torch.cuda.synchronize()
    after = _build.launches()
    assert (after["K2"], after["K6"]) == (before["K2"], before["K6"] + 1)
    wk, wp = tmw.multiway_merge_plain(rk, fanin, (nruns, n, span), rp)
    assert torch.equal(gk, wk) and torch.equal(gp, wp)
    assert sum(new_lens) == n


@pytest.mark.parametrize("n", [1, 16384, 16385, 1_000_003])
def test_pair_multiway_sort_on_the_card_equals_sort_torch(cuda, n):
    k, p = (t.to(cuda) for t in _pairs(n, 7, 1000, 5))
    gk, gp = tmw.multiway_sort(k, n, fanin=4, payloads=p)
    wk, wp = tsort.sort_torch(k, p)
    assert torch.equal(gk[:n], wk) and torch.equal(gp[:n], wp)
    assert bool((gk[n:] == 2**31 - 1).all() and (gp[n:] == 2**31 - 1).all())


@pytest.mark.parametrize("na,nb", [(20000, 20000), (16384, 9000), (5, 40000),
                                   (0, 7), (7, 0)])
def test_merge_tuples_on_the_card(cuda, na, nb):
    ka, pa = tsort.sort_torch(*(t.to(cuda) for t in _pairs(max(na, 1), 1,
                                                           300, 2)))
    kb, pb = tsort.sort_torch(*(t.to(cuda) for t in _pairs(max(nb, 1), 2,
                                                           300, 2)))
    gk, gp = tmg.merge_tuples(ka, pa, kb, pb, na, nb)
    wk, wp = tmg.scalar_merge_tuples(ka, pa, kb, pb, na, nb)
    assert torch.equal(gk, wk) and torch.equal(gp, wp)
    gk, none = tmg.merge_tuples(ka, None, kb, None, na, nb)
    assert none is None and torch.equal(gk, wk)


K7_TILE = 1920  # merged elements a tile of K7 (csrc/merge_join_count.cu)
K7_CTA = 16 * K7_TILE  # merged elements a CTA of K7


def _wide_keys(n, seed):
    """n int64 keys drawn from n // 3 values spread over the int64 range:
    the hi plane varies and keys repeat; the lo plane wraps at 2^32 - 1."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**62), 2**62, max(2, n // 3)).astype(np.int64)
    pool[0], pool[1] = 2**32 - 1, 2**32
    return pool[rng.integers(0, len(pool), n)]


def k7_case(kind):
    """Sorted int64 (R, S) keys at the edges of K7's merge-path tiles
    (the CPU tests of tests/test_torch_join64.py count the same)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    pool = rng.integers(-(2**62), 2**62, 40)  # the hi plane varies

    def draw(n):
        return pool[rng.integers(0, len(pool), n)]

    hot = np.int64((0x1234 << 32) | 0x9ABC)
    if kind.startswith("wide_"):  # "wide_<nR>_<nS>"
        _, nr, ns = kind.split("_")
        r, s = _wide_keys(int(nr), 3), _wide_keys(int(ns), 3)
    elif kind == "hot_key_over_3_ctas":
        r = np.r_[np.full(30_000, hot), draw(300)]
        s = np.r_[np.full(32_000, hot), draw(300)]
    elif kind == "hot_key_in_S_over_100_tiles":
        r = np.r_[hot, draw(2000)]
        s = np.r_[np.full(100 * K7_TILE, hot), draw(500)]
    elif kind == "runs_across_tile_and_window":
        # runs a little shorter and longer than a tile and than the
        # 2,048-slot window, on both sides, and keys on one side only
        lens = np.array([1919, 1920, 1921, 2047, 2048, 2049])
        keys = np.sort(pool[:6])
        r = np.r_[np.repeat(keys, lens), pool[6:20]]
        s = np.r_[np.repeat(keys, lens[::-1]), pool[20:34]]
    elif kind == "hi_ties_lo_differs":
        # two hi planes; R's lo planes even, S's any: equal hi with
        # another lo at every tile edge, and equal lo with another hi
        r = (rng.choice([5, 6], 2500) << 32) | 2 * rng.integers(0, 300, 2500)
        s = (rng.choice([5, 6], 2600) << 32) | rng.integers(0, 600, 2600)
    elif kind == "domain_ends":
        # both ends of each plane: hi -2^31 and 2^31 - 1, lo 0 and
        # 2^32 - 1 (lo_biased -2^31 and 2^31 - 1)
        ends = np.array([-2**63, -2**63 + 1, -2**63 + 2**32 - 1, -2**32, -1,
                         0, 2**32 - 1, 2**63 - 2**32, 2**63 - 2, 2**63 - 1],
                        np.int64)
        r, s = rng.choice(ends, 5000), rng.choice(ends, 7000)
    elif kind == "R_of_length_1":
        r, s = pool[[7]], draw(9000)
    elif kind == "S_of_length_1":
        r, s = draw(9000), pool[[7]]
    elif kind == "empty_R":
        r, s = pool[:0], draw(5000)
    elif kind == "empty_S":
        r, s = draw(5000), pool[:0]
    elif kind == "both_empty":
        r = s = pool[:0]
    else:  # "<tile|cta>_<delta>_<nR: 1, half, n - 1>"
        size, delta, share = kind.split("_")
        n = {"tile": K7_TILE, "cta": K7_CTA}[size] + int(delta)
        nr = {"1": 1, "half": n // 2, "all": n - 1}[share]
        r, s = draw(nr), draw(n - nr)
    return (np.sort(np.asarray(r, np.int64)),
            np.sort(np.asarray(s, np.int64)))


K7_KINDS = [
    "hot_key_over_3_ctas", "hot_key_in_S_over_100_tiles",
    "runs_across_tile_and_window", "hi_ties_lo_differs", "domain_ends",
    "R_of_length_1", "S_of_length_1", "empty_R", "empty_S", "both_empty",
    *(f"{size}_{delta}_{share}" for size in ("tile", "cta")
      for delta in (-1, 0, 1) for share in ("1", "half", "all"))]


def _plane_on(cuda, plane, offset):
    """An int32 plane on the card, as a view ``offset`` elements into its
    storage."""
    t = torch.empty(plane.size + offset, dtype=torch.int32, device=cuda)
    return t[offset:].copy_(torch.from_numpy(plane))


@pytest.mark.parametrize("moved", [None, 0, 1, 2, 3],
                         ids=["aligned", "R_hi+4B", "R_lo+4B", "S_hi+4B",
                              "S_lo+4B"])
@pytest.mark.parametrize("kind", ["wide_1_1", "wide_5000_7000",
                                  "wide_200000_150000", *K7_KINDS])
def test_count64_kernel_equals_plain(cuda, kind, moved):
    """K7 exact on keys whose hi plane varies and where its merge-path
    tiles have their edges (hot keys over many CTAs and tiles, runs across
    a tile and the window, equal hi with other lo, the planes' ends, a
    side of one key or none, nR + nS at a tile's and a CTA's size - 1, + 0
    and + 1), with all four planes 16-byte aligned or one of them a view
    at a 4-byte offset (the 4-byte copy path); one launch a call, none
    with an empty side."""
    rk, sk = k7_case(kind)
    nR, nS = rk.size, sk.size
    rhi, rlo, shi, slo = planes = [
        _plane_on(cuda, p, int(q == moved))
        for q, p in enumerate((*tj.split64(rk), *tj.split64(sk)))]
    if moved is not None and planes[moved].numel():
        assert planes[moved].data_ptr() % 16 == 4
    before = _build.launches()
    got = tmj.merge_join_count_fused64(rhi, rlo, shi, slo, nR, nS)
    torch.cuda.synchronize()
    assert _build.launches()["K7"] == before["K7"] + (nR > 0 and nS > 0)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == int(tmj.merge_join_count_fused64_plain(
        rhi, rlo, shi, slo, nR, nS)) == tj.merge_join_count_numpy64(rk, sk)
    if kind.startswith("wide_"):
        # the same hi plane against shifted lo planes: no match at all
        assert int(tmj.merge_join_count_fused64(
            torch.zeros_like(rhi), torch.arange(nR, dtype=torch.int32,
                                                device=cuda) * 2,
            torch.zeros_like(shi), torch.arange(nS, dtype=torch.int32,
                                                device=cuda) * 2 + 1,
            nR, nS)) == 0


def test_count64_hot_key_passes_2_31(cuda):
    n = 1 << 16
    hi = torch.full((n,), 5, dtype=torch.int32, device=cuda)
    lo = torch.full((n,), -9, dtype=torch.int32, device=cuda)
    assert int(tmj.merge_join_count_fused64(hi, lo, hi, lo, n, n)) == 2**32


@pytest.mark.parametrize("pallas_sort", [True, False])
def test_key8b_join_on_the_card(cuda, pallas_sort):
    rng = np.random.default_rng(11)
    rk = rng.integers(-40_000, 40_000, 300_000).astype(np.int32)
    sk = rng.integers(-40_000, 40_000, 200_001).astype(np.int32)
    before = _build.launches()
    (rhi, rlo), (shi, slo), count = tj.key8b_join_count(
        torch.from_numpy(rk).to(cuda), torch.from_numpy(sk).to(cuda),
        len(rk), len(sk), pallas_sort=pallas_sort)
    after = _build.launches()
    # 19 and 13 blocks: K5 per side, two K6 levels for R and one for S,
    # one K7
    assert [after[k] - before[k] for k in ("K5", "K6", "K7")] == \
        ([2, 3, 1] if pallas_sort else [0, 0, 0])
    assert tj.finish_count64(count) == tmj.merge_join_count_numpy(rk, sk)
    np.testing.assert_array_equal(
        tj.join64(shi.cpu().numpy(), slo.cpu().numpy()),
        np.sort(sk.astype(np.int64)))


@pytest.mark.parametrize("kind", ["pk_fk", "dup_r"])
def test_mway_materialize_on_the_card(cuda, kind):
    rng = np.random.default_rng(13)
    nR, nS = 300_000, 200_001
    rk = (rng.permutation(nR) if kind == "pk_fk"
          else rng.integers(0, 50_000, nR)).astype(np.int32)
    sk = rng.integers(0, 60_000 if kind == "dup_r" else nR + 999,
                      nS).astype(np.int32)
    sp = rng.integers(-3, 4, nS).astype(np.int32)
    res = mway.sortmergejoin_multiway(
        Relation.from_numpy(rk, device=cuda),
        Relation.from_numpy(sk, sp, device=cuda), JoinConfig(materialize=True))
    ru, rc = np.unique(rk, return_counts=True)
    order = np.lexsort((sp, sk))
    at = np.clip(np.searchsorted(ru, sk[order]), 0, len(ru) - 1)
    mult = np.where(ru[at] == sk[order], rc[at], 0)
    assert res.totalresults == int(mult.sum())
    gk, gp = res.resultlist[0].results.to_numpy()
    np.testing.assert_array_equal(gk, np.repeat(sk[order], mult))
    np.testing.assert_array_equal(gp, np.repeat(sp[order], mult))


def _domain_keys(n, seed):
    """Keys over the whole domain, both ends among them."""
    keys = _keys(n, seed)
    keys[:4] = torch.tensor([-(2**31 - 2), -(2**31 - 3), 2**31 - 3,
                             2**31 - 2], dtype=torch.int32)
    return keys


@pytest.mark.parametrize("nbits", list(range(1, 17)))
def test_radix_hist_kernel_equals_plain(cuda, nbits):
    """K8 per tile and global at every fanout, shifts up to 31 - nbits,
    three whole tiles and a ragged fourth."""
    keys = _domain_keys(3 * tpt.HIST_TILE + 4321, nbits).to(cuda)
    for shift in sorted({0, (31 - nbits) // 2, 31 - nbits}):
        before = _build.launches()
        tiles = tpt.radix_hist(keys, nbits, shift)
        total = tpt.radix_hist_any(keys, nbits, shift)
        torch.cuda.synchronize()
        assert _build.launches()["K8"] == before["K8"] + 2
        want = tpt.radix_hist_plain(keys, nbits, shift)
        assert tiles.shape == (4, 1 << nbits)
        assert torch.equal(tiles, want), shift
        assert torch.equal(total, want.sum(0, dtype=torch.int32)), shift


@pytest.mark.parametrize("nbits", [1, 7, 15, 16])
def test_radix_hist_kernel_one_bin_tile(cuda, nbits):
    """A tile of 65,536 equal keys (one bin: a 16-bit counter overflows),
    then a ragged tile of other keys."""
    keys = torch.cat([torch.full((tpt.HIST_TILE,), 2**31 - 2,
                                 dtype=torch.int32),
                      _keys(999, nbits, 1, 70_000)]).to(cuda)
    got = tpt.radix_hist(keys, nbits)
    want = tpt.radix_hist_plain(keys, nbits)
    assert torch.equal(got, want) and int(got[0].max()) == tpt.HIST_TILE
    assert torch.equal(tpt.radix_hist_any(keys, nbits),
                       want.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("nbits", [7, 14, 16])
def test_radix_hist_kernel_zipf_and_unaligned(cuda, nbits):
    """Zipf keys (most of a warp on a few bins), and a view that starts
    one key in (no int4 loads)."""
    tgen.seed_generator(3)
    keys = tgen.create_relation_zipf(300_001, 70_000, 1.0, device=cuda).keys
    for k in (keys, keys[1:]):
        want = tpt.radix_hist_plain(k, nbits)
        assert torch.equal(tpt.radix_hist(k, nbits), want)
        assert torch.equal(tpt.radix_hist_any(k, nbits),
                           tpt.radix_hist_torch(k, nbits))


@pytest.mark.parametrize("shift", [0, 7, 15])
@pytest.mark.parametrize("n", [1, 65_535, 65_536, 2 * 65_536 + 3,
                               3_000_017])
def test_radix_hist_kernel_2_16_packed(cuda, n, shift):
    """2^16 bins, which a CTA counts in the 16-bit halves of 2^15 words: a
    tile of one key, a tile - 1, a tile, ragged tiles and a share a CTA of
    the global grid; keys whose ids set or clear the bit above the lower
    2^15 bins; aligned and unaligned starts."""
    keys = _domain_keys(max(n + 1, 4), 16 + shift).to(cuda)
    upper = keys | (1 << (15 + shift))
    lower = keys & ~(1 << (15 + shift))
    for k in (keys[:n], keys[1:], upper[:n] + 1, lower[:n] + 1):
        before = _build.launches()
        tiles = tpt.radix_hist(k, 16, shift)
        total = tpt.radix_hist_any(k, 16, shift)
        torch.cuda.synchronize()
        assert _build.launches()["K8"] == before["K8"] + 2
        want = tpt.radix_hist_plain(k, 16, shift)
        assert torch.equal(tiles, want)
        assert torch.equal(total, want.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("nbits", [1, 2, 5, 8, 10, 13, 14, 15, 16])
def test_radix_hist_kernel_hot_bins(cuda, nbits):
    """Nine keys in ten on one bin (every lane of a warp on one counter),
    per tile and global."""
    rng = np.random.default_rng(nbits)
    keys = rng.integers(1, 2**31 - 1, 5 * 65_536 + 77)
    keys[rng.random(keys.size) < 0.9] = 1 + (1 << nbits) - 1
    keys = torch.from_numpy(keys.astype(np.int32)).to(cuda)
    want = tpt.radix_hist_plain(keys, nbits)
    assert torch.equal(tpt.radix_hist(keys, nbits), want)
    assert torch.equal(tpt.radix_hist_any(keys, nbits),
                       want.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("case", ["two_bins_of_a_word", "low_bin",
                                  "high_bin"])
def test_radix_hist_kernel_2_16_wraps(cuda, case):
    """40M keys on the two bins of one packed word, or on one of them: the
    16-bit halves wrap in every CTA of the global grid (and in every
    one-bin tile), low and high halves racing."""
    n = 40_000_000
    gen = torch.Generator(device=cuda).manual_seed(5)
    half = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32,
                         device=cuda)
    keys = {"two_bins_of_a_word": 1 + 2 * 321 + half,
            "low_bin": torch.full_like(half, 1 + 2 * 321),
            "high_bin": torch.full_like(half, 2 + 2 * 321)}[case]
    want = tpt.radix_hist_plain(keys, 16)
    assert torch.equal(tpt.radix_hist(keys, 16), want)
    assert torch.equal(tpt.radix_hist_any(keys, 16),
                       want.sum(0, dtype=torch.int32))


def test_partition_relation_on_the_card(cuda):
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 2**26, 200_003).astype(np.int32)
    pays = np.arange(200_003, dtype=np.int32)
    pk, pp, off, sz = tpt.partition_relation(
        torch.from_numpy(keys).to(cuda), torch.from_numpy(pays).to(cuda), 9)
    ok, op, osz = tpt.radix_cluster_numpy(keys, pays, 9)
    lk, lp = tpt.partition_live(pk, pp, off, sz)
    assert np.array_equal(sz.cpu().numpy(), osz)
    assert np.array_equal(lk.cpu().numpy(), ok)
    assert np.array_equal(lp.cpu().numpy(), op)


def _two_run_column(n, span, seed, width):
    k = _keys(n, seed, -width, width)
    return torch.cat([torch.sort(k[:span]).values,
                      torch.sort(k[span:]).values])


@pytest.mark.parametrize("nR,span_r,nS,span_s,width", [
    (1, 1, 1, 1, 3), (5000, 4096, 7000, 4096, 100),
    (4096, 4096, 3000, 2048, 100), (200_000, 131_072, 150_000, 131_072,
                                    2**31 - 2)])
def test_count2_kernel_equals_plain(cuda, nR, span_r, nS, span_s, width):
    rk = _two_run_column(nR, span_r, 1, width).to(cuda)
    sk = _two_run_column(nS, span_s, 2, width).to(cuda)
    before = _build.launches()
    got = tmj.merge_join_count_fused2(rk, sk, nR, nS, span_r, span_s)
    torch.cuda.synchronize()
    assert _build.launches()["K10"] == before["K10"] + 1
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == int(tmj.merge_join_count_fused2_plain(
        rk, sk, nR, nS, span_r, span_s))


def test_count2_hot_key_passes_2_31(cuda):
    hot = torch.full((1 << 16,), 7, dtype=torch.int32, device=cuda)
    got = tmj.merge_join_count_fused2(hot, hot, 1 << 16, 1 << 16, 40_000,
                                      1 << 15)
    assert int(got) == 1 << 32


K3_CTA = 8 * 1920  # merged elements a CTA of K3's tile body (K10's too)


@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("a,ctas", [(1, 1), (7_680, 1), (10_000, 2)])
def test_count2_kernel_at_cta_edges(cuda, a, ctas, edge):
    """Every run pair's merged length just under, at and just over a
    multiple of one CTA's tiles: R runs of a keys, S runs of b, a + b =
    ctas * 15,360 + edge."""
    b = ctas * K3_CTA + edge - a
    rk = _two_run_column(2 * a, a, a + edge + 3, 40).to(cuda)
    sk = _two_run_column(2 * b, b, b + edge + 4, 40).to(cuda)
    got = tmj.merge_join_count_fused2(rk, sk, 2 * a, 2 * b, a, b)
    assert int(got) == int(tmj.merge_join_count_fused2_plain(
        rk, sk, 2 * a, 2 * b, a, b))


def _hot_cut_column(n, span, seed):
    """Two runs whose cut falls inside the key 7's run on both sides: run
    0 ends with 7s, run 1 starts with them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.concatenate([
        np.sort(rng.integers(0, 8, span)),
        np.sort(rng.integers(7, 15, n - span))]).astype(np.int32))


@pytest.mark.parametrize("case", ["S run 1 empty", "hot key cut",
                                  "domain ends"])
def test_count2_kernel_cases(cuda, case):
    dmax = 2**31 - 2
    if case == "S run 1 empty":
        nR, span_r, nS, span_s = 200_000, 131_072, 100_000, 131_072
        rk = _two_run_column(nR, span_r, 5, 5000)
        sk = _two_run_column(nS, span_s, 6, 5000)
    elif case == "hot key cut":
        nR, span_r, nS, span_s = 90_000, 50_000, 70_000, 36_667
        rk = _hot_cut_column(nR, span_r, 7)
        sk = _hot_cut_column(nS, span_s, 8)
    else:
        nR, span_r, nS, span_s = 100_003, 60_000, 90_001, 50_000
        rng = np.random.default_rng(9)
        rk, sk = (torch.cat([torch.sort(torch.from_numpy(
            rng.choice([-dmax, dmax], m).astype(np.int32))).values
            for m in (sp, n - sp)]) for n, sp in ((nR, span_r),
                                                  (nS, span_s)))
    rk, sk = rk.to(cuda), sk.to(cuda)
    got = tmj.merge_join_count_fused2(rk, sk, nR, nS, span_r, span_s)
    want = tmj.merge_join_count_fused2_plain(rk, sk, nR, nS, span_r, span_s)
    assert int(got) == int(want) == tmj.merge_join_count_numpy(
        rk[:nR].cpu().numpy(), sk[:nS].cpu().numpy())


def test_mway_count2_route_on_the_card(cuda, monkeypatch):
    """SMJ_COUNT2=1: 19 blocks a side take one fan-in-16 level to two
    runs, then K10; K3 is not launched."""
    monkeypatch.setenv("SMJ_COUNT2", "1")
    rng = np.random.default_rng(6)
    rk = rng.integers(0, 50_000, 300_000).astype(np.int32)
    sk = rng.integers(0, 50_000, 300_001).astype(np.int32)
    before = _build.launches()
    got = mway._mway_count_device(torch.from_numpy(rk).to(cuda),
                                  torch.from_numpy(sk).to(cuda), len(rk),
                                  len(sk), 16, 16384)
    torch.cuda.synchronize()
    after = _build.launches()
    assert (after["K3"], after["K10"], after["K2"]) == (
        before["K3"], before["K10"] + 1, before["K2"] + 2)
    assert int(got) == tmj.merge_join_count_numpy(rk, sk)


def _landing(lens, stride, seed, kmax=10**6, extra=0):
    """Ascending strips of seeded keys (duplicates within and across
    strips) in a landing buffer on the CPU."""
    rng = np.random.default_rng(seed)
    land = np.full(len(lens) * stride + extra, 2**31 - 1, np.int32)
    for s, ln in enumerate(lens):
        land[s * stride:s * stride + ln] = np.sort(
            rng.integers(-kmax, kmax + 1, ln).astype(np.int32))
    return torch.from_numpy(land)


def _gate_schedules(W, nch):
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf

    late = np.zeros((W, nch), np.int32)
    late[W // 2] = 9
    late[-1] = 5 * np.arange(nch)
    return {"bulk": np.zeros((W, nch), np.int32),
            "push-next": trf.arrival_schedule(W, nch, 1),
            "slow": trf.arrival_schedule(W, nch, 3), "late-leaf": late}


@pytest.mark.parametrize("W", [2, 4, 8, 16])
@pytest.mark.parametrize("whole_strip", [False, True])
def test_chunk_gated_merge_kernel_equals_plain(cuda, W, whole_strip):
    """K9 over the four schedules: merged column, waits and violation flag
    equal the plain version's; one strip empty, one full, duplicates
    across strips (tie order), chunk = a whole strip or a 64th of it."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf

    stride = 64 * 1024
    chunk = stride if whole_strip else stride // 64
    rng = np.random.default_rng(W)
    lens = rng.integers(0, stride + 1, W)
    lens[0], lens[-1] = 0, stride
    land = _landing(lens, stride, W, kmax=1000, extra=777).to(cuda)
    tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for case, arrive in _gate_schedules(W, stride // chunk).items():
        before = _build.launches()
        got = trf.chunk_gated_merge(land, tlens, stride, chunk, arrive)
        torch.cuda.synchronize()
        assert _build.launches()["K9"] == before["K9"] + 1
        want = trf.chunk_gated_merge_plain(land, tlens, stride, chunk,
                                           arrive)
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
        assert got[1].tolist() == [-(-int(n) // chunk) for n in lens]
        assert int(got[2]) == 0


@pytest.mark.parametrize("W", [32, 64, 1024])
@pytest.mark.parametrize("keys", ["ragged", "one key"])
def test_chunk_gated_merge_kernel_wide(cuda, W, keys):
    """K9 above 32 strips (the co-rank windows in shared memory) on a
    landing longer than the W strips, ragged or with every slot one key
    (ties to the lower strip decide every co-rank), under the four
    schedules."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf

    stride, chunk = 8192, 1024
    rng = np.random.default_rng(W)
    lens = rng.integers(0, stride + 1, W)
    lens[0], lens[-1] = 0, stride
    land = _landing(lens, stride, W, kmax=50, extra=3 * 4096 + 5).to(cuda)
    if keys == "one key":
        land.fill_(7)
    tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for case, arrive in _gate_schedules(W, stride // chunk).items():
        got = trf.chunk_gated_merge(land, tlens, stride, chunk, arrive)
        want = trf.chunk_gated_merge_plain(land, tlens, stride, chunk,
                                           arrive)
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
        assert got[1].tolist() == [-(-int(n) // chunk) for n in lens]
        assert int(got[2]) == 0


def test_chunk_gated_merge_kernel_small_and_empty(cuda):
    """A strip of one key, all strips empty, and a landing shorter than
    one merge tile."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf

    for lens in ([1, 0], [0, 0, 0, 0], [3, 5, 0, 1]):
        land = _landing(lens, 8, len(lens), extra=3).to(cuda)
        tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
        arrive = trf.arrival_schedule(len(lens), 2, 1)
        got = trf.chunk_gated_merge(land, tlens, 8, 4, arrive)
        want = trf.chunk_gated_merge_plain(land, tlens, 8, 4, arrive)
        for g, w in zip(got, want):
            assert torch.equal(g, w), lens
    # a strided lens vector (a column of the exchanged counts) is refused,
    # not read as if it were flat
    strided = torch.zeros((4, 4), dtype=torch.int32, device=cuda)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        trf.chunk_gated_merge(land, strided, 8, 4, arrive)
    with pytest.raises(ValueError, match="contiguous"):
        tmw.multiway_merge(land, 2, lens=strided, stride=8)


@pytest.mark.parametrize("fanin", [2, 4, 8, 16])
@pytest.mark.parametrize("stride", [1000, 4_014_080 // 64, 16384])
def test_varlen_multiway_merge_kernel_equals_plain(cuda, fanin, stride):
    """Varlen K2: ragged, empty and full runs, strides that are not powers
    of two, two groups, spare slots past the last group."""
    rng = np.random.default_rng(fanin + stride)
    lens = rng.integers(0, stride + 1, 2 * fanin)
    lens[0], lens[1] = 0, stride
    land = _landing(lens, stride, fanin, kmax=500, extra=99).to(cuda)
    tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.launches()
    got, glens = tmw.multiway_merge(land, fanin, lens=tlens, stride=stride)
    torch.cuda.synchronize()
    assert _build.launches()["K2"] == before["K2"] + 1
    assert glens.device.type == "cuda"
    want, wlens = tmw.multiway_merge_varlen_plain(land, fanin, tlens, stride)
    assert torch.equal(got, want) and torch.equal(glens, wlens)


MERGE_TILE = 4096  # outputs a merge tile of csrc/merge_path.cuh
INF32 = 2**31 - 1


def _sorted_runs_uniform(k, p, n, span):
    """Runs of ``span`` sorted in (key, payload) order (keys only when p
    is None), as a level of the multiway sort gives them."""
    if p is None:
        return tsort.sorted_groups(k, n, span), None
    return tsort.unpack_pairs(tsort.sorted_groups(tsort.pack_pairs(k, p), n,
                                                  span))


def _varlen_runs(lens, stride, k, p):
    """A landing of ``len(lens)`` strips of ``stride`` slots: strip r holds
    the first lens[r] of its slice of k (and p), sorted, and pads after."""
    nr = len(lens)
    slot = torch.arange(nr * stride, device=k.device)
    live = slot % stride < torch.as_tensor(
        lens, device=k.device).repeat_interleave(stride)
    k = torch.where(live, k[:nr * stride], INF32)
    if p is None:
        return k.view(nr, stride).sort(dim=1).values.reshape(-1), None
    p = torch.where(live, p[:nr * stride], INF32)
    return tsort.unpack_pairs(tsort.pack_pairs(k, p).view(nr, stride).sort(
        dim=1).values.reshape(-1))


def _merge_both(keys, pays, fanin, **kw):
    """The kernel's and the plain version's merge, with the launch counts
    checked: one K2 or K6 launch a call."""
    before = _build.launches()
    if "lens" in kw:
        got, glens = tmw.multiway_merge(keys, fanin, payloads=pays, **kw)
        want, wlens = tmw.multiway_merge_varlen_plain(
            keys, fanin, kw["lens"], kw["stride"], pays)
        assert torch.equal(glens, wlens)
    else:
        got, _ = tmw.multiway_merge(keys, fanin, kw["uniform_lens"], pays)
        want = tmw.multiway_merge_plain(keys, fanin, kw["uniform_lens"], pays)
    torch.cuda.synchronize()
    step = (1, 0) if pays is None else (0, 1)
    after = _build.launches()
    assert (after["K2"], after["K6"]) == (before["K2"] + step[0],
                                          before["K6"] + step[1])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fanin", [2, 4, 8, 16])
@pytest.mark.parametrize("per_group", [MERGE_TILE - 1, MERGE_TILE,
                                       MERGE_TILE + 1, 3 * MERGE_TILE + 7])
@pytest.mark.parametrize("pairs", [False, True])
def test_multiway_merge_tile_edges(cuda, fanin, per_group, pairs):
    """K2 and K6 with a group total next to a tile's edges: uniform (one
    group of ragged runs) and varlen (two groups of ragged runs), keys at
    both ends of the domain, payloads equal to the pads."""
    k, p = (t.to(cuda) for t in _pairs(4 * fanin * per_group, per_group,
                                       2**31 - 2, 3))
    p = p if pairs else None
    span = -(-per_group // fanin)
    rk, rp = _sorted_runs_uniform(k, p, per_group, span)
    _merge_both(rk, rp, fanin, uniform_lens=(-(-per_group // span),
                                             per_group, span))
    rng = np.random.default_rng(per_group + fanin)
    stride = per_group
    lens = []
    for _ in range(2):  # each group's lens sum to per_group
        cut = np.sort(rng.integers(0, per_group + 1, fanin - 1))
        lens += np.diff(np.concatenate([[0], cut, [per_group]])).tolist()
    lk, lp = _varlen_runs(lens, stride, k, p)
    _merge_both(lk, lp, fanin, lens=torch.tensor(lens, dtype=torch.int32,
                                                 device=cuda), stride=stride)


@pytest.mark.parametrize("fanin", [2, 16])
@pytest.mark.parametrize("case", ["keys", "same_pairs", "payload_only"])
def test_multiway_merge_hot_key(cuda, fanin, case):
    """One key fills every run over many tiles, so every tile boundary
    falls inside a tie: keys only, identical pairs, and pairs that differ
    only in payload; then the hot key between other keys."""
    span = 8 * MERGE_TILE
    n = 2 * fanin * span
    k = torch.full((n,), 5, dtype=torch.int32, device=cuda)
    p = None
    if case == "same_pairs":
        p = torch.full_like(k, -7)
    elif case == "payload_only":
        p = torch.randint(-3, 4, (n,), dtype=torch.int32, device=cuda)
        p[::5] = INF32
        p[::7] = -(2**31)
    rk, rp = _sorted_runs_uniform(k, p, n, span)
    _merge_both(rk, rp, fanin, uniform_lens=(2 * fanin, n, span))
    k[::3] = torch.randint(-9, 9, (k[::3].numel(),), dtype=torch.int32,
                           device=cuda)
    rk, rp = _sorted_runs_uniform(k, p, n - 11, span)
    _merge_both(rk, rp, fanin, uniform_lens=(2 * fanin, n - 11, span))


@pytest.mark.parametrize("fanin,stride,ngroups", [
    (8, 4_014_080, 1), (2, 1_000_003, 2), (4, 1_000_003, 2),
    (16, 100_003, 2)])
def test_varlen_pair_merge_kernel_equals_plain(cuda, fanin, stride, ngroups):
    """Varlen K6 at the shape of dist_materialize's landing (8 strips of
    4,014,080 slots) and at odd strides: ragged, empty and full runs, spare
    slots past the last group."""
    rng = np.random.default_rng(fanin + stride)
    lens = rng.integers(0, stride + 1, fanin * ngroups)
    lens[0], lens[-1] = 0, stride
    lens[fanin // 2] = stride // 3
    n = len(lens) * stride
    k, p = (t.to(cuda) for t in _pairs(n, fanin, 50_000, 2**31 - 2))
    lk, lp = _varlen_runs(lens.tolist(), stride, k, p)
    lk = torch.cat([lk, torch.full((99,), INF32, dtype=torch.int32,
                                   device=cuda)])
    lp = torch.cat([lp, torch.full_like(lk[:99], INF32)])
    _merge_both(lk, lp, fanin, lens=torch.tensor(lens, dtype=torch.int32,
                                                 device=cuda), stride=stride)


def _buckets(n, cap, case, seed):
    """(bflat, counts) of one relation on a mesh of n shards: shard me's
    bucket d holds counts[me, d] ascending keys at [me, d*cap], pads
    after.  "empty": half the buckets and every bucket for shard 0 empty;
    "hot": every bucket for the last shard full of one key, all others
    empty; "domain_ends": keys at both ends of the key domain."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, (n, n))
    if case == "empty":
        counts[rng.random((n, n)) < 0.5] = 0
        counts[:, 0] = 0
    elif case == "hot":
        counts[:] = 0
        counts[:, -1] = cap
    dmax = 2**31 - 2
    bflat = np.full((n, n * cap), 2**31 - 1, np.int32)
    for me in range(n):
        for d in range(n):
            c = counts[me, d]
            if case == "hot":
                keys = np.full(c, 7)
            elif case == "domain_ends":
                keys = rng.choice([-dmax, -dmax + 1, 0, dmax - 1, dmax], c)
            else:
                keys = rng.integers(-dmax, dmax + 1, c)
            bflat[me, d * cap:d * cap + c] = np.sort(keys)
    return torch.from_numpy(bflat), torch.from_numpy(counts.astype(np.int32))


@pytest.mark.parametrize("case", ["uniform", "empty", "hot", "domain_ends"])
@pytest.mark.parametrize("n,cap,chunk", [
    (2, 20480, 20480), (2, 20480, 1024), (4, 1000, 5), (4, 20480, 4096),
    (8, 20480, 2048), (16, 16384, 16384), (16, 16384, 4096)])
def test_remote_pull_kernel_equals_plain(cuda, n, cap, chunk, case):
    """K11 against its plain version at windows 1, 4, 8, 32 and every push
    in flight: the landing (the whole all-to-all), the merged columns, the
    waits (ceil(count / chunk)) and the flags, exactly; one launch a call;
    chunk = a whole strip, a chunk of 5 keys (no 16-byte copies), empty
    strips and shards, a hot key over every strip, the domain's ends."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n, cuda)
    bflat, counts = _buckets(n, cap, case, n * 1000 + chunk)
    bflat, counts = bflat.to(cuda), counts.to(cuda)
    rcounts = mesh.all_to_all(counts)
    want = trf.remote_pull_exchange_merge_plain(mesh, bflat, rcounts, cap,
                                                chunk)
    assert torch.equal(want[3], mesh.all_to_all(bflat))
    waits = (rcounts + chunk - 1) // chunk
    for window in (1, 4, 8, 32, n * cap // chunk):
        before = _build.launches()
        got = trf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk,
                                             window=window)
        torch.cuda.synchronize()
        assert _build.launches()["K11"] == before["K11"] + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), window
        assert torch.equal(got[1], waits) and int(got[2].sum()) == 0


def _pull_equals_plain(cuda, n, cap, chunk, bflat, counts, windows):
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n, cuda)
    bflat, counts = bflat.to(cuda), counts.to(cuda)
    rcounts = mesh.all_to_all(counts)
    want = trf.remote_pull_exchange_merge_plain(mesh, bflat, rcounts, cap,
                                                chunk)
    for window in windows:
        got = trf.remote_pull_exchange_merge(mesh, bflat, rcounts, cap, chunk,
                                             window=window)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), window
        assert torch.equal(got[1], (rcounts + chunk - 1) // chunk)
        assert int(got[2].sum()) == 0


@pytest.mark.parametrize("lens", [[MERGE_TILE - 1], [MERGE_TILE],
                                  [MERGE_TILE + 1], [3 * MERGE_TILE + 7],
                                  [MERGE_TILE - 1, MERGE_TILE,
                                   MERGE_TILE + 1, 3 * MERGE_TILE + 7]])
@pytest.mark.parametrize("n", [2, 8])
def test_remote_pull_kernel_tile_edges(cuda, n, lens):
    """K11 with strips of 4,095, 4,096, 4,097 and 12,295 keys (each alone
    and mixed): the merge tile's boundaries fall on and beside the strips'
    ends; windows 1 and every push in flight."""
    cap, chunk = 16384, 4096
    rng = np.random.default_rng(n * 7 + len(lens))
    counts = rng.choice(np.array(lens), (n, n)).astype(np.int32)
    bflat = np.full((n, n * cap), 2**31 - 1, np.int32)
    for me in range(n):
        for d in range(n):
            c = counts[me, d]
            bflat[me, d * cap:d * cap + c] = np.sort(
                rng.integers(-(2**31 - 2), 2**31 - 1, c))
    _pull_equals_plain(cuda, n, cap, chunk, torch.from_numpy(bflat),
                       torch.from_numpy(counts), (1, n * cap // chunk))


@pytest.mark.parametrize("n,cap,chunk", [(4, 16384, 2048), (8, 8192, 1024)])
@pytest.mark.parametrize("between", [False, True])
def test_remote_pull_kernel_hot_key_over_tiles(cuda, n, cap, chunk, between):
    """K11 with one key in every bucket of every shard, over many tiles
    and every strip: alone (all full), or half of each bucket's keys
    between uniform ones."""
    rng = np.random.default_rng(n + between)
    counts = (rng.integers(cap // 2, cap + 1, (n, n)) if between
              else np.full((n, n), cap)).astype(np.int32)
    bflat = np.full((n, n * cap), 2**31 - 1, np.int32)
    for me in range(n):
        for d in range(n):
            c = counts[me, d]
            keys = np.full(c, 7)
            if between:
                keys = np.where(rng.random(c) < 0.5, 7,
                                rng.integers(-10**6, 10**6, c))
            bflat[me, d * cap:d * cap + c] = np.sort(keys)
    _pull_equals_plain(cuda, n, cap, chunk, torch.from_numpy(bflat),
                       torch.from_numpy(counts), (1, n * cap // chunk))


@pytest.mark.parametrize("case", ["uniform", "hot", "empty"])
@pytest.mark.parametrize("n", [32, 64])
def test_remote_pull_kernel_many_shards(cuda, n, case):
    """K11 on 32 and 64 shards (a co-rank lane covers one and two strips,
    one probe a round), small strips, windows 1 and every push in
    flight."""
    cap, chunk = 2048, 1024
    bflat, counts = _buckets(n, cap, case, n + len(case))
    _pull_equals_plain(cuda, n, cap, chunk, bflat, counts,
                       (1, n * cap // chunk))


def test_remote_pull_kernel_refuses_an_undersized_strip(cuda):
    """A received count above the strip (or below 0) raises after the
    launch, never clamps (the JAX test plan's step 5), and the next call
    on the same stream starts from fresh flags."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, cuda)
    bflat, counts = _buckets(4, 8192, "uniform", 3)
    bflat, counts = bflat.to(cuda), counts.to(cuda)
    rcounts = mesh.all_to_all(counts)
    first = trf.remote_pull_exchange_merge(mesh, bflat, rcounts, 8192, 1024)
    for bad in (8193, -1):
        wrong = rcounts.clone()
        wrong[2, 1] = bad
        with pytest.raises(ValueError, match="outside"):
            trf.remote_pull_exchange_merge(mesh, bflat, wrong, 8192, 1024)
        with pytest.raises(ValueError, match="outside"):
            trf.remote_pull_exchange_merge_plain(mesh, bflat, wrong, 8192,
                                                 1024)
    again = trf.remote_pull_exchange_merge(mesh, bflat, rcounts, 8192, 1024)
    for g, w in zip(again, first):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="whole chunks"):
        trf.remote_pull_exchange_merge(mesh, bflat, rcounts, 8192, 1000)
    with pytest.raises(ValueError, match="contiguous"):
        trf.remote_pull_exchange_merge(mesh, bflat, rcounts.t(), 8192, 1024)
    with pytest.raises(ValueError, match="power of two"):
        trf.remote_pull_exchange_merge(make_mesh(3, cuda), bflat[:3], rcounts,
                                       8192, 1024)


@pytest.mark.parametrize("remote_pull", [None, "emulate", "dma"])
def test_dist_mway_join_on_the_card(cuda, remote_pull):
    """A small 8-shard distributed m-way join on the card: K1, K2, K3 (and
    K9 once a shard and relation with "emulate", K11 once a relation with
    "dma") launch, the count is the oracle's."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(8)
    nR, nS = 300_007, 200_003
    rk = rng.integers(0, 50_000, nR).astype(np.int32)
    sk = rng.integers(0, 50_000, nS).astype(np.int32)
    before = _build.launches()
    got = tdm.dist_mway_join_count(rk, sk, nR, nS, make_mesh(8, cuda),
                                   remote_pull=remote_pull, pull_rate=3)
    torch.cuda.synchronize()
    assert got == (tmj.merge_join_count_numpy(rk, sk), 0)
    after = _build.launches()
    assert after["K1"] - before["K1"] == 16
    assert after["K3"] - before["K3"] == 8
    assert after["K9"] - before["K9"] == (16 if remote_pull == "emulate"
                                          else 0)
    assert after["K11"] - before["K11"] == (2 if remote_pull == "dma" else 0)
    assert after["K2"] > before["K2"]


@pytest.mark.parametrize("route", ["m-pass", "m-pass overlap", "mpsm",
                                   "materialize"])
def test_dist_joins_on_the_card(cuda, route):
    """The distributed m-pass (bulk and overlap), mpsm and materializing
    joins on an 8-shard mesh of the card at a few million keys: each
    equals its torch.sort baseline route (``use_kernels=False``) and the
    torch.sort baseline count, and launches its kernels (m-pass K1 and
    K4, three passes a shard and relation, six with overlap, and K3; mpsm
    K1 and 8^3 K3; materialize K1, K2, K5 and K6)."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_materialize
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mpass, dist_mpsm
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(13)
    nR, nS = 3_000_017, 2_000_003
    rk = torch.from_numpy(rng.integers(0, 1_000_000, nR).astype(
        np.int32)).to(cuda)
    sk = torch.from_numpy(rng.integers(0, 1_000_000, nS).astype(
        np.int32)).to(cuda)
    base = int(tmj.merge_join_count_torch(torch.sort(rk).values,
                                          torch.sort(sk).values, nR, nS))
    mesh = make_mesh(8, cuda)

    before = _build.launches()
    if route == "materialize":
        sp = torch.arange(nS, dtype=torch.int32, device=cuda)
        k, p, count, ov = dist_materialize.dist_join_materialize(
            rk, None, sk, sp, nR, nS, mesh)
        torch.cuda.synchronize()
        ran = _build.launches() - before
        k0, p0, count0, ov0 = dist_materialize.dist_join_materialize(
            rk, None, sk, sp, nR, nS, mesh, use_kernels=False)
        assert torch.equal(torch.sort(tsort.pack_pairs(k, p)).values,
                           torch.sort(tsort.pack_pairs(k0, p0)).values)
        assert ran["K1"] == ran["K5"] == 8 and ran["K2"] > 8 < ran["K6"]
        assert ran["K3"] == ran["K4"] == 0
    else:
        if route == "mpsm":
            join = dist_mpsm.dist_mpsm_join_count
            kw = {}
        else:
            join = dist_mpass.dist_mpass_join_count
            kw = {"overlap": route == "m-pass overlap"}
        count, ov = join(rk, sk, nR, nS, mesh, **kw)
        torch.cuda.synchronize()
        ran = _build.launches() - before
        count0, ov0 = join(rk, sk, nR, nS, mesh, use_kernels=False)
        assert ran["K1"] == 16 and ran["K2"] > 0
        if route == "mpsm":
            assert ran["K3"] == 512 and ran["K4"] == 0
        else:
            assert ran["K3"] == 8
            assert ran["K4"] == (96 if kw["overlap"] else 48)
    assert (count, ov) == (count0, ov0) == (base, 0)


@pytest.mark.parametrize("slack", [2.0, 4.0])
def test_scale_tier_shard_kernels(cuda, slack):
    """One shard of the workload-A scale tier at a shard of 2,000,000 keys
    (the 1.6B tier's 200,000,000 over 100): K1 and every uniform K2 level
    of R's and S's local sort, the varlen K2 (fan-in 8) over a landing of
    8 runs of the tier's bucket stride, and K3 of the two merged landings,
    each equal to its plain version."""
    from avx_sort_merge_joins_tpu_torch.parallel import dist_mway as tdm
    from avx_sort_merge_joins_tpu_torch.parallel import exchange as tex
    from avx_sort_merge_joins_tpu_torch.parallel import scale as tscale
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    shard, block = 2_000_000, 16384
    rk, sk = tscale.make_workload_a_sharded(8 * shard, 8 * shard,
                                            make_mesh(8, cuda))
    for col in (rk[0], sk[0]):
        runs = tsort.sort_blocks_plain(col, shard, block)
        assert torch.equal(tsort.sort_blocks(col, shard, block), runs)
        for level in tmw.merge_levels(shard, block, 16):
            _, span, nruns, w = level
            want = tmw.multiway_merge_plain(runs, w, (nruns, shard, span))
            got, _ = tmw.multiway_merge(runs, w, (nruns, shard, span))
            assert torch.equal(got, want)
            runs = want
        assert int(runs[shard - 1]) <= int(runs[shard]) == INF32
    cap = tex.bucket_cap(shard, 8, slack, tdm.TILE_ELEMS)
    rng = np.random.default_rng(int(slack))
    merged = []
    for _ in range(2):  # R's landing, then S's
        lens = rng.integers(shard // 8 - 5000, shard // 8 + 5000, 8)
        land = _varlen_runs(lens.tolist(), cap, torch.from_numpy(
            rng.integers(1, shard, 8 * cap).astype(np.int32)).to(cuda), None)[0]
        tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got, glens = tmw.multiway_merge(land, 8, lens=tlens, stride=cap)
        want, _ = tmw.multiway_merge_varlen_plain(land, 8, tlens, cap)
        assert torch.equal(got, want) and int(glens) == int(lens.sum())
        merged.append((want, int(lens.sum())))
    (mr, nr), (ms, ns) = merged
    assert int(tmj.merge_join_count_fused(mr, ms, nr, ns)) == \
        int(tmj.merge_join_count_fused_plain(mr, ms, nr, ns))


def test_workload_a_on_the_card(cuda):
    """The scale tier on the card at 2^22 keys a relation: R as on the CPU,
    S in range, the count |S| through the kernels, uniform and skewed."""
    from avx_sort_merge_joins_tpu_torch.parallel import scale as tscale
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, cuda)
    assert make_mesh(8).device == mesh.device  # "cuda" takes its index
    n = 1 << 22
    rk, sk = tscale.make_workload_a_sharded(n, n, mesh)
    cpu_r, _ = tscale.make_workload_a_sharded(
        n, n, make_mesh(8, torch.device("cpu")))
    assert torch.equal(rk.cpu(), cpu_r)
    assert int(sk.min()) >= 1 and int(sk.max()) <= n
    before = _build.launches()
    for skew, slack in ((0.0, 2.0), (1.0, 4.0)):
        assert tscale.workload_a_join_count(n, n, mesh, skew=skew,
                                            slack=slack) == (n, 0)
    after = _build.launches()
    assert (after["K1"] - before["K1"], after["K3"] - before["K3"]) == (32,
                                                                        16)


NEW_TILES = (2048, 8192)  # the keys-only K2's tiles besides MERGE_TILE


@pytest.mark.parametrize("tile", NEW_TILES)
@pytest.mark.parametrize("fanin", [2, 4, 8, 16])
@pytest.mark.parametrize("rel", [-1, 0, 1, "3T+7"])
def test_multiway_merge_new_tile_edges(cuda, tile, fanin, rel):
    """The keys-only K2 at the tiles ``-m`` names, a group total next to a
    tile's edges, uniform and varlen: the plain version's columns, one
    launch a call at that tile."""
    per_group = 3 * tile + 7 if rel == "3T+7" else tile + rel
    k, _ = (t.to(cuda) for t in _pairs(4 * fanin * per_group, per_group,
                                       2**31 - 2, 5))
    span = -(-per_group // fanin)
    rk, _ = _sorted_runs_uniform(k, None, per_group, span)
    ul = (-(-per_group // span), per_group, span)
    before = _build.launches()
    got, _ = tmw.multiway_merge(rk, fanin, ul, tile=tile)
    assert torch.equal(got, tmw.multiway_merge_plain(rk, fanin, ul))
    rng = np.random.default_rng(per_group + fanin)
    lens = []
    for _ in range(2):
        cut = np.sort(rng.integers(0, per_group + 1, fanin - 1))
        lens += np.diff(np.concatenate([[0], cut, [per_group]])).tolist()
    lk, _ = _varlen_runs(lens, per_group, k, None)
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got, glens = tmw.multiway_merge(lk, fanin, lens=tl, stride=per_group,
                                    tile=tile)
    want, wlens = tmw.multiway_merge_varlen_plain(lk, fanin, tl, per_group)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(glens, wlens)
    key = f"K2.tile{tile}"
    assert _build.launches()[key] == before[key] + 2


@pytest.mark.parametrize("tile", tmw.MERGE_TILES)
def test_multiway_merge_fanin_2048_and_hot_key(cuda, tile):
    """Fan-in 2,048, the kernel's largest, uniform and varlen, and one hot
    key over many tiles, at every tile."""
    fanin = tmw.MAX_FANIN
    k = _keys(2 * fanin * 5, tile, -1000, 1000).to(cuda)
    rk, _ = _sorted_runs_uniform(k, None, fanin * 5 - 3, 5)
    ul = (fanin, fanin * 5 - 3, 5)
    got, _ = tmw.multiway_merge(rk, fanin, ul, tile=tile)
    assert torch.equal(got, tmw.multiway_merge_plain(rk, fanin, ul))
    stride = 2 * tile + 1
    lens = np.random.default_rng(tile).integers(0, stride + 1, fanin)
    lk, _ = _varlen_runs(lens.tolist(), stride, _keys(
        fanin * stride, tile + 1).to(cuda), None)
    tl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got, glens = tmw.multiway_merge(lk, fanin, lens=tl, stride=stride,
                                    tile=tile)
    want, wlens = tmw.multiway_merge_varlen_plain(lk, fanin, tl, stride)
    assert torch.equal(got, want) and torch.equal(glens, wlens)
    span = 8 * tile
    hot = torch.full((32 * span,), 5, dtype=torch.int32, device=cuda)
    hot[::3] = 4
    rk, _ = _sorted_runs_uniform(hot, None, 32 * span - 9, span)
    ul = (32, 32 * span - 9, span)
    got, _ = tmw.multiway_merge(rk, 16, ul, tile=tile)
    assert torch.equal(got, tmw.multiway_merge_plain(rk, 16, ul))


def test_pair_merge_keeps_its_fanin_and_tile(cuda):
    """K6 keeps PR 14's limits while the keys-only K2 takes fan-in 2,048
    and other tiles: pairs at fan-in 1,024 (MAX_PAIR_FANIN) equal the
    plain version; fan-in 2,048 and a tile other than MERGE_TILE raise."""
    fanin = tmw.MAX_PAIR_FANIN
    k, p = (t.to(cuda) for t in _pairs(2 * fanin * 5, 11, 1000, 50))
    rk, rp = _sorted_runs_uniform(k, p, fanin * 5 - 3, 5)
    ul = (fanin, fanin * 5 - 3, 5)
    got = tmw.multiway_merge(rk, fanin, ul, rp)[0]
    want = tmw.multiway_merge_plain(rk, fanin, ul, rp)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="at most 1024"):
        tmw.multiway_merge(rk, 2 * fanin, (fanin, fanin * 5 - 3, 5), rp)
    with pytest.raises(ValueError, match="pairs merge at tiles"):
        tmw.multiway_merge(rk, fanin, ul, rp, tile=8192)


@pytest.mark.parametrize("budget", [1, 40_000, 1 << 20])
def test_mway_m_budget_runs_its_tile(cuda, budget):
    """``-m`` on the card: the count of the default configuration, every
    K2 launch at the tile merge_tile_for names."""
    n = 3_000_000
    tgen.seed_generator(3)
    R = tgen.parallel_create_relation(n, n, device=cuda)
    S = tgen.parallel_create_relation(n, n, device=cuda)
    tile = tmw.merge_tile_for(budget, mway.FANIN_DEFAULT)
    before = _build.launches()
    res = mway.sortmergejoin_multiway(R, S,
                                      JoinConfig(mwaybufsize_bytes=budget))
    torch.cuda.synchronize()
    assert res.totalresults == n
    after = _build.launches()
    k2 = after["K2"] - before["K2"]
    key = f"K2.tile{tile}"
    assert k2 > 0 and after[key] - before[key] == k2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_legs_launch_their_kernels(cuda, n):
    from avx_sort_merge_joins_tpu_torch import graft_entry as tentry

    legs = tentry.dryrun_multichip(n, cuda)
    assert len(legs) == (8 if n == 2 else 9)
    for name, leg in legs.items():
        assert all(leg["launches"].get(k, 0) > 0
                   for k in tentry.LEG_KERNELS[name]), (name, leg)
    forward, inputs = tentry.entry(cuda)
    before = _build.launches()
    assert int(forward(*inputs)) == 65536
    after = _build.launches()
    assert [after[k] - before[k] for k in ("K1", "K2", "K3")] == [2, 2, 1]


def test_results_grid_algo_cell_at_16m(cuda, tmp_path):
    """The grid's 16M m-way cell on the card: exact, timed, with the
    card's name in its row."""
    from avx_sort_merge_joins_tpu_torch.scripts import run_results_grid as rg

    g = rg.Grid(str(tmp_path / "rows.jsonl"), cuda, reps=1, burn=1)
    R, S = rg.workload(16_000_000, cuda)
    run, finish = rg._mway_thunks(R, S, 16_000_000, 16_000_000, False)
    g.run_cell("algo/m-way/16000000/cuda", "algo", "m-way", 16_000_000,
               16_000_000, "cuda", run, finish, 16_000_000)
    import json
    row = json.loads((tmp_path / "rows.jsonl").read_text())
    assert row["exact"] and row["ms"] > 0
    assert row["device"].startswith(torch.cuda.get_device_name(cuda))


def test_cardinality_last_row_counts_exactly(cuda, capsys):
    """``cardinality.sh``'s last row at its default NR: |R| = 2^27, |S| =
    16 x 2^27 = 2^31 keys on one device, through the CLI: exactly |S|."""
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    torch.cuda.empty_cache()
    rc = tcli.main(["-a", "m-way", "-r", str(1 << 27), "-s", str(1 << 31)])
    out, _ = capsys.readouterr()
    torch.cuda.empty_cache()
    assert rc == 0 and f"Results = {1 << 31}" in out


def test_run_past_the_card_exits_1(cuda, capsys):
    """A relation the card cannot hold (3 * 10^10 keys of S): exit 1 with
    the out-of-memory error, no result."""
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    rc = tcli.main(["-a", "m-way", "-r", "1000", "-s", "30000000000"])
    out, err = capsys.readouterr()
    torch.cuda.empty_cache()
    assert rc == 1 and "Results" not in out
    assert "[ERROR] out of device memory at -r 1000 -s 30000000000 -n 1:" \
        in err


# ------------------------------------------------------- mesh of cards --

def _cards(cuda, spread):
    """Eight shard devices: all cuda:0, or shard me on cuda:(me mod
    count); skips the spread case on a machine of one card."""
    count = torch.cuda.device_count()
    if spread and count < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", me % count if spread else 0)
            for me in range(8)]


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("case", ["uniform", "empty", "hot"])
def test_remote_pull_per_card_launch_equals_plain(cuda, spread, case):
    """K11 on a mesh of one device a shard: one launch a card, every
    result shard for shard equal to its plain version and to the
    one-device launch on the same buckets, at windows 1 and every push in
    flight."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import make_mesh

    devices = _cards(cuda, spread)
    n, cap, chunk = 8, 8192, 1024
    one, cards = make_mesh(n, cuda), make_mesh(n, devices=devices)
    bflat, counts = _buckets(n, cap, case, 77)
    bflat, counts = bflat.to(cuda), counts.to(cuda)
    rcounts = one.all_to_all(counts)
    rows = [bflat[me].to(devices[me]) for me in range(n)]
    rc = [rcounts[me].to(devices[me]) for me in range(n)]
    want = trf.remote_pull_exchange_merge(one, bflat, rcounts, cap, chunk)
    plain = trf.remote_pull_exchange_merge_plain(cards, rows, rc, cap, chunk)
    for window in (1, n * cap // chunk):
        before = _build.launches()
        got = trf.remote_pull_exchange_merge(cards, rows, rc, cap, chunk,
                                             window=window)
        torch.cuda.synchronize()
        assert _build.launches()["K11"] == before["K11"] + len(cards.cards)
        for g, p, w in zip(got, plain, want):
            for me in range(n):
                assert g[me].device == devices[me]
                assert torch.equal(g[me], p[me]), (window, me)
                assert torch.equal(g[me].to(cuda), w[me]), (window, me)


MESH_ROUTES = ["bulk", "RING", "RANDOM", "2-D", "overlap", "emulate", "dma",
               "dist_join", "m-pass", "mpsm", "materialize"]


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("route", MESH_ROUTES)
def test_route_on_a_mesh_of_cards(cuda, route, spread):
    """Each distributed route at 1M x 1M (unique R, foreign-key S) on a
    mesh of one device a shard: the count is |S| and the one-device
    mesh's; the materializing join's rows equal the one-device mesh's as a
    multiset."""
    from avx_sort_merge_joins_tpu_torch.parallel import (dist_join,
                                                         dist_materialize,
                                                         dist_mpass,
                                                         dist_mpsm,
                                                         dist_mway)
    from avx_sort_merge_joins_tpu_torch.parallel.mesh import (make_mesh,
                                                              make_mesh2d)

    devices = _cards(cuda, spread)
    n = 1_000_000
    gen = torch.Generator(device=cuda).manual_seed(3)
    rk = (torch.randperm(n, generator=gen, device=cuda) + 1).to(torch.int32)
    sk = torch.randint(1, n + 1, (n,), generator=gen, device=cuda,
                       dtype=torch.int32)
    sp = torch.arange(n, dtype=torch.int32, device=cuda)
    if route == "2-D":
        one, cards = make_mesh2d(2, 4, cuda), make_mesh2d(2, 4,
                                                          devices=devices)
    else:
        one, cards = make_mesh(8, cuda), make_mesh(8, devices=devices)

    def run(mesh):
        if route == "dist_join":
            return dist_join.dist_join_count(rk, sp, sk, sp, n, n, mesh)
        if route == "m-pass":
            return dist_mpass.dist_mpass_join_count(rk, sk, n, n, mesh)
        if route == "mpsm":
            return dist_mpsm.dist_mpsm_join_count(rk, sk, n, n, mesh)
        if route == "materialize":
            k, p, cnt, ov = dist_materialize.dist_join_materialize(
                rk, None, sk, sp, n, n, mesh)
            assert k.device == mesh.device and len(k) == cnt
            return torch.sort(tsort.pack_pairs(k, p)).values, ov
        kw = {"RING": {"numa_strategy": "RING"},
              "RANDOM": {"numa_strategy": "RANDOM"},
              "overlap": {"overlap": True},
              "emulate": {"remote_pull": "emulate"},
              "dma": {"remote_pull": "dma"}}.get(route, {})
        return dist_mway.dist_mway_join_count(rk, sk, n, n, mesh, **kw)

    got, ov = run(cards)
    want, ov1 = run(one)
    torch.cuda.synchronize()
    assert ov == ov1 == 0
    if route == "materialize":
        assert torch.equal(got.to(cuda), want) and len(got) == n
    else:
        assert got == want == n


def test_cli_mapping_file_id_past_the_cards_exits_2(cuda, tmp_path, capsys):
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    count = torch.cuda.device_count()
    path = tmp_path / "mapping.txt"
    path.write_text(f"2 0 {count}\n")
    assert tcli.main(["-n", "2", "-r", "1000", "-s", "1000",
                      "--mapping-file", str(path)]) == 2
    out, err = capsys.readouterr()
    assert "Results" not in out
    assert f"device ids [{count}] past the {count} CUDA devices" in err


def test_cli_mapping_file_of_zeros_counts_exactly(cuda, tmp_path, capsys):
    from avx_sort_merge_joins_tpu_torch import cli as tcli

    path = tmp_path / "mapping.txt"
    path.write_text("8 0 0 0 0 0 0 0 0\n")
    assert tcli.main(["-n", "8", "-S", "RING", "-r", "2000000", "-s",
                      "3000000", "--mapping-file", str(path)]) == 0
    assert "Results = 3000000" in capsys.readouterr().out


def test_scalesize_last_row_counts_exactly(cuda, tmp_path):
    """``scalesize.sh``'s 60 x 32 Mi row (R = S = 2,013,265,920 keys on
    one card), run as the twin runs it, a fresh process: exactly |S|."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.empty_cache()  # this process's cached blocks: the row
    # needs most of the card
    env = dict(os.environ, SIZES="60")
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env["PATH"]
    proc = subprocess.run(
        ["bash", os.path.join(root, "avx_sort_merge_joins_tpu_torch",
                              "scripts", "scalesize.sh")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    out = (tmp_path / "scalesize.txt").read_text()
    assert proc.returncode == 0, (tmp_path / "scalesize.log").read_text()
    assert out.strip() == f"Results = {60 * 32 * 1024 * 1024}", \
        (tmp_path / "scalesize.log").read_text()[-3000:]
