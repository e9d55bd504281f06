"""CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.datagen import generator as tgen
from avx_sort_merge_joins_tpu_torch.models import mpass, mpsm, mway
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort
from avx_sort_merge_joins_tpu_torch.types import Relation

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
    before = tsort.LAUNCHES
    got = tsort.sort_blocks(keys, n, block)
    torch.cuda.synchronize()
    assert tsort.LAUNCHES == before + 1
    assert torch.equal(got, tsort.sort_blocks_plain(keys, n, block))


@pytest.mark.parametrize("n,span,fanin", [
    (1, 1024, 2), (5000, 1024, 4), (70_001, 1024, 16), (70_001, 2048, 2),
    (300_000, 16384, 16)])
def test_multiway_merge_kernel_equals_plain(cuda, n, span, fanin):
    runs = tsort.sort_blocks_plain(_keys(n, fanin, -1000, 1000).to(cuda), n,
                                   span)
    lens = (max(1, -(-n // span)), n, span)
    got, new_lens = tmw.multiway_merge(runs, fanin, lens)
    torch.cuda.synchronize()
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
    before = tsort.PAIR_SORT_LAUNCHES
    got = tsort.sort_blocks_pairs(k, p, n, block, descending)
    torch.cuda.synchronize()
    assert tsort.PAIR_SORT_LAUNCHES == before + 1
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
    before = tsort.MERGE_PASS_LAUNCHES
    got = tsort.merge_pass(rk, pay, (nruns, n, span), desc)
    torch.cuda.synchronize()
    assert tsort.MERGE_PASS_LAUNCHES == before + 1
    want = tsort.merge_pass_plain(rk, pay, (nruns, n, span), desc)
    assert torch.equal(got[0], want[0])
    if pay is not None:
        assert torch.equal(got[1], want[1])


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
        before = tsort.MERGE_PASS_LAUNCHES
        res = mpass.sortmergejoin_multipass(R, S, block=1024)
        assert tsort.MERGE_PASS_LAUNCHES - before == 9 + 8
    else:
        before = tmj.LAUNCHES
        res = mpsm.sortmergejoin_mpsm(R, S, nchunks=3)
        assert tmj.LAUNCHES - before == 3
    assert res.totalresults == tmj.merge_join_count_numpy(rk, sk)
