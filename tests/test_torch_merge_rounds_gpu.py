"""K2's and K6's tile merge rounds (merge_path.cuh's merge_rounds_select:
every output taken by selects, and no check an output in a warp whose
threads stay inside one pair) on the card, against the plain merges bit
for bit: every fan-in from 2 to 1,024, the three keys-only tiles, uniform
and varlen runs with empty and full ones, tiles fed by one run, segments
of 0 and 1 keys (pairs that end inside a thread's outputs, so a warp takes
the checked path), equal keys, a hot key over many tiles and the domain's
ends; K9 through its wrapper at 32 and 64 strips; K6's pairs with payload
ties at INT32_MAX and INT32_MIN.  Every test here is marked ``gpu`` and
skips without a CUDA device; the file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_merge_rounds_gpu.py -q
"""

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.gpu

IMAX, IMIN = 2**31 - 1, -(2**31)
FANINS = [2, 4, 8, 16, 32, 64, 1024]
KINDS = ["uniform", "equal", "hot", "ends", "one run a tile"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _keys(kind, n, run_of, rng):
    """n int32 keys; ``run_of[i]`` is the run slot i lies in."""
    if kind == "uniform":
        k = rng.integers(IMIN, IMAX, n)
    elif kind == "equal":
        k = np.full(n, 7)
    elif kind == "hot":  # one key in 3 of 4 slots: a run of it spans tiles
        k = np.where(rng.random(n) < 0.75, 5, rng.integers(-100, 100, n))
    elif kind == "ends":
        k = np.where(rng.random(n) < 0.5, IMIN, IMAX - 1)
    else:  # disjoint ranges, each run above the one before it
        k = run_of * 10_000 + rng.integers(0, 10_000, n)
    return k.astype(np.int32)


def _assert_merged(got, want):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("tile", tmw.MERGE_TILES)
@pytest.mark.parametrize("fanin", FANINS)
@pytest.mark.parametrize("kind", KINDS)
def test_uniform_runs_equal_the_plain_merge(cuda, kind, fanin, tile):
    """Runs of one span, the last group short and its last run ragged:
    fan-in 16 at 2,500 keys a run puts about 1.6 runs in a tile of 4,096
    and a hot key over many tiles; at 1,024 a run of 6 keys leaves most
    of a tile's segments at 0 or 1 key."""
    span = {2: 9_000, 4: 5_000, 8: 3_000, 16: 2_500, 32: 700, 64: 300,
            1024: 6}[fanin]
    n = span * fanin * 2 + span // 3 + 1
    rng = np.random.default_rng(fanin * 7 + tile)
    keys = torch.from_numpy(_keys(kind, n, np.arange(n) // span, rng))
    runs = tsort.sort_blocks_plain(keys.to(cuda), n, span)
    nruns = -(-n // span)
    got, _ = tmw.multiway_merge(runs, fanin, (nruns, n, span), tile=tile)
    _assert_merged(got, tmw.multiway_merge_plain(runs, fanin,
                                                 (nruns, n, span)))


@pytest.mark.parametrize("tile", tmw.MERGE_TILES)
@pytest.mark.parametrize("fanin", FANINS)
@pytest.mark.parametrize("kind", ["uniform", "hot", "one run a tile"])
def test_varlen_runs_with_empty_and_full_ones(cuda, kind, fanin, tile):
    """Two groups of runs of any length at a fixed stride: the first run
    of each group empty, the last full, one of 1 key, the rest random."""
    stride = max(8, 24_000 // fanin)
    nruns = 2 * fanin
    rng = np.random.default_rng(fanin + tile)
    lens = rng.integers(0, stride + 1, nruns)
    lens[::fanin] = 0
    lens[fanin - 1::fanin] = stride
    lens[1] = 1
    land = np.full(nruns * stride, IMAX, np.int32)
    for r, ln in enumerate(lens):
        land[r * stride:r * stride + ln] = np.sort(
            _keys(kind, ln, np.full(ln, r), rng))
    land = torch.from_numpy(land).to(cuda)
    tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got, glen = tmw.multiway_merge(land, fanin, lens=tlens, stride=stride,
                                   tile=tile)
    want, wlen = tmw.multiway_merge_varlen_plain(land, fanin, tlens, stride)
    _assert_merged(got, want)
    assert torch.equal(glen, wlen)


@pytest.mark.parametrize("fanin", [4, 16, 64])
def test_one_run_feeds_every_tile_of_a_group(cuda, fanin):
    """One run holds every key of its group (the others empty), so each
    tile's split puts all of it on one run; and a group of runs of one key
    each."""
    stride = 20_000
    for lens in ([0] * (fanin - 1) + [stride], [1] * fanin):
        land = np.full(fanin * stride, IMAX, np.int32)
        rng = np.random.default_rng(len(lens) + lens[0])
        for r, ln in enumerate(lens):
            land[r * stride:r * stride + ln] = np.sort(
                rng.integers(-50, 50, ln))
        land = torch.from_numpy(land).to(cuda)
        tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got, _ = tmw.multiway_merge(land, fanin, lens=tlens, stride=stride)
        want, _ = tmw.multiway_merge_varlen_plain(land, fanin, tlens, stride)
        _assert_merged(got, want)


@pytest.mark.parametrize("W", [32, 64])
def test_chunk_gated_merge_takes_the_select_rounds(cuda, W):
    """K9 runs K2's varlen launches: its merged column, waits and
    violation flag equal the plain version's at 32 and 64 strips, with
    ragged, empty and full strips and keys repeated across strips."""
    from avx_sort_merge_joins_tpu_torch.parallel import remote_fifo as trf

    stride, chunk = 8192, 1024
    rng = np.random.default_rng(W + 1)
    lens = rng.integers(0, stride + 1, W)
    lens[0], lens[-1], lens[1] = 0, stride, 1
    land = np.full(W * stride + 4096 + 3, IMAX, np.int32)
    for r, ln in enumerate(lens):
        land[r * stride:r * stride + ln] = np.sort(rng.integers(-30, 30, ln))
    land = torch.from_numpy(land).to(cuda)
    tlens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    arrive = trf.arrival_schedule(W, stride // chunk, 1)
    got = trf.chunk_gated_merge(land, tlens, stride, chunk, arrive)
    want = trf.chunk_gated_merge_plain(land, tlens, stride, chunk, arrive)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2]) == 0


@pytest.mark.parametrize("fanin", [2, 4, 16, 1024])
def test_pairs_with_payload_ties_at_the_domain_ends(cuda, fanin):
    """K6 on few keys whose payloads are INT32_MAX,
    INT32_MIN or small, so that equal pairs cross runs, uniform and
    varlen."""
    span = {2: 9_000, 4: 5_000, 16: 2_500, 1024: 6}[fanin]
    n = span * fanin + span // 2
    rng = np.random.default_rng(fanin)
    keys = torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32))
    pays = torch.from_numpy(rng.choice(np.array([IMAX, IMIN, 0, 1], np.int32),
                                       n))
    rk, rp = tsort.sort_blocks_pairs_plain(keys.to(cuda), pays.to(cuda), n,
                                           span)
    nruns = -(-n // span)
    got, _ = tmw.multiway_merge(rk, fanin, (nruns, n, span), rp)
    _assert_merged(got, tmw.multiway_merge_plain(rk, fanin, (nruns, n, span),
                                                 rp))
    lens = torch.full((fanin,), span, dtype=torch.int32, device=cuda)
    lens[0] = 0
    got, _ = tmw.multiway_merge(rk, fanin, payloads=rp, lens=lens,
                                stride=span)
    want, _ = tmw.multiway_merge_varlen_plain(rk, fanin, lens, span, rp)
    _assert_merged(got, want)
