"""K2 and K6 multiway merges and the multiway sort of the PyTorch port,
keys only and with payloads, against the JAX package (Pallas in interpret
mode, 1,024-key runs, 8-row tiles) and against numpy, on the CPU path of
the wrapper (its plain PyTorch version).  Tolerance: exact equality on the
live prefix."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import multiwaymerge as jmw
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as sort_ops

ROWS = 8  # JAX block/stride/tile rows: 8 x 128 = 1,024 keys
SPAN = ROWS * 128
INF = 2**31 - 1


@pytest.mark.parametrize("n,block_rows,fanin", [
    (1, 8, 16),               # a single block: zero levels
    (1024, 8, 16),
    (1025, 8, 2),
    (100_000, 8, 4),
    (128_000_000, 128, 16),   # the main path at the reference's block
    (128_000_000, 512, 16),   # the m-way model's TPU block
    (5_000_000, 128, 2),
    (300_000, 8, 1024),
])
def test_merge_levels_match_jax(n, block_rows, fanin):
    want = [(stride * 128, span, nruns, w) for stride, span, nruns, w
            in jmw.merge_levels(n, block_rows, fanin)]
    assert tmw.merge_levels(n, block_rows * 128, fanin) == want


@pytest.mark.parametrize("n,fanins", [
    (128_000_000, [32, 16, 16]),        # workload B: 7,813 runs
    (200_000_000, [16, 16, 16, 4]),     # a workload-A shard: 12,208 runs
    (2_048_000_000, [32, 16, 16, 16]),  # the card16 cell's S: 125,000
], ids=["128M", "200M", "2048M"])
def test_default_plan(n, fanins):
    block = 16384
    nruns = -(-n // block)
    levels = tmw.merge_levels(n, block)
    ws = [w for *_, w in levels]
    assert ws == fanins == tmw.plan_fanins(nruns)
    assert all(w & (w - 1) == 0 and 2 <= w <= tmw.SAMPLED_MAX_FANIN
               for w in ws)
    assert int(np.prod(ws)) >= nruns
    assert sum(w.bit_length() - 1 for w in ws) == (nruns - 1).bit_length()
    # one level fewer than greedy at 16 where that ends in a W = 2 level
    greedy = tmw.merge_levels(n, block, 16)
    assert len(levels) == len(greedy) - (greedy[-1][3] == 2)
    # a named fan-in of 16 is the JAX schedule, as before
    assert greedy == [(stride * 128, span, nr, w) for stride, span, nr, w
                      in jmw.merge_levels(n, block // 128, 16)]
    # the two-run schedule without a fan-in: greedy at 16, one round
    # fewer, 2 runs
    levels2, span2, left = tmw.merge_levels_2runs(n, block)
    assert (levels2, span2, left) == tmw.merge_levels_2runs(n, block, 16)
    assert left == 2 and span2 * 2 >= n
    assert sum(w.bit_length() - 1 for *_, w in levels2) == \
        (nruns - 1).bit_length() - 1


def _sorted_runs(n, seed, low=-(2**31 - 2), high=2**31 - 2):
    keys = np.random.default_rng(seed).integers(low, high + 1, n).astype(
        np.int32)
    runs, _ = jmw.sort_blocks_phase(jnp.asarray(keys), None, n, ROWS, ROWS)
    return keys, np.asarray(runs)


@pytest.mark.parametrize("n,fanin,low,high", [
    (3000, 2, -(2**31 - 2), 2**31 - 2),  # 3 runs: group 1 has one empty run
    (4000, 4, -50, 50),                  # heavy duplicates, ragged last run
    (2500, 16, -(2**31 - 2), -1),        # 3 runs and 13 empty ones
])
def test_multiway_merge_uniform_matches_jax(n, fanin, low, high):
    keys, runs2d = _sorted_runs(n, seed=fanin, low=low, high=high)
    nruns = -(-n // SPAN)
    # room for every run slot of the last group (empty ones included)
    rows = -(-nruns // fanin) * fanin * ROWS + 2 * ROWS
    padded = np.full((max(rows, runs2d.shape[0]), 128), INF, np.int32)
    padded[:runs2d.shape[0]] = runs2d
    want, _, want_lens = jmw.multiway_merge(
        jnp.asarray(padded), None, None, ROWS, fanin, ROWS,
        uniform_lens=(nruns, n, SPAN))
    flat = torch.from_numpy(runs2d.reshape(-1)[:nruns * SPAN].copy())
    got, lens = tmw.multiway_merge(flat, fanin, (nruns, n, SPAN))
    assert lens == want_lens
    assert got.shape == flat.shape
    np.testing.assert_array_equal(got[:n].numpy(),
                                  np.asarray(want).reshape(-1)[:n])
    assert bool((got[n:] == INF).all())


@pytest.mark.parametrize("n,fanin", [(3000, 4)])
def test_multiway_sort_matches_jax(n, fanin):
    keys = np.random.default_rng(n).integers(-9999, 9999, n).astype(np.int32)
    want, _ = jmw.multiway_sort(jnp.asarray(keys), None, n, ROWS, ROWS,
                                fanin)
    got = tmw.multiway_sort(torch.from_numpy(keys), n, SPAN, fanin)
    np.testing.assert_array_equal(got[:n].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:n].numpy(), np.sort(keys))


@pytest.mark.parametrize("n,block,fanin", [
    (300_001, 1024, 16), (300_001, 16384, 2), (70_000, 2048, 8)])
def test_multiway_sort_against_numpy(n, block, fanin):
    keys = np.random.default_rng(fanin).integers(
        -(2**31 - 2), 2**31 - 1, n).astype(np.int32)
    got = tmw.multiway_sort(torch.from_numpy(keys), n, block, fanin)
    np.testing.assert_array_equal(got[:n].numpy(), np.sort(keys))
    assert bool((got[n:] == INF).all())


@pytest.mark.parametrize("fanin,lens", [
    (3, (2, 2000, 1024)),     # fanin not a power of two
    (2, (3, 2000, 1024)),     # run count that does not fit the total
    (2, (2, 9000, 8192)),     # total beyond the column
])
def test_multiway_merge_rejects_bad_layouts(fanin, lens):
    keys = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmw.multiway_merge(keys, fanin, lens)


# --------------------------------------------------------------------------
# pair mode: K6 and the payload-carrying multiway sort
# --------------------------------------------------------------------------

INT_MIN = -(2**31)


def _pairs(n, seed, kmax, pmax):
    """Seeded pairs with duplicate keys and payloads (so that identical
    pairs sit in several runs) and payloads equal to both pad values."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-kmax, kmax + 1, n).astype(np.int32)
    p = rng.integers(-pmax, pmax + 1, n).astype(np.int32)
    p[::7] = INF
    p[::5] = INT_MIN
    return k, p


def _lex_sorted(k, p):
    order = np.lexsort((p, k))
    return k[order], p[order]


@pytest.mark.parametrize("n,fanin,kmax,pmax", [
    (3000, 2, 2**31 - 2, 2**31 - 2),  # both ends of the key domain, 3 runs
    (4000, 4, 3, 1),     # the same pair in every run, ragged last run
    (2500, 16, 40, 2),   # 3 runs and 13 empty ones
    (5000, 4, 0, 0),     # one key: the order is the payloads' alone
])
def test_multiway_merge_pairs_matches_jax(n, fanin, kmax, pmax):
    k, p = _pairs(n, fanin + n, kmax, pmax)
    rk2, rp2 = jmw.sort_blocks_phase(jnp.asarray(k), jnp.asarray(p), n, ROWS,
                                     ROWS)
    rk2, rp2 = np.asarray(rk2), np.asarray(rp2)
    nruns = -(-n // SPAN)
    rows = max(-(-nruns // fanin) * fanin * ROWS + 2 * ROWS, rk2.shape[0])
    pad_k = np.full((rows, 128), INF, np.int32)
    pad_p = np.full((rows, 128), INF, np.int32)
    pad_k[:rk2.shape[0]], pad_p[:rp2.shape[0]] = rk2, rp2
    want_k, want_p, want_lens = jmw.multiway_merge(
        jnp.asarray(pad_k), jnp.asarray(pad_p), None, ROWS, fanin, ROWS,
        uniform_lens=(nruns, n, SPAN))
    flat_k = torch.from_numpy(rk2.reshape(-1)[:nruns * SPAN].copy())
    flat_p = torch.from_numpy(rp2.reshape(-1)[:nruns * SPAN].copy())
    (got_k, got_p), lens = tmw.multiway_merge(flat_k, fanin,
                                              (nruns, n, SPAN), flat_p)
    assert lens == want_lens
    assert got_k.shape == got_p.shape == flat_k.shape
    np.testing.assert_array_equal(got_k[:n].numpy(),
                                  np.asarray(want_k).reshape(-1)[:n])
    np.testing.assert_array_equal(got_p[:n].numpy(),
                                  np.asarray(want_p).reshape(-1)[:n])
    # slots from n on hold the pad pair (INT32_MAX, INT32_MAX)
    assert bool((got_k[n:] == INF).all()) and bool((got_p[n:] == INF).all())
    # every group is the lexicographic sort of its runs
    for g in range(-(-nruns // fanin)):
        lo, hi = g * fanin * SPAN, min(n, (g + 1) * fanin * SPAN)
        ek, ep = _lex_sorted(k[lo:hi], p[lo:hi])
        np.testing.assert_array_equal(got_k[lo:hi].numpy(), ek)
        np.testing.assert_array_equal(got_p[lo:hi].numpy(), ep)


@pytest.mark.parametrize("n,fanin", [
    (1, 16),        # a single pair
    (1024, 16),     # exactly one block: zero levels
    (1025, 2),      # one block + 1
    (3000, 4),      # a few blocks, one level
    (5000, 2),      # five blocks, three levels with odd run counts
])
def test_multiway_sort_pairs_matches_jax(n, fanin):
    k, p = _pairs(n, n, 20, 2)
    want_k, want_p = jmw.multiway_sort(jnp.asarray(k), jnp.asarray(p), n,
                                       ROWS, ROWS, fanin)
    got_k, got_p = tmw.multiway_sort(torch.from_numpy(k), n, SPAN, fanin,
                                     payloads=torch.from_numpy(p))
    ek, ep = _lex_sorted(k, p)
    np.testing.assert_array_equal(np.asarray(want_k), ek)
    np.testing.assert_array_equal(np.asarray(want_p), ep)
    np.testing.assert_array_equal(got_k[:n].numpy(), ek)
    np.testing.assert_array_equal(got_p[:n].numpy(), ep)
    assert bool((got_k[n:] == INF).all()) and bool((got_p[n:] == INF).all())


@pytest.mark.parametrize("n,block,fanin", [
    (300_001, 1024, 16), (300_001, 16384, 2), (70_000, 2048, 8)])
def test_multiway_sort_pairs_against_numpy(n, block, fanin):
    k, p = _pairs(n, fanin, 2**31 - 2, 2**31 - 2)
    k[::11] = 5  # one hot key across every block
    got_k, got_p = tmw.multiway_sort(torch.from_numpy(k), n, block, fanin,
                                     payloads=torch.from_numpy(p))
    ek, ep = _lex_sorted(k, p)
    np.testing.assert_array_equal(got_k[:n].numpy(), ek)
    np.testing.assert_array_equal(got_p[:n].numpy(), ep)


@pytest.mark.parametrize("pairs", [False, True], ids=["keys", "pairs"])
def test_multiway_sort_default_plan_with_a_w32_level(pairs):
    """500 runs of 1,024: the default plan merges them at 32 and 16 (greedy
    at 16 would take 16, 16, 2), counting each level under K2_LEVELS."""
    from torch.profiler import ProfilerActivity, profile

    from avx_sort_merge_joins_tpu_torch.utils import profiling

    n, block = 500 * 1024 - 77, 1024
    assert [w for *_, w in tmw.merge_levels(n, block)] == [32, 16]
    k, p = _pairs(n, 32, 2**31 - 2, 2**31 - 2)
    k[::7] = -3  # one hot key across every block
    kt = torch.from_numpy(k)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tmw.multiway_sort(kt, n, block, payloads=torch.from_numpy(p)
                                if pairs else None)
    assert profiling.span_totals()[tmw.K2_LEVELS].calls == 2
    profiling.reset()
    if pairs:
        want = torch.sort(sort_ops.pack_pairs(kt, torch.from_numpy(p)))
        want_k, want_p = sort_ops.unpack_pairs(want.values)
        assert torch.equal(got[0][:n], want_k)
        assert torch.equal(got[1][:n], want_p)
    else:
        assert torch.equal(got[:n], torch.sort(kt).values)


def test_multiway_merge_rejects_mismatched_payloads():
    keys = torch.zeros(4096, dtype=torch.int32)
    for bad in (torch.zeros(4095, dtype=torch.int32),
                torch.zeros(4096, dtype=torch.int64)):
        with pytest.raises((ValueError, TypeError)):
            tmw.multiway_merge(keys, 2, (4, 4096, 1024), bad)


# --------------------------------------------------------------------------
# varlen pair mode: K6 with a device lens vector (dist_materialize's merge)
# --------------------------------------------------------------------------

VARLEN_RUNS = 16  # every case: 16 runs of one 1,024-key stride


def _varlen_pairs(case, seed):
    """16 runs of (key, payload) pairs in lexicographic order at a stride of
    1,024 slots, pads after each run's live prefix, and their lens: ragged,
    empty and full runs."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, SPAN + 1, VARLEN_RUNS)
    lens[[0, 5]] = 0
    lens[[1, 6]] = SPAN
    if case == "same_pairs":    # the same few pairs in every run
        k = rng.integers(-1, 2, (VARLEN_RUNS, SPAN))
        p = rng.integers(0, 2, (VARLEN_RUNS, SPAN))
    elif case == "pad_payloads":  # payloads equal to both pad values
        k = rng.integers(-40, 41, (VARLEN_RUNS, SPAN))
        p = rng.choice(np.array([INT_MIN, -1, 0, INF]), (VARLEN_RUNS, SPAN))
    else:                          # keys at both ends of the domain
        k = rng.choice(np.array([-(2**31 - 2), -(2**31 - 3), 0, 2**31 - 3,
                                 2**31 - 2]), (VARLEN_RUNS, SPAN))
        p = rng.integers(INT_MIN, INF + 1, (VARLEN_RUNS, SPAN))
    keys = np.full((VARLEN_RUNS, SPAN), INF, np.int32)
    pays = np.full((VARLEN_RUNS, SPAN), INF, np.int32)
    for r, n in enumerate(lens):
        keys[r, :n], pays[r, :n] = _lex_sorted(k[r, :n].astype(np.int32),
                                               p[r, :n].astype(np.int32))
    return keys.reshape(-1), pays.reshape(-1), lens.astype(np.int32)


def _check_varlen_pairs(got, glens, keys, pays, lens, fanin):
    """Each group of the port's result is the lexicographic sort of its
    runs' live pairs, INT32_MAX past them on both columns."""
    (gk, gp) = got
    stride = SPAN
    np.testing.assert_array_equal(
        glens.numpy(), lens.reshape(-1, fanin).sum(1).astype(np.int32))
    for g in range(len(lens) // fanin):
        base = g * fanin * stride
        runs = range(g * fanin, (g + 1) * fanin)
        ek, ep = _lex_sorted(
            np.concatenate([keys[r * stride:r * stride + lens[r]]
                            for r in runs]),
            np.concatenate([pays[r * stride:r * stride + lens[r]]
                            for r in runs]))
        live = len(ek)
        np.testing.assert_array_equal(gk[base:base + live].numpy(), ek)
        np.testing.assert_array_equal(gp[base:base + live].numpy(), ep)
        end = base + fanin * stride
        assert bool((gk[base + live:end] == INF).all())
        assert bool((gp[base + live:end] == INF).all())


@pytest.mark.parametrize("fanin", [2, 4, 8])
def test_varlen_pair_merge_matches_jax(fanin):
    """The port's varlen K6 (plain version) against the JAX multiway_merge
    with a jnp lens vector, as _merge_received_pair calls it; the cases of
    one fan-in share the JAX shapes (one compile)."""
    rows = VARLEN_RUNS * ROWS + 2 * ROWS
    for seed, case in enumerate(["same_pairs", "pad_payloads",
                                 "domain_ends"]):
        keys, pays, lens = _varlen_pairs(case, 100 * fanin + seed)
        k2 = np.full((rows, 128), INF, np.int32)
        p2 = np.full((rows, 128), INF, np.int32)
        k2.reshape(-1)[:keys.size], p2.reshape(-1)[:pays.size] = keys, pays
        want_k, want_p, want_lens = jmw.multiway_merge(
            jnp.asarray(k2), jnp.asarray(p2), jnp.asarray(lens), ROWS, fanin,
            ROWS)
        got, glens = tmw.multiway_merge(
            torch.from_numpy(keys), fanin, payloads=torch.from_numpy(pays),
            lens=torch.from_numpy(lens), stride=SPAN)
        np.testing.assert_array_equal(glens.numpy(), np.asarray(want_lens))
        assert glens.dtype == torch.int32
        want_k = np.asarray(want_k).reshape(-1)
        want_p = np.asarray(want_p).reshape(-1)
        for g, live in enumerate(np.asarray(want_lens)):
            base = g * fanin * SPAN
            np.testing.assert_array_equal(
                got[0][base:base + live].numpy(), want_k[base:base + live])
            np.testing.assert_array_equal(
                got[1][base:base + live].numpy(), want_p[base:base + live])
        _check_varlen_pairs(got, glens, keys, pays, lens, fanin)


@pytest.mark.parametrize("fanin,stride", [(2, 100_003), (16, 20_011)])
def test_varlen_pair_merge_against_numpy(fanin, stride):
    """The varlen K6 plain version at a larger size and odd strides, with
    spare slots past the last group."""
    rng = np.random.default_rng(fanin)
    nruns = 2 * fanin
    lens = rng.integers(0, stride + 1, nruns).astype(np.int32)
    lens[0], lens[-1] = 0, stride
    keys = np.full(nruns * stride + 77, INF, np.int32)
    pays = np.full_like(keys, INF)
    for r, n in enumerate(lens):
        k = rng.integers(-(2**31 - 2), 2**31 - 1, n).astype(np.int32)
        k[::3] = 9  # one hot key across every run
        p = rng.integers(INT_MIN, INF, n, endpoint=True).astype(np.int32)
        keys[r * stride:r * stride + n], pays[r * stride:r * stride + n] = \
            _lex_sorted(k, p)
    got, glens = tmw.multiway_merge(
        torch.from_numpy(keys), fanin, payloads=torch.from_numpy(pays),
        lens=torch.from_numpy(lens), stride=stride)
    assert got[0].shape == got[1].shape == (keys.size,)
    np.testing.assert_array_equal(glens.numpy(),
                                  lens.reshape(-1, fanin).sum(1))
    for g in range(2):
        base = g * fanin * stride
        runs = range(g * fanin, (g + 1) * fanin)
        ek, ep = _lex_sorted(
            np.concatenate([keys[r * stride:r * stride + lens[r]]
                            for r in runs]),
            np.concatenate([pays[r * stride:r * stride + lens[r]]
                            for r in runs]))
        np.testing.assert_array_equal(got[0][base:base + ek.size].numpy(), ek)
        np.testing.assert_array_equal(got[1][base:base + ep.size].numpy(), ep)
    assert bool((got[0][2 * fanin * stride:] == INF).all())
    assert bool((got[1][2 * fanin * stride:] == INF).all())


def test_varlen_merge_refusals():
    """A strided lens vector, payloads that do not match the keys, and
    uniform_lens beside lens are refused."""
    keys = torch.zeros(4 * 1024, dtype=torch.int32)
    lens = torch.full((4,), 10, dtype=torch.int32)
    strided = torch.zeros((4, 4), dtype=torch.int32)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        tmw.multiway_merge(keys, 2, payloads=keys.clone(), lens=strided,
                           stride=1024)
    for bad in (torch.zeros(4095, dtype=torch.int32),
                torch.zeros(4096, dtype=torch.int64)):
        with pytest.raises((ValueError, TypeError)):
            tmw.multiway_merge(keys, 2, payloads=bad, lens=lens, stride=1024)
    with pytest.raises(ValueError, match="uniform_lens"):
        tmw.multiway_merge(keys, 2, (4, 4096, 1024), lens=lens, stride=1024)
