"""The generator gives the source's shapes at small sizes."""

import math

import numpy as np
import pytest
import torch

from joinbench import gen, reference

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("n", [1, 2, 3, 5, 1000, 65_537, 1 << 18])
def test_bijection_is_a_permutation(n):
    y = gen.Bijection(n, BIG_SEED, gen.STREAM_R)(torch.arange(n))
    assert torch.equal(torch.sort(y).values, torch.arange(n))


def test_r_is_a_shuffled_permutation_of_1_to_n():
    rel = gen.make_relations(50_000, 50_000, {"s_keys": "tiling"}, BIG_SEED,
                             "cpu", True)
    r = rel.r_keys.long()
    assert torch.equal(torch.sort(r).values, torch.arange(1, 50_001))
    # shuffled: far from sorted, payload is the row id before the shuffle
    assert (r[1:] > r[:-1]).float().mean().item() == pytest.approx(0.5,
                                                                    abs=0.02)
    assert torch.equal(rel.r_payloads.long(), r - 1)


@pytest.mark.parametrize("n_r,n_s", [(10_000, 10_000), (10_000, 35_000),
                                     (7, 100)])
def test_s_is_a_shuffled_tiling(n_r, n_s):
    rel = gen.make_relations(n_r, n_s, {"s_keys": "tiling"}, 7, "cpu", True)
    s = rel.s_keys.long()
    want = torch.arange(n_s) % n_r + 1
    assert torch.equal(torch.sort(s).values, torch.sort(want).values)
    assert torch.equal(torch.sort(rel.s_payloads.long()).values,
                       torch.arange(n_s))
    assert torch.equal(s, rel.s_payloads.long() % n_r + 1)
    if n_s > 1000:
        assert not torch.equal(s, want)


def test_same_seed_same_relations_other_seed_other():
    a = gen.make_relations(3000, 5000, {"s_keys": "tiling"}, BIG_SEED, "cpu",
                           True)
    b = gen.make_relations(3000, 5000, {"s_keys": "tiling"}, BIG_SEED, "cpu",
                           True)
    c = gen.make_relations(3000, 5000, {"s_keys": "tiling"}, BIG_SEED + 1,
                           "cpu", True)
    assert torch.equal(a.r_keys, b.r_keys) and torch.equal(a.s_keys,
                                                           b.s_keys)
    assert not torch.equal(a.r_keys, c.r_keys)
    assert not torch.equal(a.s_keys, c.s_keys)


def test_zipf_cdf_is_the_harmonic_table():
    cdf = gen.zipf_cdf(1000, 1.0, "cpu").numpy()
    want = np.cumsum(1.0 / np.arange(1, 1001))
    assert np.allclose(cdf, want, rtol=1e-12)


@pytest.mark.parametrize("z", [1.0, 0.75])
def test_zipf_frequencies_follow_the_cdf(z):
    n_r, n_s = 2000, 400_000
    rel = gen.make_relations(n_r, n_s, {"s_keys": "zipf", "zipf_z": z},
                             BIG_SEED, "cpu", False)
    s = rel.s_keys.long()
    assert int(s.min()) >= 1 and int(s.max()) <= n_r
    # the letters by rank: the alphabet's permutation of the ranks
    alphabet = gen.Bijection(n_r, BIG_SEED, gen.STREAM_ALPHABET)(
        torch.arange(n_r)) + 1
    freq = torch.bincount(s, minlength=n_r + 1)[alphabet].double() / n_s
    p = 1.0 / np.arange(1, n_r + 1) ** z
    p /= p.sum()
    # the first ranks within 5 standard errors, the whole by chi-square
    for k in range(5):
        se = math.sqrt(p[k] * (1 - p[k]) / n_s)
        assert abs(freq[k].item() - p[k]) < 5 * se
    chi2 = float(((freq.numpy() * n_s - p * n_s) ** 2 / (p * n_s)).sum())
    assert chi2 < n_r + 6 * math.sqrt(2 * n_r)
    # the hot key is a shuffled letter, not key 1
    assert int(alphabet[0]) == int(torch.bincount(s).argmax())


def test_zipf_hot_key_share_at_workload_a():
    h = np.log(1.6e9) + 0.5772156649 + 1 / (2 * 1.6e9)
    assert 0.045 < 1 / h < 0.047  # the configuration's "about 4.6% of S"


@pytest.mark.parametrize("traffic", [{"s_keys": "tiling"},
                                     {"s_keys": "zipf", "zipf_z": 1.0}])
def test_8_byte_keys_are_the_4_byte_values_in_int64(traffic):
    narrow = gen.make_relations(5000, 9000, traffic, BIG_SEED, "cpu", True)
    wide = gen.make_relations(5000, 9000, traffic, BIG_SEED, "cpu", True, 8)
    for col in ("r_keys", "s_keys", "r_payloads", "s_payloads"):
        a, b = getattr(narrow, col), getattr(wide, col)
        assert a.dtype == torch.int32 and b.dtype == torch.int64
        assert torch.equal(a.long(), b)
    assert reference.count(wide.r_keys, wide.s_keys) == reference.count(
        narrow.r_keys, narrow.s_keys)


def test_key_bytes_from_the_configuration():
    count, rows = {"name": "c", "query": "count"}, {"name": "r",
                                                   "query": "rows"}
    assert gen.key_bytes({"name": "a"}, count) == 4
    assert gen.key_bytes({"name": "a"}, rows) == 4
    assert gen.key_bytes({"name": "a", "key_bytes": 8}, count) == 8
    with pytest.raises(ValueError, match="'a'.*rows"):
        gen.key_bytes({"name": "a", "key_bytes": 8}, rows)
    with pytest.raises(ValueError, match="'a'"):
        gen.key_bytes({"name": "a", "key_bytes": 2}, count)
