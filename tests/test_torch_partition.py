"""Radix partitioning of the PyTorch port against the JAX package: the
partition ids, the histogram K8 (its plain version on the CPU; JAX's
Pallas kernel in interpret mode), the global and one-hot histograms, the
padded partition layout and the lane gather.  Integers: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import mxu_permute as jmx
from avx_sort_merge_joins_tpu.ops import partition as jpt
from avx_sort_merge_joins_tpu_torch.ops import mxu_permute as tmx
from avx_sort_merge_joins_tpu_torch.ops import partition as tpt

DOMAIN_MAX = 2**31 - 2


def _keys(n, seed, low=-DOMAIN_MAX, high=DOMAIN_MAX):
    """Seeded keys with both ends of the key domain among them."""
    keys = np.random.default_rng(seed).integers(low, high + 1, n).astype(
        np.int32)
    keys[:4] = [low, low + 1, high - 1, high]
    return keys


def _oracle_tiles(keys, nbits, shift):
    """numpy per-tile counts of the ids, the last tile ragged."""
    pid = ((keys.astype(np.int64) - 1) & (((1 << nbits) - 1) << shift)) \
        >> shift
    tile = np.arange(len(keys)) // tpt.HIST_TILE
    ntiles = -(-len(keys) // tpt.HIST_TILE)
    return np.bincount(tile * (1 << nbits) + pid,
                       minlength=ntiles << nbits).reshape(ntiles, -1)


@pytest.mark.parametrize("nbits,shift", [(7, 0), (4, 3), (2, 0)])
def test_ids_and_radix_hist_match_jax(nbits, shift):
    """One 16,384-key tile: JAX's tile shrinks to its 128 rows, so both
    give one (1, fanout) row."""
    keys = _keys(128 * 128, nbits * 10 + shift)
    t = torch.from_numpy(keys)
    np.testing.assert_array_equal(
        tpt.partition_ids(t, nbits, shift).numpy(),
        np.asarray(jpt.partition_ids(jnp.asarray(keys), nbits, shift)))
    got = tpt.radix_hist(t, nbits, shift)
    want = np.asarray(jpt.radix_hist(jnp.asarray(keys.reshape(-1, 128)),
                                     nbits, shift))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits,shift", [(16, 15), (1, 30), (8, 23),
                                         (16, 0), (3, 28)])
def test_radix_hist_per_tile_and_global_vs_numpy(nbits, shift):
    """Top bits (nbits + shift = 31 in three cases), three whole tiles and
    a ragged fourth, keys at both ends of the domain."""
    keys = _keys(3 * tpt.HIST_TILE + 4321, nbits + shift)
    t = torch.from_numpy(keys)
    want = _oracle_tiles(keys, nbits, shift)
    got = tpt.radix_hist(t, nbits, shift)
    assert got.shape == (4, 1 << nbits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpt.radix_hist_any(t, nbits, shift).numpy(),
                                  want.sum(0))
    np.testing.assert_array_equal(
        tpt.radix_hist_torch(t, nbits, shift).numpy(), want.sum(0))


def test_radix_hist_of_one_bin_tile():
    """65,536 equal keys fill one bin of one tile: a 16-bit counter would
    overflow there."""
    t = torch.full((tpt.HIST_TILE,), 12345, dtype=torch.int32)
    for nbits in (1, 7, 16):
        got = tpt.radix_hist(t, nbits)
        assert int(got.max()) == tpt.HIST_TILE
        assert int(got[0, (12345 - 1) % (1 << nbits)]) == tpt.HIST_TILE


@pytest.mark.parametrize("nbits,shift", [(7, 25), (16, 16), (1, 31),
                                         (0, 0), (17, 0), (4, -1)])
def test_radix_domain_refused(nbits, shift):
    """Past bit 31 the JAX mask overflows int32 (OverflowError at
    (7, 25)); the port refuses with ValueError and computes nothing."""
    keys = torch.arange(1, 100, dtype=torch.int32)
    for fn in (tpt.partition_ids, tpt.radix_hist, tpt.radix_hist_any,
               tpt.radix_hist_torch, tpt.radix_hist_mxu):
        with pytest.raises(ValueError):
            fn(keys, nbits, shift)
    if (nbits, shift) == (7, 25):
        with pytest.raises(OverflowError):
            jpt.partition_ids(jnp.asarray(keys.numpy()), nbits, shift)


def test_hash_bit_modulo_bias_and_mask():
    keys = torch.tensor([1, 2, 128, 129, -(2**31) + 2], dtype=torch.int32)
    np.testing.assert_array_equal(tpt.partition_ids(keys, 7).numpy(),
                                  np.asarray(jpt.partition_ids(
                                      jnp.asarray(keys.numpy()), 7)))
    with pytest.raises(ValueError):
        tpt.hash_bit_modulo(keys, 2**31, 0)


@pytest.mark.parametrize("bits", [8, 12])
def test_global_histograms_match_jax(bits):
    keys = _keys(2 * tpt.HIST_TILE, bits, 1, 2**26)
    t = torch.from_numpy(keys)
    want = np.asarray(jpt.radix_hist_any(jnp.asarray(keys.reshape(-1, 128)),
                                         bits))
    np.testing.assert_array_equal(tpt.radix_hist_any(t, bits).numpy(), want)
    np.testing.assert_array_equal(
        tpt.radix_hist_mxu(t, bits).numpy(),
        np.asarray(jpt.radix_hist_mxu(jnp.asarray(keys), bits)))
    np.testing.assert_array_equal(
        tpt.radix_hist_torch(t, bits).numpy(),
        np.asarray(jpt.radix_hist_xla(jnp.asarray(keys), bits)))


@pytest.mark.parametrize("nbits", [2, 7])
def test_partition_relation_matches_jax_and_oracle(nbits):
    n = 128 * 128 + 77
    keys = _keys(n, nbits, 1, 2**20)
    pays = np.random.default_rng(nbits).integers(-5, 5, n).astype(np.int32)
    jk, jp, joff, jsz = map(np.asarray, jpt.partition_relation(
        jnp.asarray(keys), jnp.asarray(pays), nbits))
    pk, pp, off, sz = tpt.partition_relation(torch.from_numpy(keys),
                                             torch.from_numpy(pays), nbits)
    ok, op, osz = tpt.radix_cluster_numpy(keys, pays, nbits)
    np.testing.assert_array_equal(sz.numpy(), jsz)
    np.testing.assert_array_equal(sz.numpy(), osz)
    np.testing.assert_array_equal(off.numpy(), joff)
    assert pk.shape == jk.shape and np.all(off.numpy() % 128 == 0)
    for p in range(1 << nbits):
        live = slice(int(off[p]), int(off[p] + sz[p]))
        np.testing.assert_array_equal(pk[live].numpy(), jk[live])
        np.testing.assert_array_equal(pp[live].numpy(), jp[live])
    lk, lp = tpt.partition_live(pk, pp, off, sz)
    np.testing.assert_array_equal(lk.numpy(), ok)
    np.testing.assert_array_equal(lp.numpy(), op)
    # the oracle is the JAX one
    for a, b in zip((ok, op, osz), jpt.radix_cluster_numpy(keys, pays,
                                                           nbits)):
        np.testing.assert_array_equal(a, b)


def test_partition_relation_input_limit():
    keys = torch.zeros(tpt.MAX_PARTITION_N + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="partitioning bench"):
        tpt.partition_relation(keys, keys, 2)


@pytest.mark.parametrize("fanout", [4, 256, 1 << 14])
def test_onehot_hist_matches_jax(fanout):
    pid = np.random.default_rng(fanout).integers(0, fanout, 50_000).astype(
        np.int32)
    pid[::7] = fanout  # the JAX function's pad value: never counted
    np.testing.assert_array_equal(
        tmx.onehot_hist(torch.from_numpy(pid), fanout).numpy(),
        np.asarray(jmx.onehot_hist(jnp.asarray(pid), fanout)))


def test_permute_lanes_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(-2**31, 2**31 - 1, (16, 128), dtype=np.int64).astype(
        np.int32)
    idx = rng.integers(0, 128, (16, 128)).astype(np.int32)
    np.testing.assert_array_equal(
        tmx.permute_lanes(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jmx.permute_lanes(jnp.asarray(x), jnp.asarray(idx))))
