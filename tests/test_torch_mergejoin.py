"""K3 match count of the PyTorch port against the JAX package's fused
count kernel (Pallas in interpret mode, S negated as on the m-way path)
and the numpy oracle; and the port's torch.sort baseline against the JAX
XLA baseline.  Counts are integers: the tolerance is exact equality."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import mergejoin as jmj
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj

TILE_ROWS = 8
DMAX = 2**31 - 2  # keys lie in [-DMAX, DMAX]


def _jax_layout(sorted_keys):
    """(rows, 128) ascending layout with the fused kernel's spare rows."""
    n = len(sorted_keys)
    rows = -(-n // 128) + TILE_ROWS + 8
    flat = np.full(rows * 128, 2**31 - 1, np.int32)
    flat[:n] = sorted_keys
    return jnp.asarray(flat.reshape(rows, 128))


@functools.lru_cache(maxsize=None)
def _jax_count_fn(nR, nS):
    # one compiled program per shape: the cases below share their sizes
    return jax.jit(functools.partial(jmj.merge_join_count_fused, nR=nR,
                                     nS=nS, tile_rows=TILE_ROWS,
                                     s_negated=True))


def _jax_count(rk, sk):
    """JAX m-way count: R ascending, S negated ascending."""
    stats = _jax_count_fn(len(rk), len(sk))(_jax_layout(np.sort(rk)),
                                            _jax_layout(np.sort(-sk)))
    return jmj.finish_count_fused(stats)


def _port_count(rk, sk):
    out = tmj.merge_join_count_fused(torch.from_numpy(np.sort(rk)),
                                     torch.from_numpy(np.sort(sk)),
                                     len(rk), len(sk))
    assert out.dtype == torch.int64 and out.dim() == 0
    return tmj.finish_count_fused(out)


NR, NS = 3000, 2100  # one shape for every case: one JAX compile


def _case(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "duplicates":
        return (rng.integers(0, 40, NR).astype(np.int32),
                rng.integers(0, 40, NS).astype(np.int32))
    if kind == "negative":
        return (rng.integers(-3000, 10, NR).astype(np.int32),
                rng.integers(-3000, 10, NS).astype(np.int32))
    if kind == "no_matches":
        return (2 * rng.integers(-5000, 5000, NR).astype(np.int32),
                2 * rng.integers(-5000, 5000, NS).astype(np.int32) + 1)
    if kind == "hot_key_in_S":
        rk = rng.permutation(NR).astype(np.int32)
        sk = np.full(NS, 1234, np.int32)
        sk[::7] = rng.integers(0, 2 * NR, len(sk[::7]))
        return rk, sk
    if kind == "R_much_denser":
        return (rng.integers(0, 60, NR).astype(np.int32),
                rng.integers(0, 6000, NS).astype(np.int32))
    ends = np.array([-DMAX, -DMAX + 1, 0, DMAX - 1, DMAX], np.int32)
    return rng.choice(ends, NR), rng.choice(ends, NS)


@pytest.mark.parametrize("kind", ["duplicates", "negative", "no_matches",
                                  "domain_ends", "hot_key_in_S",
                                  "R_much_denser"])
def test_count_matches_jax_fused_kernel(kind):
    rk, sk = _case(kind)
    want = jmj.merge_join_count_numpy(rk, sk)
    assert _jax_count(rk, sk) == want
    assert _port_count(rk, sk) == want


def test_hot_key_past_the_limb_limit():
    """cntR * cntS = 2^30 >= 2^29 on one key: JAX raises
    CountLimbOverflow (its callers recount on the host); the port's int64
    count is exact directly."""
    rk = np.full(1 << 15, 7, np.int32)
    sk = np.concatenate([np.full(1 << 15, 7, np.int32),
                         np.arange(100, 300, dtype=np.int32)])
    with pytest.raises(jmj.CountLimbOverflow):
        _jax_count(rk, sk)
    assert _port_count(rk, sk) == jmj.merge_join_count_numpy(rk, sk) == 2**30


K3_TILE = 1920  # merged elements a tile of csrc/merge_join_count.cu


def _tile_edge_case(kind):
    """(R, S) at the edges of K3's merge-path tiles."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "hot_key_in_S_over_100_tiles":
        return (np.arange(0, 4000, 2, dtype=np.int32),
                np.r_[np.full(100 * K3_TILE, 1000),
                      rng.integers(0, 4000, 500)].astype(np.int32))
    if kind == "non_unique_R_and_S":
        return (rng.integers(0, 300, 20_000).astype(np.int32),
                rng.integers(0, 300, 30_000).astype(np.int32))
    if kind == "nR_much_larger":
        return (rng.integers(0, 1 << 20, 200_000).astype(np.int32),
                rng.integers(0, 1 << 20, 50).astype(np.int32))
    if kind == "nS_much_larger":
        return (rng.integers(0, 1 << 20, 50).astype(np.int32),
                rng.integers(0, 1 << 20, 200_000).astype(np.int32))
    if kind == "R_of_length_1":
        return np.array([77], np.int32), rng.integers(0, 100, 9000).astype(
            np.int32)
    if kind == "S_of_length_1":
        return rng.integers(0, 100, 9000).astype(np.int32), np.array(
            [77], np.int32)
    if kind == "domain_ends":
        return (rng.choice(np.array([-DMAX, DMAX], np.int32), 5000),
                rng.choice(np.array([-DMAX, DMAX], np.int32), 7000))
    n = K3_TILE + int(kind.split("_")[-1])  # "tile_size_plus_<d>"
    nr = n // 3
    return (rng.integers(0, 40, nr).astype(np.int32),
            rng.integers(0, 40, n - nr).astype(np.int32))


@pytest.mark.parametrize("kind", [
    "hot_key_in_S_over_100_tiles", "non_unique_R_and_S", "nR_much_larger",
    "nS_much_larger", "R_of_length_1", "S_of_length_1", "domain_ends",
    "tile_size_plus_-1", "tile_size_plus_0", "tile_size_plus_1"])
def test_count_at_tile_edges_against_numpy(kind):
    """The inputs K3's merge-path tiles must count exactly, through the
    CPU path of its wrapper."""
    rk, sk = _tile_edge_case(kind)
    assert _port_count(rk, sk) == tmj.merge_join_count_numpy(rk, sk)


def test_count_against_numpy_at_larger_n():
    rng = np.random.default_rng(3)
    rk = rng.integers(-(2**20), 2**20, 400_000).astype(np.int32)
    sk = rng.integers(-(2**20), 2**20, 300_000).astype(np.int32)
    assert _port_count(rk, sk) == tmj.merge_join_count_numpy(rk, sk)


def test_count_reads_only_the_live_prefix():
    rk = torch.tensor([1, 2, 2, 9, 9], dtype=torch.int32)
    sk = torch.tensor([2, 9, 9, 9], dtype=torch.int32)
    assert tmj.finish_count_fused(
        tmj.merge_join_count_fused(rk, sk, 3, 1)) == 2
    assert tmj.finish_count_fused(
        tmj.merge_join_count_fused(rk, sk, 0, 4)) == 0


def test_torch_baseline_does_not_wrap_past_2_31():
    """2^16 x 2^16 equal keys = 2^32 matches: the JAX XLA baseline sums in
    int32 and wraps at 2^31 (mergejoin.py:1060-1069); the port's int64
    baseline must not."""
    hot = torch.full((1 << 16,), -4, dtype=torch.int32)
    assert int(tmj.merge_join_count_torch(hot, hot, 1 << 16, 1 << 16)) \
        == 2**32
    assert tmj.finish_count_fused(
        tmj.merge_join_count_fused(hot, hot, 1 << 16, 1 << 16)) == 2**32


@pytest.mark.parametrize("kind", ["duplicates", "domain_ends"])
def test_torch_baseline_matches_jax_xla_baseline(kind):
    rk, sk = (np.sort(k) for k in _case(kind))
    want = int(jmj.merge_join_count_xla(jnp.asarray(rk), jnp.asarray(sk),
                                        len(rk), len(sk)))
    got = tmj.merge_join_count_torch(torch.from_numpy(rk),
                                     torch.from_numpy(sk), len(rk), len(sk))
    assert int(got) == want == jmj.merge_join_count_numpy(rk, sk)


def test_count_rejects_mixed_or_wrong_inputs():
    keys = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        tmj.merge_join_count_fused(keys.to(torch.int64), keys, 10, 10)
    with pytest.raises(ValueError):
        tmj.merge_join_count_fused(keys, keys, 11, 10)
