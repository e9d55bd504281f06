"""K1 block sort of the PyTorch port against the JAX package (Pallas in
interpret mode, 8-row = 1,024-key blocks) and against numpy, and K5 (the
pair block sort) against np.lexsort, on the CPU path of the wrappers
(their plain PyTorch versions)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import multiwaymerge as jmw
from avx_sort_merge_joins_tpu.ops import sort as jsort
from avx_sort_merge_joins_tpu_torch.kernels import _build
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

BLOCK_ROWS = 8  # JAX block: 8 x 128 = 1,024 keys
BLOCK = BLOCK_ROWS * 128
INF = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _jax_blocks_fn(n):
    return jax.jit(lambda k: jmw.sort_blocks_phase(k, None, n, BLOCK_ROWS,
                                                   BLOCK_ROWS)[0])


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        return rng.integers(0, 7, n).astype(np.int32)
    if kind == "negative":
        return rng.integers(-(2**30), 0, n).astype(np.int32)
    if kind == "domain_ends":
        return rng.choice(np.array([-(2**31 - 2), 0, 2**31 - 2], np.int32), n)
    return rng.integers(-(2**31 - 2), 2**31 - 1, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "negative",
                                  "domain_ends"])
def test_sort_blocks_phase_matches_jax(kind):
    n = 2500  # ragged last block; one shape, so JAX compiles once
    keys = _keys(kind, n, seed=len(kind))
    want = _jax_blocks_fn(n)(jnp.asarray(keys))
    got = tmw.sort_blocks_phase(torch.from_numpy(keys), n, BLOCK)
    nblocks = -(-n // BLOCK)
    assert got.shape == (nblocks * BLOCK,)
    # whole blocks compare: the same keys per block and the same +inf pads
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(want).reshape(-1)[:nblocks * BLOCK])


def test_sort_blocks_matches_jax_ascending_kernel():
    n = 2 * BLOCK
    keys = _keys("uniform", n, seed=5)
    want, _ = jsort.sort_blocks(jnp.asarray(keys.reshape(-1, 128)), None,
                                BLOCK_ROWS, alternating=False)
    got = tsort.sort_blocks(torch.from_numpy(keys), n, BLOCK)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1))


def _edge_keys(kind, n, seed):
    """Inputs at the edges of K1's bitonic network."""
    rng = np.random.default_rng(seed)
    if kind == "sorted":
        return np.sort(_keys("uniform", n, seed))
    if kind == "reversed":
        return np.sort(_keys("uniform", n, seed))[::-1].copy()
    if kind == "equal":
        return np.full(n, -3, np.int32)
    if kind == "16_values":
        return rng.integers(0, 16, n).astype(np.int32)
    if kind == "domain_ends":
        return rng.choice(np.array([-(2**31 - 2), 2**31 - 2], np.int32), n)
    return _keys("uniform", n, seed)


@pytest.mark.parametrize("rel", ["ragged", -1, 0, 1, "zero"])
@pytest.mark.parametrize("kind", ["uniform", "sorted", "reversed", "equal",
                                  "16_values", "domain_ends"])
@pytest.mark.parametrize("block", tsort.SUPPORTED_BLOCKS)
def test_sort_blocks_against_numpy(block, kind, rel):
    """Every block size on uniform keys and at the network's edges
    (sorted, reversed, all equal, 16 values, the domain's ends), at n =
    3 block + 77, block - 1, block, block + 1 and 0."""
    n = {"ragged": 3 * block + 77, "zero": 0}.get(rel)
    n = block + rel if n is None else n
    keys = _edge_keys(kind, max(n, 1), seed=block)
    got = tsort.sort_blocks(torch.from_numpy(keys), n, block).numpy()
    nblocks = max(1, -(-n // block))
    padded = np.concatenate([keys[:n],
                             np.full(nblocks * block - n, INF, np.int32)])
    np.testing.assert_array_equal(
        got, np.sort(padded.reshape(-1, block), axis=1).reshape(-1))


def _edge_pairs(kind, n, seed):
    """(key, payload) inputs at the edges of K5's bitonic network."""
    rng = np.random.default_rng(seed)
    pays = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    if kind == "equal_keys":  # distinct payloads
        return np.full(n, 5, np.int32), (rng.permutation(n) - n // 2).astype(
            np.int32)
    if kind == "equal_pairs":
        return np.full(n, 5, np.int32), np.full(n, -9, np.int32)
    if kind == "domain_ends":
        ends = np.array([-(2**31), -(2**31 - 2), 2**31 - 2, 2**31 - 1],
                        np.int32)
        return rng.choice(ends[1:3], n), rng.choice(ends, n)
    return _edge_keys(kind, n, seed), pays


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("rel", ["ragged", -1, 0, 1, "zero"])
@pytest.mark.parametrize("kind", ["uniform", "sorted", "reversed",
                                  "equal_keys", "equal_pairs",
                                  "domain_ends"])
@pytest.mark.parametrize("block", tsort.SUPPORTED_BLOCKS)
def test_sort_blocks_pairs_against_numpy(block, kind, rel, descending):
    """K5 at every block size in both directions, on uniform pairs and at
    its network's edges (sorted, reversed, equal keys with distinct
    payloads, equal pairs, keys and payloads at their domains' ends), at n
    = 3 block + 77, block - 1, block, block + 1 and 0: each block holds its
    pairs in np.lexsort order (reversed when descending), the pads
    (INT32_MAX, INT32_MAX), or (INT32_MIN, INT32_MIN) descending, at the
    end."""
    n = {"ragged": 3 * block + 77, "zero": 0}.get(rel)
    n = block + rel if n is None else n
    keys, pays = _edge_pairs(kind, max(n, 1), seed=block + len(kind))
    got_k, got_p = tsort.sort_blocks_pairs(torch.from_numpy(keys),
                                           torch.from_numpy(pays), n, block,
                                           descending)
    fill = -(2**31) if descending else INF
    nblocks = max(1, -(-n // block))
    pad = np.full(nblocks * block - n, fill, np.int32)
    k = np.concatenate([keys[:n], pad]).reshape(-1, block)
    p = np.concatenate([pays[:n], pad]).reshape(-1, block)
    order = np.stack([np.lexsort((pr, kr)) for kr, pr in zip(k, p)])
    if descending:
        order = order[:, ::-1]
    np.testing.assert_array_equal(
        got_k.numpy(), np.take_along_axis(k, order, 1).reshape(-1))
    np.testing.assert_array_equal(
        got_p.numpy(), np.take_along_axis(p, order, 1).reshape(-1))


def test_sort_blocks_reads_only_the_live_prefix():
    keys = torch.tensor([3, 1, 2, -5, -6], dtype=torch.int32)
    got = tsort.sort_blocks(keys, 3, 1024)
    assert got[:3].tolist() == [1, 2, 3]
    assert bool((got[3:] == INF).all())
    assert tsort.sort_blocks(keys, 0, 1024).tolist() == [INF] * 1024


@pytest.mark.parametrize("bad", ["dtype", "strided", "block", "n"])
def test_sort_blocks_rejects_what_the_kernel_does_not_take(bad):
    keys = torch.arange(4096, dtype=torch.int32)
    args = (keys, 4096, 1024)
    if bad == "dtype":
        args = (keys.to(torch.int64), 4096, 1024)
    elif bad == "strided":
        args = (keys[::2], 2048, 1024)
    elif bad == "block":
        args = (keys, 4096, 1000)
    elif bad == "n":
        args = (keys, 4097, 1024)
    with pytest.raises((TypeError, ValueError)):
        tsort.sort_blocks(*args)


def test_cpu_wrapper_takes_the_plain_version():
    before = _build.launches()
    keys = torch.from_numpy(_keys("uniform", 5000, seed=1))
    assert torch.equal(tsort.sort_blocks(keys, 5000, 1024),
                       tsort.sort_blocks_plain(keys, 5000, 1024))
    assert _build.launches() == before  # no kernel launch on the CPU
    assert tsort.cdiv(5000, 1024) == jsort.cdiv(5000, 1024) == 5
