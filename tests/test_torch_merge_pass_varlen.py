"""The varlen mode of the K4 merge pass of the PyTorch port against the JAX
package: ``merge_pass(keys, payloads, lens=, stride=)`` (runs at a fixed
stride, their lengths in an int32 vector, both runs of a pair ascending)
against the JAX ``merge_pass`` with a traced ``lens`` and ``b_asc=True``,
the first pass of ``dist_mpass._pairwise_merge_received``.  JAX runs Pallas
in interpret mode with 8-row (1,024-key) tiles; the port runs its CPU path
(the kernel's plain PyTorch version).  The JAX pass writes the odd output
runs descending, the port every run ascending, so each output run's live
prefix is compared as a sorted multiset and the port's must be ascending.
Every result is an integer: the tolerance is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.ops import sort as jsort
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort

LANES = 128
TILE_ROWS = 8
STRIDE_ROWS = 16  # runs of 2,048 slots: two JAX tiles a run
STRIDE = STRIDE_ROWS * LANES
DMAX = 2**31 - 2  # keys lie in [-DMAX, DMAX]
INF = 2**31 - 1


def _runs(lens, kind, seed, pairs):
    """Flat columns of len(lens) ascending runs at STRIDE, INT32_MAX past
    each run (on both columns)."""
    rng = np.random.default_rng(seed)
    keys = np.full(len(lens) * STRIDE, INF, np.int32)
    pays = np.full(len(lens) * STRIDE, INF, np.int32)
    for r, n in enumerate(lens):
        if kind == "domain_ends":
            k = rng.choice(np.array([-DMAX, -DMAX + 1, 0, DMAX - 1, DMAX]), n)
        else:
            k = rng.integers(-60, 60, n)
        p = rng.integers(-3, 3, n)
        order = np.lexsort((p, k)) if pairs else np.argsort(k, kind="stable")
        keys[r * STRIDE:r * STRIDE + n] = k[order]
        pays[r * STRIDE:r * STRIDE + n] = p[order]
    return keys, (pays if pairs else None)


@functools.lru_cache(maxsize=None)
def _jax_pass(nruns, stride_rows, b_asc, pairs):
    """One compiled JAX pass a shape: the lens are traced."""
    def run(k2, p2, lens):
        return jsort.merge_pass(k2, p2 if pairs else None, lens, stride_rows,
                                TILE_ROWS, b_asc=b_asc, interpret=True)
    return jax.jit(run)


def _jax_2d(col):
    """A flat column as JAX rows, with the spare tile rows its windows may
    read past the last run (dist_mpass's pad_rows)."""
    pad = np.full((TILE_ROWS + 8) * LANES, INF, np.int32)
    return jnp.asarray(np.concatenate([col, pad]).reshape(-1, LANES))


def _live(col, lens, stride, r):
    return col[r * stride:r * stride + int(lens[r])]


def _check_pass(tk, tp, jk, jp, new_lens, stride):
    """Port output run j == the JAX one as a multiset, ascending, with pads
    after it."""
    tk, jk = tk.numpy(), np.asarray(jk).reshape(-1)
    tp = None if tp is None else tp.numpy()
    jp = None if jp is None else np.asarray(jp).reshape(-1)
    for j, n in enumerate(new_lens):
        lo = 2 * j * stride
        got_k = tk[lo:lo + n]
        if tp is None:
            np.testing.assert_array_equal(got_k, np.sort(jk[lo:lo + n]))
        else:
            order = np.lexsort((jp[lo:lo + n], jk[lo:lo + n]))
            np.testing.assert_array_equal(got_k, jk[lo:lo + n][order])
            np.testing.assert_array_equal(tp[lo:lo + n],
                                          jp[lo:lo + n][order])
            assert (tp[lo + n:lo + 2 * stride] == INF).all()
        assert (tk[lo + n:lo + 2 * stride] == INF).all()


@pytest.mark.parametrize("lens", [[1500, 0, 2048, 700], [0, 2048, 1, 2047],
                                  [2048, 2048, 0, 0], [333, 1024, 1025, 5]],
                         ids=["one_empty", "full_and_one", "full_then_empty",
                              "tile_edges"])
@pytest.mark.parametrize("kind", ["duplicates", "domain_ends"])
@pytest.mark.parametrize("pairs", [False, True], ids=["keys", "pairs"])
def test_varlen_merge_pass_matches_jax(lens, kind, pairs):
    keys, pays = _runs(lens, kind, seed=len(kind) + sum(lens), pairs=pairs)
    jlens = jnp.asarray(np.asarray(lens, np.int32))
    jk, jp, jnew = _jax_pass(len(lens), STRIDE_ROWS, True, pairs)(
        _jax_2d(keys), None if pays is None else _jax_2d(pays), jlens)
    tp = None if pays is None else torch.from_numpy(pays)
    tk, tp, tnew = tsort.merge_pass(torch.from_numpy(keys), tp,
                                    lens=torch.tensor(lens, dtype=torch.int32),
                                    stride=STRIDE)
    assert tnew.dtype == torch.int32
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    _check_pass(tk, tp, jk, jp, tnew.tolist(), STRIDE)


@pytest.mark.parametrize("lens", [[1500, 0, 2048, 700], [0, 0, 9, 0]])
def test_varlen_two_passes_match_jax(lens):
    """Four received runs to one, as ``_pairwise_merge_received`` chains the
    passes (the second JAX pass is not ``b_asc``: it takes the first
    pass's (ascending, descending) pairs; every port run is ascending)."""
    keys, _ = _runs(lens, "duplicates", seed=3, pairs=False)
    jk, _, jl = _jax_pass(4, STRIDE_ROWS, True, False)(
        _jax_2d(keys), None, jnp.asarray(np.asarray(lens, np.int32)))
    jk, _, jl = _jax_pass(2, 2 * STRIDE_ROWS, False, False)(jk, None, jl)
    tk, _, tl = tsort.merge_pass(torch.from_numpy(keys), None,
                                 lens=torch.tensor(lens, dtype=torch.int32),
                                 stride=STRIDE)
    tk, _, tl = tsort.merge_pass(tk, None, lens=tl, stride=2 * STRIDE)
    n = sum(lens)
    assert tl.tolist() == np.asarray(jl).tolist() == [n]
    want = np.sort(keys[keys != INF])
    np.testing.assert_array_equal(tk[:n].numpy(), want)
    np.testing.assert_array_equal(np.asarray(jk).reshape(-1)[:n], want)
    assert (tk[n:] == INF).all()


@pytest.mark.parametrize("pairs", [False, True], ids=["keys", "pairs"])
@pytest.mark.parametrize("stride", [1, 4097, 100_003])
def test_varlen_merge_pass_against_numpy(stride, pairs):
    """Eight runs at larger strides (one slot, a tile plus one, an odd
    stride), random lengths with empty and full runs, against numpy."""
    rng = np.random.default_rng(stride)
    lens = rng.integers(0, stride + 1, 8)
    lens[[1, 4]] = 0
    lens[6] = stride
    keys = np.full(8 * stride, INF, np.int32)
    pays = np.full(8 * stride, INF, np.int32)
    for r, n in enumerate(lens):
        k = rng.integers(-DMAX, DMAX + 1, n)
        p = rng.integers(-2**31, 2**31 - 1, n)
        order = np.lexsort((p, k))
        keys[r * stride:r * stride + n] = k[order]
        pays[r * stride:r * stride + n] = p[order]
    tp = torch.from_numpy(pays) if pairs else None
    tk, tp, tl = tsort.merge_pass(torch.from_numpy(keys), tp,
                                  lens=torch.from_numpy(lens.astype(np.int32)),
                                  stride=stride)
    np.testing.assert_array_equal(tl.numpy(), lens[0::2] + lens[1::2])
    for j in range(4):
        lo = 2 * j * stride
        live = np.r_[lo:lo + lens[2 * j], lo + stride:lo + stride
                     + lens[2 * j + 1]]
        n = len(live)
        if pairs:
            order = np.lexsort((pays[live], keys[live]))
            np.testing.assert_array_equal(tk[lo:lo + n].numpy(),
                                          keys[live][order])
            np.testing.assert_array_equal(tp[lo:lo + n].numpy(),
                                          pays[live][order])
            assert (tp[lo + n:lo + 2 * stride] == INF).all()
        else:
            np.testing.assert_array_equal(tk[lo:lo + n].numpy(),
                                          np.sort(keys[live]))
        assert (tk[lo + n:lo + 2 * stride] == INF).all()


def test_varlen_lens_past_the_stride_are_clipped():
    keys = np.arange(40, dtype=np.int32)
    tk, _, tl = tsort.merge_pass(torch.from_numpy(keys), None,
                                 lens=torch.tensor([15, -3, 10, 10],
                                                   dtype=torch.int32),
                                 stride=10)
    assert tl.tolist() == [10, 20]
    np.testing.assert_array_equal(tk[:10].numpy(), keys[:10])
    np.testing.assert_array_equal(tk[20:40].numpy(), keys[20:40])
    assert (tk[10:20] == INF).all()


@pytest.mark.parametrize("bad", [
    "strided", "too_short", "too_long", "odd", "int64", "other_device",
    "two_dim", "no_stride", "descending", "uniform_lens", "payload_shape"])
def test_varlen_merge_pass_refuses(bad):
    """What the wrapper refuses before any launch: a strided, short, long,
    odd, int64, 2-D or foreign lens vector, a missing stride, a descending
    varlen pass, uniform lens beside lens, and mismatched payloads."""
    stride = 100_000
    keys = torch.full((4 * stride,), INF, dtype=torch.int32)
    pays = torch.full_like(keys, INF)
    lens = torch.tensor([5, 0, 7, 3], dtype=torch.int32)
    kw = {"lens": lens, "stride": stride}
    args = [keys, pays]
    if bad == "strided":
        kw["lens"] = torch.tensor([5, 9, 0, 9, 7, 9, 3, 9],
                                  dtype=torch.int32)[::2]
    elif bad == "too_short":
        kw["lens"] = lens[:2]
    elif bad == "too_long":
        kw["lens"] = torch.cat([lens, lens])
    elif bad == "odd":
        args = [keys[:3 * stride], pays[:3 * stride]]
        kw["lens"] = lens[:3]
    elif bad == "int64":
        kw["lens"] = lens.to(torch.int64)
    elif bad == "other_device":
        kw["lens"] = lens.to("meta")
    elif bad == "two_dim":
        kw["lens"] = lens.view(2, 2)
    elif bad == "no_stride":
        kw["stride"] = None
    elif bad == "descending":
        kw["descending"] = True
    elif bad == "uniform_lens":
        kw["uniform_lens"] = (4, 15, stride)
    else:
        args = [keys, pays[:stride]]
    with pytest.raises(ValueError):
        tsort.merge_pass(*args, **kw)
