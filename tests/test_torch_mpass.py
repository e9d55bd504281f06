"""The m-pass slice of the PyTorch port against the JAX package: the pass
schedule, the K4 merge pass (keys only and pairs), the pair sort (K5 + K4),
the tag-merge count and the m-pass count join.  JAX runs Pallas in
interpret mode with 8-row (1,024-key) blocks and tiles; the port runs its
CPU path (the kernels' plain PyTorch versions) with 1,024-key blocks.
Every result is an integer: the tolerance is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.models import mpass as jmpass
from avx_sort_merge_joins_tpu.ops import mergejoin as jmj
from avx_sort_merge_joins_tpu.ops import sort as jsort
from avx_sort_merge_joins_tpu.types import JoinConfig as JConfig
from avx_sort_merge_joins_tpu.types import Relation as JRelation
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.models import mpass as tmpass
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ROWS = 8
BLOCK = ROWS * 128
DMAX = 2**31 - 2  # keys lie in [-DMAX, DMAX]
N_PASS = 4 * BLOCK + 100  # 5 runs, then 3: odd run counts, ragged last run


def _pairs(kind, n, seed):
    """Seeded (keys, payloads) with duplicate keys and payloads, and
    payloads equal to both pad values."""
    rng = np.random.default_rng(seed)
    if kind == "domain_ends":
        k = rng.choice(np.array([-DMAX, -DMAX + 1, 0, DMAX - 1, DMAX],
                                np.int32), n)
    else:
        k = rng.integers(-40, 40, n).astype(np.int32)
    p = rng.integers(-3, 3, n).astype(np.int32)
    p[::97] = 2**31 - 1
    p[::89] = -(2**31)
    return k, p


@pytest.mark.parametrize("n", [1, BLOCK, 2500, 7000, 65_537])
def test_pair_levels_match_jax(n):
    want = [(nruns, span) for _, span, nruns in jmpass._pair_levels(n, ROWS)]
    assert tsort.pair_levels(n, BLOCK) == want


def _lex(k, p, descending):
    order = np.lexsort((p, k))
    return (k[order][::-1], p[order][::-1]) if descending else \
        (k[order], p[order])


@pytest.mark.parametrize("mode", ["keys", "pairs", "pairs_descending"])
def test_merge_pass_matches_jax(mode):
    """Two successive passes.  The JAX runs alternate direction; each port
    run equals the JAX run sorted in the port's direction."""
    n = N_PASS
    keys, pays = _pairs("duplicates", n, seed=len(mode))
    desc = mode == "pairs_descending"
    jp = None if mode == "keys" else jnp.asarray(pays)
    jk, jp = jmpass._block_phase(jnp.asarray(keys), jp, n, ROWS, ROWS, desc)
    tp = None if mode == "keys" else torch.from_numpy(pays)
    if tp is None:
        tk = tsort.sort_blocks(torch.from_numpy(keys), n, BLOCK)
    else:
        tk, tp = tsort.sort_blocks_pairs(torch.from_numpy(keys), tp, n,
                                         BLOCK, desc)
    for (stride, span, nruns) in jmpass._pair_levels(n, ROWS)[:2]:
        jk, jp = jmpass._jit_merge_pass_level(
            n, (stride, span, nruns), ROWS, desc)(jk, jp)
        tk, tp = tsort.merge_pass(tk, tp, (nruns, n, span), desc)
        flat_k = np.asarray(jk).reshape(-1)
        flat_p = None if jp is None else np.asarray(jp).reshape(-1)
        for lo in range(0, n, 2 * span):
            hi = min(lo + 2 * span, n)
            if tp is None:
                np.testing.assert_array_equal(tk[lo:hi].numpy(),
                                              np.sort(flat_k[lo:hi]))
                continue
            want_k, want_p = _lex(flat_k[lo:hi], flat_p[lo:hi], desc)
            np.testing.assert_array_equal(tk[lo:hi].numpy(), want_k)
            np.testing.assert_array_equal(tp[lo:hi].numpy(), want_p)
        pad = -(2**31) if desc else 2**31 - 1
        assert bool((tk[n:] == pad).all())


@pytest.mark.parametrize("bad", ["dtype", "payload_shape", "lens",
                                 "past_last_pair", "strided"])
def test_merge_pass_rejects_what_the_kernel_does_not_take(bad):
    keys = torch.arange(4096, dtype=torch.int32)
    pays = torch.zeros(4096, dtype=torch.int32)
    lens = (4, 4096, 1024)
    if bad == "dtype":
        keys = keys.to(torch.int64)
    elif bad == "payload_shape":
        pays = pays[:4000]
    elif bad == "lens":
        lens = (3, 4096, 1024)
    elif bad == "past_last_pair":
        # two runs of 1,000 keys cover 2,000 slots, not 3,000
        keys, pays, lens = keys[:3000], pays[:3000], (2, 2000, 1000)
    else:
        keys = torch.arange(8192, dtype=torch.int32)[::2]
    with pytest.raises((TypeError, ValueError)):
        tsort.merge_pass(keys, pays, lens)


@functools.lru_cache(maxsize=None)
def _jax_sort_fn(n, descending):
    fn = jsort.sort_descending if descending else jsort.sort
    return jax.jit(functools.partial(fn, n=n, block_rows=ROWS,
                                     tile_rows=ROWS))


@pytest.mark.parametrize("kind", ["duplicates", "domain_ends"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_matches_jax(kind, descending):
    n = 2500  # three ragged 1,024-pair blocks
    keys, pays = _pairs(kind, n, seed=7)
    jk, jpay = _jax_sort_fn(n, descending)(jnp.asarray(keys),
                                           jnp.asarray(pays))
    fn = tsort.sort_descending if descending else tsort.sort
    tk, tp = fn(torch.from_numpy(keys), torch.from_numpy(pays), n, BLOCK)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk)[:n])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpay)[:n])
    want_k, want_p = _lex(keys, pays, descending)
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tp.numpy(), want_p)


def test_sort_torch_is_the_lexicographic_sort():
    keys, pays = _pairs("domain_ends", 5000, seed=3)
    tk, tp = tsort.sort_torch(torch.from_numpy(keys), torch.from_numpy(pays))
    want_k, want_p = _lex(keys, pays, False)
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tp.numpy(), want_p)


def _count_case(kind, nR, nS):
    rng = np.random.default_rng(len(kind) + nR)
    if kind == "duplicates":
        rk, sk = rng.integers(0, 60, nR), rng.integers(0, 60, nS)
    elif kind == "negative":
        rk, sk = (rng.integers(-3000, 10, nR), rng.integers(-3000, 10, nS))
    elif kind == "no_matches":
        rk = 2 * rng.integers(-5000, 5000, nR)
        sk = 2 * rng.integers(-5000, 5000, nS) + 1
    else:
        ends = np.array([-DMAX, -DMAX + 1, 0, DMAX - 1, DMAX])
        rk, sk = rng.choice(ends, nR), rng.choice(ends, nS)
    return np.sort(rk).astype(np.int32), np.sort(sk).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tag_count_fn(nR, nS):
    # one compiled program per shape: the cases below share two shapes
    return jax.jit(functools.partial(jmj.merge_join_count, nR=nR, nS=nS,
                                     tile_rows=ROWS))


@pytest.mark.parametrize("kind,nR,nS", [
    ("duplicates", 1500, 2100), ("negative", 2100, 1500),
    ("no_matches", 1500, 2100), ("domain_ends", 2100, 1500)])
def test_tag_merge_count_matches_jax(kind, nR, nS):
    rk, sk = _count_case(kind, nR, nS)
    want = jmj.merge_join_count_numpy(rk, sk)
    jstats = _jax_tag_count_fn(nR, nS)(jnp.asarray(rk),
                                       jnp.asarray(sk[::-1]))
    assert jmj.finish_count(jstats, tile_rows=ROWS) == want
    stats = tmj.merge_join_count(torch.from_numpy(rk), torch.from_numpy(sk),
                                 nR, nS)
    assert all(s.dtype == torch.int64 and s.dim() == 0 for s in stats)
    assert tmj.finish_count(stats) == want


def test_tag_merge_count_of_empty_sides():
    rk, sk = _count_case("duplicates", 300, 200)
    for nR, nS in ((0, 200), (300, 0), (0, 0), (1, 1)):
        assert tmj.finish_count(tmj.merge_join_count(
            torch.from_numpy(rk), torch.from_numpy(sk), nR, nS)) == \
            tmj.merge_join_count_numpy(rk[:nR], sk[:nS])


def _relations(kind):
    n = 2500  # three ragged 1,024-key blocks: an odd run count
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
        sk = rng.integers(1, n + 1, n).astype(np.int32)
    elif kind == "non_unique":
        rk = rng.integers(0, 300, n).astype(np.int32)
        sk = rng.integers(0, 300, n).astype(np.int32)
    else:  # negative keys, down to the end of the domain
        rk = rng.integers(-DMAX, -DMAX + 4000, n).astype(np.int32)
        sk = rng.integers(-DMAX, -DMAX + 4000, n).astype(np.int32)
    pay = rng.integers(0, 1000, n).astype(np.int32)
    jR, jS = JRelation.from_numpy(rk, pay), JRelation.from_numpy(sk, pay)
    tR = Relation.from_numpy(*jR.to_numpy(), device="cpu")
    tS = Relation.from_numpy(*jS.to_numpy(), device="cpu")
    return jR, jS, tR, tS, tmj.merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("kind", ["pk_fk", "non_unique", "negative"])
def test_mpass_matches_jax(kind):
    jR, jS, tR, tS, want = _relations(kind)
    jres = jmpass.sortmergejoin_multipass(jR, jS, block_rows=ROWS,
                                          tile_rows=ROWS)
    tres = tmpass.sortmergejoin_multipass(tR, tS, block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sort", "merge1", "mergerest", "mergejoin",
                                "total"}
    assert tres.bytes_moved == jres.bytes_moved


@pytest.mark.parametrize("swap", ["scalar_sort", "scalar_merge"])
def test_mpass_scalar_swaps_match_jax(swap):
    jR, jS, tR, tS, want = _relations("non_unique")
    jres = jmpass.sortmergejoin_multipass(jR, jS, JConfig(**{swap: True}),
                                          block_rows=ROWS, tile_rows=ROWS)
    tres = tmpass.sortmergejoin_multipass(tR, tS, JoinConfig(**{swap: True}),
                                          block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sortmerge", "total"}


def test_mpass_refuses_materialize():
    rel = Relation.from_numpy(np.arange(10, dtype=np.int32), device="cpu")
    with pytest.raises(NotImplementedError, match="m-way only"):
        tmpass.sortmergejoin_multipass(rel, rel,
                                       JoinConfig(materialize=True))


# Results of the compiled reference binary for these flags, pinned in
# tests/test_reference_parity.py (test_mpass_reference_golden*).
@pytest.mark.parametrize("argv,expected", [
    (["-r", "100000", "-s", "100000", "--non-unique", "-x", "9", "-y", "10"],
     100114),
    (["-r", "200000", "-s", "100000", "--non-unique", "-x", "3", "-y", "4"],
     99665),
], ids=["nonunique-9", "nonunique-asym-3"])
def test_cli_mpass_reference_golden_counts(argv, expected, capsys):
    assert tcli.main(["-a", "m-pass", "-n", "1", *argv,
                      "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1] == f"Results = {expected}"
    assert "[RECORD] m-pass 1 " in err
