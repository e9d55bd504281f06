"""KEY_8B (64-bit keys as two int32 planes) of the PyTorch port against the
JAX package (Pallas in interpret mode) and the numpy oracle on the same
seeded inputs, on the CPU path of the wrappers; the inputs K7's merge-path
tiles must count exactly (the card tests' K7 cases); and the four KEY_8B
golden counts of the compiled reference binary through the port's CLI,
also with ``-n N``.  Tolerance: exact equality."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops import join64 as jj
from avx_sort_merge_joins_tpu.ops import mergejoin as jmj
from avx_sort_merge_joins_tpu.ops.bitonic import KEY_POS_INF, LANES
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.ops import join64 as tj
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.ops import sort as tsort
from test_torch_gpu import K7_KINDS, k7_case

DOMAIN_MAX = 2**31 - 2
INT64_MAX = 2**63 - 1
JAX_MAX_N = 16385  # the JAX kernels run in interpret mode up to this size


def _wide_keys(n, seed):
    """int64 keys whose hi plane varies and is not the sign extension of
    the lo plane, with duplicates, negative keys and both int64 ends of
    the planes' range."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**62), 2**62, max(2, n // 3)).astype(np.int64)
    pool[0], pool[1] = 2**32 - 1, 2**32  # lo plane wraps, hi steps
    k = pool[rng.integers(0, len(pool), n)]
    return k


def test_split_join_match_jax_and_roundtrip():
    k = _wide_keys(10000, 1)
    thi, tlo = tj.split64(k)
    jhi, jlo = jj.split64(k)
    np.testing.assert_array_equal(thi, jhi)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(tj.join64(thi, tlo), k)
    assert int(tj.LO_BIAS) == int(jj.LO_BIAS)
    # the packed pair of the planes is the original int64 key
    packed = tsort.pack_pairs(torch.from_numpy(thi), torch.from_numpy(tlo))
    np.testing.assert_array_equal(packed.numpy(), k)


def test_widen32_matches_jax_at_both_ends_of_the_domain():
    rng = np.random.default_rng(2)
    k32 = rng.integers(-DOMAIN_MAX, DOMAIN_MAX + 1, 30000).astype(np.int32)
    k32[:4] = (-DOMAIN_MAX, DOMAIN_MAX, 0, -1)
    thi, tlo = tj.widen32(torch.from_numpy(k32))
    jhi, jlo = jj.widen32(jnp.asarray(k32))
    assert thi.dtype == tlo.dtype == torch.int32
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tj.join64(thi.numpy(), tlo.numpy()),
                                  k32.astype(np.int64))


@pytest.mark.parametrize("n", [1, 16384, 16385, 50000])
def test_sort64_matches_jax(n):
    k = _wide_keys(n, n)
    hi, lo = tj.split64(k)
    thi, tlo = tj.sort64(torch.from_numpy(hi), torch.from_numpy(lo), n)
    got = tj.join64(thi[:n].numpy(), tlo[:n].numpy())
    np.testing.assert_array_equal(got, np.sort(k))
    if n <= JAX_MAX_N:  # the JAX sort in interpret mode, at smaller sizes
        jhi, jlo = jj.sort64(jnp.asarray(hi), jnp.asarray(lo), n)
        np.testing.assert_array_equal(thi[:n].numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(tlo[:n].numpy(), np.asarray(jlo))


@pytest.mark.parametrize("nR,nS", [(0, 0), (0, 5), (5, 0), (1, 1),
                                   (4000, 5000)])
def test_fused64_matches_the_oracle_on_wide_keys(nR, nS):
    """Equal hi planes with different lo planes must not match."""
    rk, sk = _wide_keys(max(nR, 1), 3)[:nR], _wide_keys(max(nS, 1), 3)[:nS]
    if nR == nS == 1:
        sk = rk + 1  # same hi plane, other lo plane: no match
    rhi, rlo = (torch.from_numpy(a) for a in tj.split64(np.sort(rk)))
    shi, slo = (torch.from_numpy(a) for a in tj.split64(np.sort(sk)))
    got = tmj.merge_join_count_fused64(rhi, rlo, shi, slo, nR, nS)
    assert got.dtype == torch.int64 and got.dim() == 0
    want = tj.merge_join_count_numpy64(rk, sk)
    assert int(got) == want == jj.merge_join_count_numpy64(rk, sk)
    assert (nR, nS) != (1, 1) or want == 0
    r64 = torch.from_numpy(np.sort(rk))
    s64 = torch.from_numpy(np.sort(sk))
    assert int(tj.merge_join_count_torch64(r64, s64)) == want
    if nR > 1:
        got_j = int(jj.merge_join_count_xla64(
            *(jnp.asarray(a) for a in tj.split64(rk)),
            *(jnp.asarray(a) for a in tj.split64(sk)), nR, nS))
        assert got_j == want


@functools.cache
def _jax_count64_jit():
    return jax.jit(lambda rh, rl, sh, sl, nR, nS:
                   jmj.merge_join_count_fused64(rh, rl, sh, sl, nR, nS))


def _jax_count64(rk, sk):
    """The JAX ``merge_join_count_fused64`` (``_count_kernel64``) of sorted
    int64 keys, each side's planes padded to one layout of 256 rows of
    128 lanes, so that every case shares one compile."""
    def planes(k):
        out = np.full((2, 256 * LANES), KEY_POS_INF, np.int32)
        out[0, :k.size], out[1, :k.size] = jj.split64(k)
        return [jnp.asarray(p.reshape(-1, LANES)) for p in out]

    return jmj.finish_count_fused(_jax_count64_jit()(
        *planes(rk), *planes(sk), rk.size, sk.size))


@pytest.mark.parametrize("kind", K7_KINDS)
def test_count64_at_tile_edges_against_numpy_and_jax(kind):
    """The inputs K7's merge-path tiles must count exactly (hot keys over
    many CTAs and tiles, runs across a tile and the window, equal hi with
    other lo at the tile edges, the planes' ends, a side of one key or
    none, nR + nS at a tile's and a CTA's size - 1, + 0 and + 1), through
    the CPU path of its wrapper."""
    rk, sk = k7_case(kind)
    got = tmj.merge_join_count_fused64(
        *(torch.from_numpy(p) for p in (*tj.split64(rk), *tj.split64(sk))),
        rk.size, sk.size)
    assert int(got) == tj.merge_join_count_numpy64(rk, sk)
    if max(rk.size, sk.size) <= JAX_MAX_N:
        # the JAX kernel pads its planes with (INT32_MAX, INT32_MAX), the
        # key 2^63 - 1: it counts the keys below that one
        jr, js = rk[rk != INT64_MAX], sk[sk != INT64_MAX]
        assert _jax_count64(jr, js) == tj.merge_join_count_numpy64(jr, js)


def _key_columns(kind, nR, nS, seed):
    rng = np.random.default_rng(seed)
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, nR + 1))
        sk = rng.integers(1, nR + 1, nS)
    elif kind == "non_unique":
        rk, sk = rng.integers(1, 3000, nR), rng.integers(1, 3000, nS)
    else:  # both ends of the key domain: the hi plane takes both values
        ends = np.array([-DOMAIN_MAX, -DOMAIN_MAX + 1, -1, 0, DOMAIN_MAX - 1,
                         DOMAIN_MAX])
        rk, sk = rng.choice(ends, nR), rng.choice(ends, nS)
    return rk.astype(np.int32), sk.astype(np.int32)


@pytest.mark.parametrize("pallas_sort", [True, False])
@pytest.mark.parametrize("kind,nR,nS", [
    ("pk_fk", 6000, 9000), ("non_unique", 20000, 17000),
    ("domain_ends", 3000, 2000), ("pk_fk", 1, 1), ("pk_fk", 1, 0),
    ("pk_fk", 0, 0)])
def test_key8b_join_count_matches_jax(kind, nR, nS, pallas_sort):
    rk, sk = _key_columns(kind, max(nR, 1), max(nS, 1), nR + nS)
    rk, sk = rk[:nR], sk[:nS]
    (rhi, rlo), (shi, slo), count = tj.key8b_join_count(
        torch.from_numpy(rk), torch.from_numpy(sk), nR, nS,
        pallas_sort=pallas_sort)
    want = tj.merge_join_count_numpy64(rk.astype(np.int64),
                                       sk.astype(np.int64))
    assert tj.finish_count64(count) == want
    # both sides come back ascending (the JAX S planes are in NOT layout)
    np.testing.assert_array_equal(tj.join64(rhi.numpy(), rlo.numpy()),
                                  np.sort(rk.astype(np.int64)))
    np.testing.assert_array_equal(tj.join64(shi.numpy(), slo.numpy()),
                                  np.sort(sk.astype(np.int64)))
    if nR and nS and nR + nS < 30000:
        (jrhi, jrlo), (jshi, jslo), limbs, ovf = jj.key8b_join_count(
            jnp.asarray(rk), jnp.asarray(sk), nR, nS,
            pallas_sort=pallas_sort, recover_s=True)
        assert int(ovf) == 0 and jj.finish_count64(limbs) == want
        for got, ref in ((rhi, jrhi), (rlo, jrlo), (shi, jshi), (slo, jslo)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pallas_sort", [True, False])
def test_key8b_hot_key_count_passes_2_31(pallas_sort):
    """2^16 x 2^16 equal keys: the JAX baseline's int32 count wraps here
    (ops/join64.py:125-139); the port's must equal the numpy oracle."""
    n = 1 << 16
    rk = np.concatenate([np.full(n, -7, np.int32),
                         np.arange(10, 3010, dtype=np.int32)])
    sk = np.concatenate([np.arange(10, 3010, dtype=np.int32),
                         np.full(n, -7, np.int32)])
    _, _, count = tj.key8b_join_count(torch.from_numpy(rk),
                                      torch.from_numpy(sk), len(rk), len(sk),
                                      pallas_sort=pallas_sort)
    assert tj.finish_count64(count) == 2**32 + 3000 == \
        tj.merge_join_count_numpy64(rk.astype(np.int64), sk.astype(np.int64))


# Results of the compiled KEY_8B reference binary, pinned in
# tests/test_reference_parity.py (KEY8B_GOLDEN).
KEY8B_GOLDEN = [
    (["-r", "50000", "-s", "80000", "-x", "12345", "-y", "54321"], 80000),
    (["-r", "60000", "-s", "90000", "--non-unique", "-x", "5", "-y", "6"],
     89965),
    (["-r", "50000", "-s", "75000", "--full-range", "-x", "9", "-y", "10"],
     75000),
    (["-r", "40000", "-s", "40000", "-x", "2", "-y", "3"], 40000),
]


@pytest.mark.parametrize("scalar", [[], ["--scalarsort"]],
                         ids=["kernels", "scalarsort"])
@pytest.mark.parametrize("argv,expected", KEY8B_GOLDEN,
                         ids=["key8b-default", "key8b-nonunique",
                              "key8b-fullrange", "key8b-square"])
def test_cli_key8b_reference_golden(argv, expected, scalar, capsys):
    assert tcli.main(["--key8b", "-a", "m-pass", *argv, *scalar,
                      "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1] == f"Results = {expected}"
    stats = [ln for ln in err.splitlines() if ln.startswith("[STATS]")]
    n = int(argv[1]) + int(argv[3])
    assert len(stats) == 1 and stats[0].startswith(
        f"[STATS] NUMTUPLES {n}, TUPLES-PER-SECOND ")
    assert stats[0].endswith(", DEVICE cpu")


@pytest.mark.parametrize("argv,expected", KEY8B_GOLDEN[:2],
                         ids=["key8b-default", "key8b-nonunique"])
def test_cli_key8b_on_n_shards_runs_on_one_device(argv, expected, capsys):
    """``-n 4 --key8b`` is the one-device KEY_8B join, as in the JAX CLI
    (cli.py:403-432): the same Results line and [STATS] line as ``-n 1``,
    the reference's golden count."""
    for n in ("1", "4"):
        assert tcli.main(["--key8b", "-n", n, *argv, "--device", "cpu"]) \
            == 0
        out, err = capsys.readouterr()
        assert out.strip().splitlines()[-1] == f"Results = {expected}"
        stats = [ln for ln in err.splitlines() if ln.startswith("[STATS]")]
        assert len(stats) == 1 and stats[0].startswith(
            f"[STATS] NUMTUPLES {int(argv[1]) + int(argv[3])}, "
            "TUPLES-PER-SECOND ") and stats[0].endswith(", DEVICE cpu")
        assert "not yet ported" not in err


def test_cli_key8b_raises_the_fanout_to_n(monkeypatch, capsys):
    """A fan-out below N is raised to the power of two at or above N
    before the KEY_8B join, with a warning, as the JAX CLI's ``_validate``
    does (cli.py:349-356)."""
    argv = ["--key8b", "-n", "5", "-f", "2", "-r", "3000", "-s", "3000"]
    assert jcli.main([*argv, "--scalarsort"]) == 0
    out, err = capsys.readouterr()
    assert "raising partfanout" in err and "Results = 3000" in out
    fanins = []
    join = tj.key8b_join_count
    monkeypatch.setattr(tj, "key8b_join_count", lambda *a, **k: (
        fanins.append(k["fanin"]), join(*a, **k))[1])
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "raising partfanout" in err and "Results = 3000" in out
    assert fanins == [8]
