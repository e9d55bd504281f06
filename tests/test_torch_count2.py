"""The two-run count K10 and the ``SMJ_COUNT2`` m-way route of the PyTorch
port against the JAX package (JAX's Pallas kernel in interpret mode, at
8-row blocks and tiles; the port's plain version on the CPU) and against
the numpy oracle.  Integers: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.models import mway as jmway
from avx_sort_merge_joins_tpu.ops import mergejoin as jmj
from avx_sort_merge_joins_tpu.ops import multiwaymerge as jmw
from avx_sort_merge_joins_tpu_torch.models import mway as tmway
from avx_sort_merge_joins_tpu_torch.ops import mergejoin as tmj
from avx_sort_merge_joins_tpu_torch.ops import multiwaymerge as tmw
from avx_sort_merge_joins_tpu_torch.types import Relation

ROWS = 8
BLOCK = ROWS * 128


@pytest.mark.parametrize("fanin", [2, 4, 16])
@pytest.mark.parametrize("block_rows", [ROWS, 128])
def test_merge_levels_2runs_match_jax(fanin, block_rows):
    block = block_rows * 128
    for n in (1, block, block + 1, 2 * block, 2 * block + 1, 3000, 5 * block,
              17 * block - 3, 100_000, 1_000_003, 128_000_000):
        jlevels, jstride, jnruns = jmw.merge_levels_2runs(n, block_rows,
                                                          fanin)
        levels, span, nruns = tmw.merge_levels_2runs(n, block, fanin)
        assert levels == [(s * 128, sp, nr, w)
                          for s, sp, nr, w in jlevels], n
        assert (span, nruns) == (jstride * 128, jnruns), n
        assert nruns in (1, 2)


def test_merge_levels_2runs_at_128m():
    """The 128M route: 3 levels of fan-in 16 leave runs of 67,108,864 and
    60,891,136 keys."""
    levels, span, nruns = tmw.merge_levels_2runs(128_000_000, 16384, 16)
    assert [w for *_, w in levels] == [16, 16, 16]
    assert (span, nruns) == (67_108_864, 2)
    assert 128_000_000 - span == 60_891_136


def _two_runs(keys, span):
    """keys laid out as two ascending runs: [0, span) and [span, n)."""
    out = np.sort(keys[:span]), np.sort(keys[span:])
    return np.concatenate(out).astype(np.int32)


def test_count2_matches_jax_kernel():
    """One small two-run layout per side, with keys repeating within and
    across the runs, against JAX's merge_join_count_fused2 (interpret
    mode) + finish_count_fused."""
    rng = np.random.default_rng(2)
    nR, nS, stride = 1500, 1800, ROWS
    span = stride * 128
    rk = _two_runs(rng.integers(0, 400, nR), span)
    sk = _two_runs(rng.integers(0, 400, nS), span)
    pad = np.full(2 * span, 2**31 - 1, np.int32)
    r2d = np.concatenate([rk, pad[:2 * span - nR]]).reshape(-1, 128)
    s2d = np.concatenate([sk, pad[:2 * span - nS]]).reshape(-1, 128)
    want = jmj.finish_count_fused(jmj.merge_join_count_fused2(
        jnp.asarray(r2d), jnp.asarray(s2d), nR, nS, stride, stride,
        tile_rows=ROWS))
    got = tmj.merge_join_count_fused2(torch.from_numpy(rk),
                                      torch.from_numpy(sk), nR, nS, span,
                                      span)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert tmj.finish_count_fused(got) == want \
        == tmj.merge_join_count_numpy(rk, sk)


def _two_runs_cut(rng, n, span, key):
    """Two ascending runs of n keys in [0, 400) cut at span, with ``key``
    the last three keys of run 0 and the first three of run 1."""
    run0 = np.r_[rng.integers(0, key, span - 3), [key] * 3]
    run1 = np.r_[[key] * 3, rng.integers(key, 400, n - span - 3)]
    return np.concatenate([np.sort(run0), np.sort(run1)]).astype(np.int32)


def test_count2_cut_keys_match_jax_kernel():
    """R cut at 1,024 and S at 512 (span_r != span_s), the key 200 on both
    sides of each side's cut, against JAX's merge_join_count_fused2
    (interpret mode): R's shape is test_count2_matches_jax_kernel's."""
    rng = np.random.default_rng(3)
    nR, nS, r_rows, s_rows = 1500, 900, ROWS, ROWS // 2
    span_r, span_s = r_rows * 128, s_rows * 128
    rk = _two_runs_cut(rng, nR, span_r, 200)
    sk = _two_runs_cut(rng, nS, span_s, 200)
    r2d = np.concatenate([rk, np.full(2 * span_r - nR, 2**31 - 1, np.int32)])
    s2d = np.concatenate([sk, np.full(2 * span_s - nS, 2**31 - 1, np.int32)])
    want = jmj.finish_count_fused(jmj.merge_join_count_fused2(
        jnp.asarray(r2d.reshape(-1, 128)), jnp.asarray(s2d.reshape(-1, 128)),
        nR, nS, r_rows, s_rows, tile_rows=ROWS))
    got = tmj.merge_join_count_fused2_plain(torch.from_numpy(rk),
                                            torch.from_numpy(sk), nR, nS,
                                            span_r, span_s)
    assert int(got) == want == tmj.merge_join_count_numpy(rk, sk)
    assert want > 36  # the cut key: 6 in R times 6 in S, and more


@pytest.mark.parametrize("nR,span_r,nS,span_s", [
    (5000, 4096, 3000, 2048),   # ragged run 1 on both sides
    (4096, 4096, 3000, 2048),   # R's run 1 empty
    (1000, 4096, 4000, 2000),   # R in run 0 only, S's run 1 full
    (1, 1, 2, 1),               # one key per run
    (0, 8, 10, 5),              # no R
])
def test_count2_layouts_vs_numpy(nR, span_r, nS, span_s):
    rng = np.random.default_rng(nR + nS)
    rk = _two_runs(rng.integers(-50, 50, nR), span_r)
    sk = _two_runs(rng.integers(-50, 50, nS), span_s)
    # a key that straddles the two runs of S: the last of run 0 is
    # also the first of run 1
    if nS > span_s:
        sk[span_s] = sk[span_s - 1]
        sk[span_s:] = np.sort(sk[span_s:])
    got = tmj.merge_join_count_fused2(torch.from_numpy(rk),
                                      torch.from_numpy(sk), nR, nS, span_r,
                                      span_s)
    assert int(got) == tmj.merge_join_count_numpy(rk, sk)


def test_count2_hot_key_past_2_31():
    n = 1 << 16
    rk = np.full(n, 7, np.int32)
    sk = np.full(n + 5, 7, np.int32)
    got = tmj.merge_join_count_fused2(torch.from_numpy(rk),
                                      torch.from_numpy(sk), n, n + 5, 40_000,
                                      33_000)
    assert int(got) == n * (n + 5) == tmj.merge_join_count_numpy(rk, sk)
    assert int(got) > 2**31


def test_count2_refuses_more_than_two_runs():
    keys = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="two runs"):
        tmj.merge_join_count_fused2(keys, keys, 100, 100, 49, 50)


def _spy(monkeypatch):
    """Count the calls of the two-run and the one-run count."""
    calls = {"count2": 0, "count": 0}
    for name, key in (("merge_join_count_fused2", "count2"),
                      ("merge_join_count_fused", "count")):
        real = getattr(tmj, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(tmj, name, spy)
    return calls


def test_mway_count2_route_matches_jax(monkeypatch):
    """_mway_count_device under SMJ_COUNT2=1 at the smallest size that
    routes through the two-run count (3,000 keys in three 1,024-key
    blocks: one fan-in-2 level), against the JAX function."""
    monkeypatch.setenv("SMJ_COUNT2", "1")
    rng = np.random.default_rng(4)
    n = 3000
    rk = rng.integers(0, 900, n).astype(np.int32)
    sk = rng.integers(0, 900, n).astype(np.int32)
    want = jmj.finish_count_fused(jmway._mway_count_device(
        jnp.asarray(rk), jnp.asarray(sk), n, n, 16, ROWS, ROWS))
    calls = _spy(monkeypatch)
    got = tmway._mway_count_device(torch.from_numpy(rk),
                                   torch.from_numpy(sk), n, n, 16, BLOCK)
    assert calls == {"count2": 1, "count": 0}
    assert tmj.finish_count_fused(got) == want \
        == tmj.merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("nR,nS,switch,route", [
    (3000, 3000, "0", "count"),    # the switch off
    (900, 3000, "1", "count"),     # R in one block: both take the one-run
    (3000, 1024, "1", "count"),    # S in one block
    (5000, 2049, "1", "count2"),   # three and five blocks: two runs each
])
def test_mway_count2_falls_back_as_jax(monkeypatch, nR, nS, switch, route):
    monkeypatch.setenv("SMJ_COUNT2", switch)
    rng = np.random.default_rng(nR)
    rk = rng.integers(0, 700, nR).astype(np.int32)
    sk = rng.integers(0, 700, nS).astype(np.int32)
    calls = _spy(monkeypatch)
    got = tmway._mway_count_device(torch.from_numpy(rk),
                                   torch.from_numpy(sk), nR, nS, 16, BLOCK)
    assert calls[route] == 1 and sum(calls.values()) == 1
    assert int(got) == tmj.merge_join_count_numpy(rk, sk)


def test_phased_join_ignores_the_switch(monkeypatch):
    """sortmergejoin_multiway never reads SMJ_COUNT2, as the JAX one."""
    monkeypatch.setenv("SMJ_COUNT2", "1")
    rng = np.random.default_rng(8)
    rk = rng.integers(0, 700, 5000).astype(np.int32)
    sk = rng.integers(0, 700, 5000).astype(np.int32)
    calls = _spy(monkeypatch)
    res = tmway.sortmergejoin_multiway(Relation.from_numpy(rk, device="cpu"),
                                       Relation.from_numpy(sk, device="cpu"),
                                       block=BLOCK)
    assert calls == {"count2": 0, "count": 1}
    assert res.totalresults == tmj.merge_join_count_numpy(rk, sk)
