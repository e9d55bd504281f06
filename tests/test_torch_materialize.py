"""Materialization of the PyTorch port against the JAX package on the same
seeded inputs: ``materialize_matches``, ``expand_matches`` and the m-way
materializing join (JAX in Pallas interpret mode with 8-row blocks and
tiles, the port with 1,024-key blocks on its CPU path).  Parity boundary:
the first ``n_matched`` rows of (keys, payloads, multiplicities) and the
first ``total`` expanded rows, order included; exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.models import mway as jmway
from avx_sort_merge_joins_tpu.ops import materialize as jmat
from avx_sort_merge_joins_tpu.types import JoinConfig as JConfig
from avx_sort_merge_joins_tpu.types import Relation as JRelation
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.datagen import generator as tgen
from avx_sort_merge_joins_tpu_torch.models import mpass as tmpass
from avx_sort_merge_joins_tpu_torch.models import mpsm as tmpsm
from avx_sort_merge_joins_tpu_torch.models import mway as tmway
from avx_sort_merge_joins_tpu_torch.ops import materialize as tmat
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ROWS = 8
BLOCK = ROWS * 128
DOMAIN_MAX = 2**31 - 2


def _sorted_inputs(kind, nR, nS, seed):
    rng = np.random.default_rng(seed)
    if kind == "pk":
        rk = rng.choice(4 * nR, nR, replace=False) - 2 * nR
        sk = rng.integers(-2 * nR, 2 * nR, nS)
    elif kind == "dup_r":
        rk = rng.integers(0, nR // 5, nR)
        sk = rng.integers(0, nR // 4, nS)
    elif kind == "domain_ends":
        ends = np.array([-DOMAIN_MAX, -DOMAIN_MAX + 1, 0, DOMAIN_MAX - 1,
                         DOMAIN_MAX])
        rk, sk = rng.choice(ends[[0, 2, 4]], nR), rng.choice(ends, nS)
    else:  # no key in common
        rk = 2 * rng.integers(0, 1000, nR)
        sk = 2 * rng.integers(0, 1000, nS) + 1
    sp = rng.integers(-(2**31), 2**31, nS)
    rk = np.sort(rk).astype(np.int32)
    order = np.lexsort((sp, sk))
    return rk, sk[order].astype(np.int32), sp[order].astype(np.int32)


@pytest.mark.parametrize("kind", ["pk", "dup_r", "domain_ends", "none"])
def test_materialize_and_expand_match_jax(kind):
    nR, nS = 5000, 8000
    rk, sk, sp = _sorted_inputs(kind, nR, nS, seed=len(kind))
    jok, jop, jom, jnm = jmat.materialize_matches(
        jnp.asarray(rk), nR, jnp.asarray(sk), jnp.asarray(sp), nS)
    tok, top, tom, tnm = tmat.materialize_matches(
        torch.from_numpy(rk), nR, torch.from_numpy(sk), torch.from_numpy(sp),
        nS)
    assert tnm == int(jnm) == int(np.isin(sk, rk).sum())
    assert (kind == "none") == (tnm == 0)
    for got, want in ((tok, jok), (top, jop), (tom, jom)):
        assert got.dtype == torch.int32 and got.shape == (tnm,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:tnm])
    total = int(tom.sum(dtype=torch.int64))
    jek, jep, jtotal = jmat.expand_matches(jok, jop, jom, jnm,
                                           max(8, total))
    tek, tep, ttotal = tmat.expand_matches(tok, top, tom, tnm)
    assert ttotal == int(jtotal) == total
    assert (kind in ("dup_r", "domain_ends")) == (total > tnm)
    np.testing.assert_array_equal(tek.numpy(), np.asarray(jek)[:total])
    np.testing.assert_array_equal(tep.numpy(), np.asarray(jep)[:total])
    rel = tmat.materialized_relation(tek, tep, ttotal)
    assert rel.sorted and rel.num_tuples == total


def _relations(kind, seed):
    rng = np.random.default_rng(seed)
    nR, nS = 2500, 3500  # three and four ragged 1,024-key blocks
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, nR + 1))
        sk = rng.integers(1, nR + 1, nS)
    elif kind == "dup_r":
        rk = rng.integers(0, 400, nR)
        sk = rng.integers(0, 500, nS)
    elif kind == "no_match":
        rk = 2 * rng.integers(-1000, 1000, nR)
        sk = 2 * rng.integers(-1000, 1000, nS) + 1
    else:  # empty S
        rk, nS = rng.integers(0, 400, nR), 0
        sk = np.zeros(0)
    rk, sk = rk.astype(np.int32), sk.astype(np.int32)
    # duplicate payloads too, so that the (key, payload) order is tested
    sp = rng.integers(-3, 4, nS).astype(np.int32)
    return rk, sk, sp


@pytest.mark.parametrize("fanin", [2, 16])
@pytest.mark.parametrize("kind", ["pk_fk", "dup_r", "no_match", "empty_s"])
def test_mway_materialize_matches_jax(kind, fanin):
    rk, sk, sp = _relations(kind, seed=fanin + len(kind))
    jres = jmway.sortmergejoin_multiway(
        JRelation.from_numpy(rk), JRelation.from_numpy(sk, sp),
        JConfig(materialize=True), fanin=fanin, block_rows=ROWS,
        tile_rows=ROWS)
    tres = tmway.sortmergejoin_multiway(
        Relation.from_numpy(rk, device="cpu"),
        Relation.from_numpy(sk, sp, device="cpu"),
        JoinConfig(materialize=True), fanin=fanin, block=BLOCK)
    # one output tuple <S-key, S-payload> per match pair, in S order
    ru, rc = np.unique(rk, return_counts=True)
    order = np.lexsort((sp, sk))
    at = np.clip(np.searchsorted(ru, sk[order]), 0, len(ru) - 1)
    mult = np.where(ru[at] == sk[order], rc[at], 0)
    ek, ep = np.repeat(sk[order], mult), np.repeat(sp[order], mult)
    assert tres.totalresults == jres.totalresults == len(ek)
    assert set(tres.phases) == {"sortmerge", "total"}
    (tthread,), (jthread,) = tres.resultlist, jres.resultlist
    assert tthread.nresults == len(ek) and tthread.shard_id == 0
    tk, tp = tthread.results.to_numpy()
    jk, jp = jthread.results.to_numpy()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tk, ek)
    np.testing.assert_array_equal(tp, ep)
    assert tthread.results.sorted


@pytest.mark.parametrize("join", [tmpass.sortmergejoin_multipass,
                                  tmpsm.sortmergejoin_mpsm])
def test_mpass_and_mpsm_refuse_to_materialize(join):
    """The JAX m-pass and mpsm joins ignore the flag and return a count; the
    port refuses rather than pass a count off as a materialized result."""
    rel = Relation.from_numpy(np.arange(10, dtype=np.int32), device="cpu")
    with pytest.raises(NotImplementedError, match="m-way only"):
        join(rel, rel, JoinConfig(materialize=True))


@pytest.mark.parametrize("extra,results", [([], 12000),
                                           (["--non-unique"], 12071)],
                         ids=["pk_fk", "non_unique"])
def test_cli_materialize_persist_writes_the_jax_clis_files(extra, results,
                                                           tmp_path, capsys):
    """--materialize --persist: R.tbl, S.tbl and Out.tbl byte for byte the
    files the JAX CLI writes for the same seeds (after
    tests/test_cli.py::test_cli_materialize_persist)."""
    argv = ["-a", "m-way", "-r", "8000", "-s", "12000", "--materialize",
            "-x", "5", "-y", "6", *extra]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main([*argv, "--persist", str(jdir)]) == 0
    jout = capsys.readouterr().out
    assert tcli.main([*argv, "--persist", str(tdir), "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert tout.strip().splitlines()[-1] == f"Results = {results}"
    assert f"Results = {results}" in jout
    for name, rows in (("R.tbl", 8000), ("S.tbl", 12000),
                       ("Out.tbl", results)):
        got = (tdir / name).read_bytes()
        assert got == (jdir / name).read_bytes(), name
        assert got.count(b"\n") == rows
    # Out.tbl read back is the output relation: the matched S tuples
    out = tgen.read_relation(str(tdir / "Out.tbl"), device="cpu")
    S = tgen.read_relation(str(tdir / "S.tbl"), device="cpu")
    assert out.num_tuples == results and S.num_tuples == 12000
    ok, op = out.to_numpy()
    assert bool((np.diff(ok) >= 0).all())
    sk, sp = S.to_numpy()
    assert set(zip(ok.tolist(), op.tolist())) <= set(zip(sk.tolist(),
                                                         sp.tolist()))


def test_cli_persist_without_materialize_writes_no_out(tmp_path, capsys):
    assert tcli.main(["-a", "m-pass", "-r", "3000", "-s", "3000", "--persist",
                      str(tmp_path), "--device", "cpu"]) == 0
    assert "Results = 3000" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["R.tbl", "S.tbl"]
