"""The mpsm count join of the PyTorch port against the JAX package on the
same relations (JAX in Pallas interpret mode with 8-row blocks and tiles,
the port on its CPU path with 1,024-key blocks), and through the port's
CLI.  Counts are integers: the tolerance is exact equality."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.models import mpsm as jmpsm
from avx_sort_merge_joins_tpu.types import JoinConfig as JConfig
from avx_sort_merge_joins_tpu.types import Relation as JRelation
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.models import mpsm as tmpsm
from avx_sort_merge_joins_tpu_torch.ops.mergejoin import (
    merge_join_count_numpy)
from avx_sort_merge_joins_tpu_torch.types import JoinConfig, Relation

ROWS = 8
BLOCK = ROWS * 128
NR, NS = 2500, 2101  # ragged blocks; S chunks of 1,051 and 1,050 keys


def _relations(kind, nS=NS):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "pk_fk":
        rk = rng.permutation(np.arange(1, NR + 1)).astype(np.int32)
        sk = rng.integers(1, NR + 1, nS).astype(np.int32)
    elif kind == "non_unique":
        rk = rng.integers(0, 300, NR).astype(np.int32)
        sk = rng.integers(0, 300, nS).astype(np.int32)
    else:  # negative keys, down to the end of the domain
        rk = rng.integers(-(2**31 - 2), -(2**31 - 2) + 4000, NR).astype(
            np.int32)
        sk = rng.integers(-(2**31 - 2), -(2**31 - 2) + 4000, nS).astype(
            np.int32)
    jR = JRelation.from_numpy(rk, rng.integers(0, 1000, NR).astype(np.int32))
    jS = JRelation.from_numpy(sk, rng.integers(0, 1000, nS).astype(np.int32))
    tR = Relation.from_numpy(*jR.to_numpy(), device="cpu")
    tS = Relation.from_numpy(*jS.to_numpy(), device="cpu")
    return jR, jS, tR, tS, merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("kind", ["pk_fk", "non_unique", "negative"])
def test_mpsm_matches_jax(kind):
    jR, jS, tR, tS, want = _relations(kind)
    jres = jmpsm.sortmergejoin_mpsm(jR, jS, nchunks=2, block_rows=ROWS,
                                    tile_rows=ROWS)
    tres = tmpsm.sortmergejoin_mpsm(tR, tS, nchunks=2, block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sort", "mergejoin", "total"}
    assert tres.bytes_moved == jres.bytes_moved


@pytest.mark.parametrize("swap", ["scalar_sort", "scalar_merge"])
def test_mpsm_scalar_swaps_match_jax(swap):
    jR, jS, tR, tS, want = _relations("non_unique")
    jres = jmpsm.sortmergejoin_mpsm(jR, jS, JConfig(**{swap: True}),
                                    nchunks=2, block_rows=ROWS,
                                    tile_rows=ROWS)
    tres = tmpsm.sortmergejoin_mpsm(tR, tS, JoinConfig(**{swap: True}),
                                    nchunks=2, block=BLOCK)
    assert tres.totalresults == jres.totalresults == want
    assert set(tres.phases) == {"sort", "mergejoin", "total"}


@pytest.mark.parametrize("nS,nchunks,live", [
    (5, 8, 5),    # more chunks than S keys: the chunks stop at the first
    (10, 4, 4),   # empty one (chunk 3 keys: 3, 3, 3, 1)
    (9, 4, 3),    # 3, 3, 3 and an empty fourth
    (0, 3, 0)])
def test_mpsm_stops_at_empty_chunks(nS, nchunks, live):
    _, _, tR, tS, _ = _relations("non_unique", nS=nS)
    assert len(tmpsm._chunks(nS, nchunks)) == live
    res = tmpsm.sortmergejoin_mpsm(tR, tS, nchunks=nchunks, block=BLOCK)
    assert res.totalresults == merge_join_count_numpy(
        tR.to_numpy()[0], tS.to_numpy()[0])
    assert res.bytes_moved["mergejoin"] == 4 * (NR * live + nS)


def test_mpsm_refuses_what_it_cannot_run():
    rel = Relation.from_numpy(np.arange(10, dtype=np.int32), device="cpu")
    with pytest.raises(NotImplementedError, match="m-way only"):
        tmpsm.sortmergejoin_mpsm(rel, rel, JoinConfig(materialize=True))
    with pytest.raises(ValueError):
        tmpsm.sortmergejoin_mpsm(rel, rel, nchunks=0)


@pytest.mark.parametrize("extra", [[], ["--non-unique"]])
def test_cli_mpsm_counts(extra, capsys):
    argv = ["-r", "30000", "-s", "40000", "-x", "7", "-y", "8", *extra]
    assert tcli.main(["-a", "mpsm", "--nchunks", "4", *argv,
                      "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    R, S = tcli.make_relations(tcli.build_parser().parse_args(argv), "cpu")
    want = merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
    if not extra:
        assert want == 40000  # pk-fk: every S key matches once
    assert out.strip().splitlines()[-1] == f"Results = {want}"
    assert "[RECORD] mpsm 1 30000 40000 " in err


@pytest.mark.parametrize("argv", [["--nchunks", "0"], ["--nchunks", "-2"]])
def test_cli_refuses_bad_nchunks(argv, capsys):
    assert tcli.main(["-a", "mpsm", "-r", "100", "-s", "100", *argv,
                      "--device", "cpu"]) == 2
    assert "Results" not in capsys.readouterr().out


def test_cli_warns_on_nchunks_outside_mpsm(capsys):
    assert tcli.main(["-a", "m-way", "-r", "1000", "-s", "1000",
                      "--nchunks", "4", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "--nchunks applies to single-device mpsm only" in err
    assert out.strip().splitlines()[-1] == "Results = 1000"
