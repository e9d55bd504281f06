"""The workload-A scale tier of the port (``parallel/scale.py``), its CLI
route, ``bench/scalebench.py`` and the roofline rows, on the CPU against
the JAX package.  Data passes between the packages as numpy; the JAX side
runs its ``use_pallas=False`` route and compiles two shard programs (the
sharded generation and one distributed count).  Integers compare exactly
(tolerance 0).

The port's S is drawn by a ``torch.Generator``, not JAX's threefry, so the
S arrays of the two packages differ: the tests pin R exactly, S's range,
seeding and skew, and every count (|S|, and the JAX join of the port's own
arrays)."""

import math

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu.parallel import scale as jscale
from avx_sort_merge_joins_tpu.utils import profiling as jprof
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch.bench import scalebench
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh
from avx_sort_merge_joins_tpu_torch.parallel import scale as tscale
from avx_sort_merge_joins_tpu_torch.utils import profiling as tprof

N = 1 << 16  # keys a relation: 8,192 a shard on 8 shards
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(8, CPU)


@pytest.mark.parametrize("n,z,bins", [
    (1000, 1.0, 4096), (300_000, 1.25, 1 << 14), (N, 0.5, 1 << 16),
    (N, 1.0, tscale.ZIPF_QUANTILE_BINS),
    ((1 << 24) + 4097, 1.0, 1024)])  # two chunks of 2^24 a pass
def test_zipf_quantile_lut_equals_jax_bit_for_bit(n, z, bins):
    got = tscale._zipf_quantile_lut(n, z, bins)
    want = jscale._zipf_quantile_lut(n, z, bins)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_r_shards_equal_jax(mesh8):
    """R is the strided key set ``me + 1 + 8 j``, the JAX arrays exactly;
    over the mesh it is 1..n once each."""
    jr, _ = jscale.make_workload_a_sharded(N, N, jmesh.make_mesh(8))
    tr, ts = tscale.make_workload_a_sharded(N, N, mesh8)
    assert tr.shape == ts.shape == (8, N // 8)
    assert tr.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert sorted(tr.reshape(-1).tolist()) == list(range(1, N + 1))


def test_s_uniform_range_seed_and_shards(mesh8):
    _, s1 = tscale.make_workload_a_sharded(N, N, mesh8, seed=42)
    _, s2 = tscale.make_workload_a_sharded(N, N, mesh8, s_seed=42)
    _, s3 = tscale.make_workload_a_sharded(N, N, mesh8, s_seed=43)
    assert int(s1.min()) >= 1 and int(s1.max()) <= N
    assert torch.equal(s1, s2)  # s_seed defaults to seed
    assert not torch.equal(s1, s3)
    assert all(not torch.equal(s1[0], s1[me]) for me in range(1, 8))


def test_s_skewed_is_the_luts_image_and_zipf_shaped(mesh8):
    """Under skew=1.0 every S key is a LUT entry, and key 1 carries about
    1/H(n) of S: within 0.005 (4.5 sigma of the 65,536-draw sample, plus
    the table's 2^-20 bins)."""
    _, sk = tscale.make_workload_a_sharded(N, N, mesh8, skew=1.0)
    s = sk.reshape(-1).numpy()
    lut = tscale._zipf_quantile_lut(N, 1.0)
    assert np.isin(s, lut).all()
    harmonic = math.fsum(1.0 / k for k in range(1, N + 1))
    assert abs((s == 1).mean() - 1 / harmonic) < 0.005


def test_sizes_must_divide_by_the_shards(mesh8):
    with pytest.raises(ValueError, match="divide"):
        tscale.make_workload_a_sharded(N + 4, N, mesh8)


@pytest.mark.parametrize("skew,slack", [(0.0, 2.0), (1.0, 4.0)])
@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_workload_a_join_count_is_the_size_of_s(mesh8, use_kernels, phased,
                                                skew, slack):
    out = tscale.workload_a_join_count(N, N, mesh8, use_kernels=use_kernels,
                                       skew=skew, slack=slack, phased=phased)
    assert out[:2] == (N, 0)
    if phased:
        assert set(out[2]) == {"sort", "merge1", "mergejoin", "total"}


def test_port_arrays_through_the_jax_join(mesh8):
    """The port's generated columns, flattened, through the JAX
    distributed m-way (its XLA route): the same count, |S|."""
    from avx_sort_merge_joins_tpu.parallel import dist_mway as jdm

    rk, sk = tscale.make_workload_a_sharded(N, N, mesh8, skew=1.0)
    r, s = rk.reshape(-1).numpy(), sk.reshape(-1).numpy()
    got = jdm.dist_mway_join_count(r, s, N, N, jmesh.make_mesh(8),
                                   use_pallas=False)
    assert got == (N, 0)
    assert tscale.join_sharded(rk, sk, N, N, mesh8) == got


SCALE_ARGV = ["-a", "m-way", "-n", "8", "-r", "400000", "-s", "400000",
              "--device", "cpu"]


@pytest.mark.parametrize("phased", ["1", "0"])
def test_cli_scale_route(phased, capsys, monkeypatch):
    monkeypatch.setenv("SMJ_SHARDED_GEN_MIN", "100000")
    monkeypatch.setenv("SMJ_SCALE_PHASED", phased)
    assert tcli.main(SCALE_ARGV) == 0
    cap = capsys.readouterr()
    assert cap.out.strip() == "Results = 400000"
    assert "[INFO ] scale tier: sharded on-device generation" in cap.err
    assert "slack 2.0, overflow 0" in cap.err
    rec = [ln.split() for ln in cap.err.splitlines()
           if ln.startswith("[RECORD]")]
    assert len(rec) == 1
    cols = rec[0]
    assert cols[1:5] == ["m-way", "8", "400000", "400000"]
    assert cols[-1] == "cpu" and float(cols[-3]) > 0  # total usecs
    # phased: sort, merge1 and mergejoin columns; fused: the total only
    assert (all(float(c) > 0 for c in (cols[7], cols[8], cols[10]))
            == (phased == "1"))
    assert "TUPLES-PER-SECOND" in cap.err and "DEVICE cpu" in cap.err


def test_cli_scale_route_warns_for_another_algo(capsys, monkeypatch):
    """Flag honesty: -a m-pass at a scale-tier size runs the standard
    m-pass path and says so."""
    monkeypatch.setenv("SMJ_SHARDED_GEN_MIN", "100000")
    argv = [a if a != "m-way" else "m-pass" for a in SCALE_ARGV]
    assert tcli.main(argv) == 0
    cap = capsys.readouterr()
    assert "[WARN ] scale tier (>= 100000 tuples) supports -a m-way" \
        in cap.err
    assert "scale tier: sharded" not in cap.err
    assert "Results = 400000" in cap.out


def test_cli_below_the_scale_minimum_takes_the_standard_path(capsys):
    assert tcli.main(SCALE_ARGV[:5] + ["20000", "-s", "20000", "--device",
                                       "cpu"]) == 0
    cap = capsys.readouterr()
    assert "scale tier" not in cap.err and "Results = 20000" in cap.out


@pytest.mark.parametrize("algo", ["m-way", "m-pass", "mpsm"])
def test_scalebench(algo, capsys):
    """Rows for 1, 2 and a 2 x 4 mesh, each count checked against numpy;
    mpsm skips the 2-D mesh with the JAX message."""
    assert scalebench.main(["20000", "--devices", "1,2,2x4", "--reps", "1",
                            "--algo", algo, "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    rows = [ln.split() for ln in cap.out.splitlines() if ln.strip()]
    want = ["1", "2"] if algo == "mpsm" else ["1", "2", "2x4"]
    assert [r[1] for r in rows] == want
    assert all(r[0] == algo and r[2] == "20000" and len(r) == 6
               for r in rows)
    assert rows[0][5] == "1.000"
    assert ("mpsm skipped on 2-D mesh 2x4" in cap.err) == (algo == "mpsm")
    assert "one device" in cap.err and "on cpu" in cap.err


def test_roofline_report_and_record_line_equal_jax():
    """The same row strings as the JAX package; the port's [RECORD] row
    has one more column, the device."""
    phases = {"sort": 0.0123, "merge1": 0.004, "mergerest": 0.0,
              "mergejoin": 0.00085, "total": 0.01715}
    nbytes = {"sort": 2_048_000_000, "merge1": 2_048_000_000,
              "mergerest": 6_144_000_000, "mergejoin": 1_024_000_000}
    for gbps in (567.0, 2934.4):
        got = tprof.BytesMoved(dict(nbytes)).roofline_report(phases, gbps)
        assert got == jprof.BytesMoved(dict(nbytes)).roofline_report(
            phases, gbps)
        assert got.count("[ROOFLINE]") == 3  # mergerest took no time
    bm_t, bm_j = tprof.BytesMoved(), jprof.BytesMoved()
    for bm in (bm_t, bm_j):
        bm.add("sort", 10)
        bm.add("sort", 5)
    assert bm_t.phases == bm_j.phases == {"sort": 15}
    assert tprof.BytesMoved.sort_bytes(1000, 3, True) == \
        jprof.BytesMoved.sort_bytes(1000, 3, True)
    for ph in (phases, {"sort": 0.5}):
        want = jprof.record_line("m-way", 8, 1600, 1600, 0, ph)
        got = tprof.record_line("m-way", 8, 1600, 1600, 0, ph,
                                "NVIDIA H100 80GB HBM3")
        assert got == want + " NVIDIA_H100_80GB_HBM3"


def test_hbm_gbps_takes_the_env_or_measures_this_device(monkeypatch):
    monkeypatch.setenv("SMJ_HBM_GBPS", "1234.5")
    assert tprof.hbm_gbps(CPU) == (1234.5, "SMJ_HBM_GBPS")
    monkeypatch.delenv("SMJ_HBM_GBPS")
    gbps, origin = tprof.hbm_gbps(CPU)
    assert gbps > 0 and origin == "copy rate measured on cpu"
    assert tprof.hbm_gbps(CPU)[0] == gbps  # measured once a process
