"""The distributed materializing join of the port
(``parallel/dist_materialize.py``) and its CLI route (``-n N --materialize
[--persist DIR]``) on meshes of shards on the CPU, against the JAX
package's on its 8-device CPU mesh (its default route there,
``use_pallas=False``) and the numpy oracle: the same seeded numpy columns
go to both; the counts and overflows must be equal and the output rows
equal as a multiset (both sides lexsorted; integers, tolerance 0).  Each
case checks the port's kernel route (the kernels' plain versions on the
CPU) and its ``torch.sort`` baseline route.  The JAX cases share shapes,
so that its shard programs compile once a mesh."""

import os

import numpy as np
import pytest
import torch

from avx_sort_merge_joins_tpu import cli as jcli
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_materialize as jdm
from avx_sort_merge_joins_tpu.parallel import mesh as jmesh
from avx_sort_merge_joins_tpu_torch import cli as tcli
from avx_sort_merge_joins_tpu_torch import datagen as tdata
from avx_sort_merge_joins_tpu_torch.parallel import dist_materialize as tdm
from avx_sort_merge_joins_tpu_torch.parallel import mesh as tmesh
from test_torch_dist_mway import NR, NS, _workload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU route is many small tensor ops a shard; one thread
    each keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(keys, pays):
    """The rows as a multiset: lexsorted by (key, payload)."""
    keys, pays = np.asarray(keys), np.asarray(pays)
    order = np.lexsort((pays, keys))
    return keys[order], pays[order]


def _both_routes(rk, sk, sp, nR, nS, mesh, **kw):
    """``(rows, count, overflow)`` of the kernel route, which the baseline
    route must equal; the columns lie on the mesh's device."""
    out = []
    for use_kernels in (True, False):
        k, p, count, ov = tdm.dist_join_materialize(
            rk, None, sk, sp, nR, nS, mesh, use_kernels=use_kernels, **kw)
        assert k.device == p.device == mesh.device and k.numel() == count
        out.append((_rows(k.numpy(), p.numpy()), count, ov))
    assert all(np.array_equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert out[0][1:] == out[1][1:]
    return out[0]


def _equal_rows(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _oracle_rows(rk, sk, sp):
    """numpy's rows: each S row once per R key equal to its key."""
    r = np.sort(rk)
    mult = np.searchsorted(r, sk, "right") - np.searchsorted(r, sk, "left")
    return _rows(np.repeat(sk, mult), np.repeat(sp, mult))


@pytest.mark.parametrize("kind", ["uniform", "ragged_nonunique", "zipf",
                                  "domain_ends"])
def test_dist_materialize_equals_jax(kind):
    """Both routes give JAX's rows, count and overflow; "ragged_nonunique"
    repeats R keys (expanded rows), "domain_ends" holds keys at -(2^31 -
    2) and up to 2^31 - 2."""
    rk, sk = _workload(kind)
    sp = np.random.default_rng(1).integers(-2**31, 2**31 - 1, NS,
                                           dtype=np.int64).astype(np.int32)
    wk, wp, wcount, wov = jdm.dist_join_materialize(rk, None, sk, sp, NR, NS)
    rows, count, ov = _both_routes(rk, sk, sp, NR, NS,
                                   tmesh.make_mesh(8, "cpu"))
    assert (count, ov) == (wcount, wov) == (merge_join_count_numpy(rk, sk), 0)
    assert _equal_rows(rows, _rows(wk, wp))
    assert _equal_rows(rows, _oracle_rows(rk, sk, sp))


def test_dist_materialize_2d_mesh_equals_jax():
    """A 2 x 4 (host, chip) mesh: the two-stage exchange of every column."""
    rk, sk = _workload("zipf", seed=2)
    sp = np.arange(NS, dtype=np.int32)
    wk, wp, wcount, wov = jdm.dist_join_materialize(
        rk, None, sk, sp, NR, NS, jmesh.make_mesh2d(2, 4))
    rows, count, ov = _both_routes(rk, sk, sp, NR, NS,
                                   tmesh.make_mesh2d(2, 4, "cpu"))
    assert (count, ov) == (wcount, wov) == (merge_join_count_numpy(rk, sk), 0)
    assert _equal_rows(rows, _rows(wk, wp))


def test_dist_materialize_streams_to_a_file(tmp_path):
    """stream_to: the file holds the returned rows (a multiset), written
    over what was there; the Zipf workload takes no slack retry."""
    rk, sk = _workload("zipf")
    sp = np.arange(NS, dtype=np.int32)
    mesh = tmesh.make_mesh(8, "cpu")
    k, p, count, ov = tdm.dist_join_materialize(rk, None, sk, sp, NR, NS,
                                                mesh)
    path = str(tmp_path / "Out.tbl")
    with open(path, "w") as f:
        f.write("1 2\n")
    got = tdm.dist_join_materialize(rk, None, sk, sp, NR, NS, mesh,
                                    stream_to=path)
    assert got == (None, None, count, ov) and tdm.LAST_RETRIES == 0
    back = tdata.read_relation(path, device="cpu")
    assert back.num_tuples == count == NS
    assert _equal_rows(_rows(*back.to_numpy()), _rows(k.numpy(), p.numpy()))


def test_dist_materialize_overflow_retry():
    """20,000 copies of one key on one source shard of 4 overflow its
    bucket at slack 2 (cap 16,384): the slack doubles once and the rows
    are exact."""
    n = 4 * 20_000
    rng = np.random.default_rng(11)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    sk[:20_000] = 5
    sp = np.arange(n, dtype=np.int32)
    rows, count, ov = _both_routes(rk, sk, sp, n, n,
                                   tmesh.make_mesh(4, "cpu"))
    assert (count, ov) == (n, 0) and tdm.LAST_RETRIES == 1
    assert _equal_rows(rows, _oracle_rows(rk, sk, sp))


@pytest.mark.parametrize("kind", ["empty S", "hot key"])
def test_dist_materialize_edges(kind):
    """An empty S gives no rows.  A hot key on one shard: R holds 24,000
    copies of it and S 1,000, so each S row repeats 24,000 times (the
    counts' hot key, 24,000^2 >= 2^29 matches, would be 576,000,000 rows
    here)."""
    if kind == "empty S":
        rk, sk = _workload("uniform", 1000, 0)
    else:
        rk, sk = np.full(24_000, 9, np.int32), np.full(1000, 9, np.int32)
    sp = np.arange(sk.size, dtype=np.int32)
    rows, count, ov = _both_routes(rk, sk, sp, rk.size, sk.size,
                                   tmesh.make_mesh(8, "cpu"))
    assert (count, ov) == (merge_join_count_numpy(rk, sk), 0)
    assert _equal_rows(rows, _oracle_rows(rk, sk, sp))


def test_dist_materialize_refuses_a_bad_fanin():
    rk, sk = _workload("uniform", 100, 100)
    for fanin in (6, 1):
        with pytest.raises(ValueError, match="power of two"):
            tdm.dist_join_materialize(rk, None, sk, sk, 100, 100,
                                      tmesh.make_mesh(8, "cpu"), fanin=fanin)


def test_cli_dist_materialize_persist_equals_the_jax_cli(tmp_path, capsys):
    """-n 8 --materialize --persist DIR prints the JAX CLI's Results and
    writes its R.tbl and S.tbl byte for byte and its streamed Out.tbl as a
    multiset of rows."""
    argv = ["-n", "8", "--materialize", "-r", str(NR), "-s", str(NS), "-x",
            "5", "-y", "6", "--non-unique"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main([*argv, "--persist", str(jdir)]) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert tcli.main([*argv, "--persist", str(tdir), "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.split("Results = ")[1].split()[0] == want
    assert f"streamed {want} output tuples" in err
    for name in ("R.tbl", "S.tbl"):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    rows = [_rows(*np.loadtxt(os.path.join(d, "Out.tbl"), dtype=np.int64,
                              ndmin=2).T) for d in (jdir, tdir)]
    assert len(rows[0][0]) == int(want) and _equal_rows(*rows)
